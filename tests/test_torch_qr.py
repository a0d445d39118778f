"""The port's blocked Householder QR (gemmul8_tpu_torch.qr) against
gemmul8_tpu.qr on the CPU under x64.

- With the native seam swapped (tests/torch_native_seam.py), geqrf, ormqr
  (both ops), qr, lstsq (vector and matrix right-hand sides) and a complex
  qr are bit-equal to JAX's (tolerance 0).
- Unswapped, the port's own LAPACK gives results within a relative 1e-12 of
  JAX's at nu=14 that meet tests/test_qr.py's contracts (reconstruction and
  orthogonality < 1e-13, lstsq within 1e-11 of numpy's).
- Port-only: the exact tau = 0 limit (tests/test_qr.py:171-194), the
  complex reciprocal against XLA's bits, the FP8 Gram routes, the mesh
  refusal with JAX's text, the bad shapes and ts, and that no input is
  modified. (With a mesh the calls are held against JAX's in
  tests/test_torch_solvers_mesh.py.)
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu_torch as gt
import torch_native_seam as seam

# the packages export the qr() function under the submodule's name
qrj = importlib.import_module("gemmul8_tpu.qr")
qrt = importlib.import_module("gemmul8_tpu_torch.qr")

KW = dict(num_moduli=14, block=32)
ZKW = dict(num_moduli=14, block=16)


def _inputs():
    rng = np.random.default_rng(20261018)
    # C as wide as qr's identity, so that ormqr, qr and lstsq share shapes
    # (each new shape costs JAX a compile)
    return dict(
        a=rng.standard_normal((96, 64)), c=rng.standard_normal((96, 64)),
        vec=rng.standard_normal(96),
        za=(rng.standard_normal((32, 16))
            + 1j * rng.standard_normal((32, 16))))


X = _inputs()


def _geqrf(mod, dev):
    if mod is qrj:
        return qrj.geqrf(jnp.asarray(X["a"]), **KW)
    return qrt.geqrf(X["a"], device=dev, **KW)


def _ormqr(mod, dev, trans):
    packed, taus = _geqrf(mod, dev)
    if mod is qrj:
        return qrj.ormqr(packed, taus, jnp.asarray(X["c"]), trans=trans,
                         **KW)
    return qrt.ormqr(packed, taus, X["c"], trans=trans, device=dev, **KW)


def _call(mod, dev, name, *keys, **kw):
    if mod is qrj:
        return getattr(qrj, name)(*[jnp.asarray(X[k]) for k in keys], **kw)
    return getattr(qrt, name)(*[X[k] for k in keys], device=dev, **kw)


CASES = {
    "geqrf": _geqrf,
    "ormqr[Q]": lambda mod, dev: _ormqr(mod, dev, False),
    "ormqr[Q^T]": lambda mod, dev: _ormqr(mod, dev, True),
    "qr": lambda mod, dev: _call(mod, dev, "qr", "a", **KW),
    "lstsq[vector]": lambda mod, dev: _call(mod, dev, "lstsq", "a", "vec",
                                            **KW),
    "lstsq[matrix]": lambda mod, dev: _call(mod, dev, "lstsq", "a", "c",
                                            **KW),
    "zqr": lambda mod, dev: _call(mod, dev, "qr", "za", **ZKW),
}


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.fixture(scope="module")
def jax_results():
    cache = {}

    def get(name):
        if name not in cache:
            with seam.swapped():
                cache[name] = tuple(np.asarray(r) for r in _tuple(
                    CASES[name](qrj, None)))
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(CASES))
def test_bit_equal_with_native_seam(name, jax_results):
    ref = jax_results(name)
    with seam.swapped():
        got = _tuple(CASES[name](qrt, "cpu"))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        seam.bits_equal(g, r)


@pytest.mark.parametrize("name", list(CASES))
def test_native_path_within_1e12_of_jax(name, jax_results):
    ref = jax_results(name)
    got = _tuple(CASES[name](qrt, "cpu"))
    for g, r in zip(got, ref):
        g = seam._np(g)
        assert np.max(np.abs(g - r)) / np.max(np.abs(r)) < 1e-12, name


@pytest.mark.parametrize("key,kw", [("a", KW), ("za", ZKW)])
def test_qr_contract(key, kw):
    a = X[key]
    q, r = (x.numpy() for x in gt.qr(a, device="cpu", **kw))
    k = min(a.shape)
    assert q.shape == (a.shape[0], k) and r.shape == (k, a.shape[1])
    assert np.array_equal(r, np.triu(r))
    assert np.max(np.abs(q @ r - a)) / np.max(np.abs(a)) < 1e-13
    assert np.max(np.abs(q.conj().T @ q - np.eye(k))) < 1e-13


def test_ormqr_and_lstsq_contracts():
    """Q^T (Q C) == C (tests/test_qr.py:72-84) and lstsq against numpy
    (:87-97)."""
    packed, taus = gt.geqrf(X["a"], device="cpu", **KW)
    qc = gt.ormqr(packed, taus, X["c"], device="cpu", **KW)
    back = gt.ormqr(packed, taus, qc, trans=True, device="cpu", **KW)
    assert np.max(np.abs(back.numpy() - X["c"])) / np.max(
        np.abs(X["c"])) < 1e-13
    for rhs in ("vec", "c"):
        x = gt.lstsq(X["a"], X[rhs], device="cpu", **KW).numpy()
        ref = np.linalg.lstsq(X["a"], X[rhs], rcond=None)[0]
        assert x.shape == ref.shape
        assert np.max(np.abs(x - ref)) / np.max(np.abs(ref)) < 1e-11


def test_square_qr_tau_zero_exact_limit():
    """tests/test_qr.py:171-194: an upper-triangular input drives tau == 0
    for every reflector, so Q is exactly I and R exactly A; a generic square
    matrix's last tau is 0 and everything stays finite."""
    rng = np.random.default_rng(46)
    n = 64
    a = np.triu(rng.standard_normal((n, n))) + n * np.eye(n)
    q, r = gt.qr(a, device="cpu", **KW)
    assert np.array_equal(q.numpy(), np.eye(n))
    assert np.array_equal(r.numpy(), a)
    a2 = rng.standard_normal((n, n))
    q2, r2 = (x.numpy() for x in gt.qr(a2, device="cpu", **KW))
    assert np.all(np.isfinite(q2))
    assert np.max(np.abs(q2 @ r2 - a2)) / np.max(np.abs(a2)) < 1e-13


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_block_t_zero_tau_rows_and_columns_exact(dtype):
    """T's row and column j are exactly 0 where tau_j == 0, with no inf or
    NaN anywhere (the closed form's exact limit)."""
    rng = np.random.default_rng(7)
    panel = torch.from_numpy(rng.standard_normal((40, 8))).to(dtype)
    packed, tau = torch.geqrf(panel)
    tau = tau.clone()
    tau[[2, 7]] = 0
    v = qrt._panel_vt(packed, 8)
    t = qrt._block_t(v, tau, num_moduli=14, fastmode="robust",
                     backend="INT8")
    assert torch.isfinite(torch.view_as_real(t) if t.is_complex()
                          else t).all()
    for j in (2, 7):
        assert not t[j].any() and not t[:, j].any()
    assert t[0, 0] != 0


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64, np.float64])
def test_reciprocal_matches_xla_bits(dtype):
    """_block_t's 1/tau: on complex tau, XLA:CPU's Smith division (FMA
    denominator), which torch's own complex division does not give."""
    rng = np.random.default_rng(11)
    z = rng.standard_normal(4000) * np.exp(3 * rng.standard_normal(4000))
    if np.dtype(dtype).kind == "c":
        z = z + 1j * rng.standard_normal(4000) * np.exp(
            3 * rng.standard_normal(4000))
    z = z.astype(dtype)
    seam.bits_equal(qrt._reciprocal(torch.from_numpy(z)),
                    1.0 / jnp.asarray(z))


@pytest.mark.parametrize("key", ["a", "za"])
def test_fp8_gram_routes_reconstruct(key):
    """backend="FP8": syrk's FP8 route for real panels and the generic gemm
    for complex ones (no FP8 herk), reconstruction < 1e-13."""
    a = X[key]
    kw = KW if key == "a" else ZKW
    q, r = (x.numpy() for x in gt.qr(a, backend="FP8", device="cpu", **kw))
    assert np.max(np.abs(q @ r - a)) / np.max(np.abs(a)) < 1e-13


def _calls(t):
    packed, taus = gt.geqrf(t["a"], device="cpu", **KW)
    return {
        "geqrf": (lambda **k: gt.geqrf(t["a"], **k), ("a",)),
        "ormqr": (lambda **k: gt.ormqr(packed, taus, t["c"], **k), ("c",)),
        "qr": (lambda **k: gt.qr(t["za"], **k), ("za",)),
        "lstsq": (lambda **k: gt.lstsq(t["a"], t["vec"], **k),
                  ("a", "vec")),
    }, (packed, taus)


class _Grid:
    """A stand-in for a 2x2 DeviceMesh: the mesh refusals read only the
    shape of its rank grid, and a world of one cannot hold a real 2x2."""
    mesh = torch.empty(2, 2)


@pytest.mark.parametrize("name", qrt.__all__)
def test_mesh_refused_naming_queue_13(name):
    """The mesh refusal the JAX package makes (_check_mesh_blocking), with
    its text: block 24 does not divide A's 64 columns (ormqr: min(m, n)).
    (The test keeps the name it had when every mesh was refused.)"""
    import jax
    from jax.sharding import Mesh
    jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    packed, taus = qrj.geqrf(jnp.asarray(X["a"]), **ZKW)
    jax_calls = {
        "geqrf": lambda **k: qrj.geqrf(jnp.asarray(X["a"]), **k),
        "ormqr": lambda **k: qrj.ormqr(packed, taus, jnp.asarray(X["c"]),
                                       **k),
        "qr": lambda **k: qrj.qr(jnp.asarray(X["a"]), **k),
        "lstsq": lambda **k: qrj.lstsq(jnp.asarray(X["a"]),
                                       jnp.asarray(X["vec"]), **k),
    }
    calls, _ = _calls({k: torch.from_numpy(v) for k, v in X.items()})
    kw = dict(num_moduli=14, block=24)
    with pytest.raises(ValueError) as ref:
        jax_calls[name](mesh=jmesh, **kw)
    port = calls[name][0] if name != "qr" else (
        lambda **k: gt.qr(X["a"], **k))
    with pytest.raises(ValueError) as got:
        port(mesh=_Grid(), device="cpu", **kw)
    assert str(got.value) == str(ref.value)
    assert "with mesh 2x2 needs block divisible" in str(got.value)


@pytest.mark.parametrize("name", qrt.__all__)
def test_inputs_not_modified(name):
    t = {k: torch.from_numpy(v.copy()) for k, v in X.items()}
    calls, (packed, taus) = _calls(t)
    kept = {k: v.clone() for k, v in t.items()}
    kept_packed, kept_taus = packed.clone(), taus.clone()
    fn, keys = calls[name]
    fn(device="cpu", **ZKW)
    for k in keys:
        assert torch.equal(t[k], kept[k]), k
    assert torch.equal(packed, kept_packed) and torch.equal(taus, kept_taus)


def test_bad_shapes_refused():
    """tests/test_qr.py:116-128, and ormqr's ts that do not fit."""
    with pytest.raises(ValueError):
        gt.geqrf(torch.ones(4, dtype=torch.float64), device="cpu")
    with pytest.raises(ValueError):                  # lstsq needs m >= n
        gt.lstsq(np.ones((3, 5)), np.ones(3), device="cpu")
    with pytest.raises(ValueError, match="B rows"):
        gt.lstsq(np.ones((5, 3)), np.ones(4), device="cpu")
    packed, taus = gt.geqrf(np.ones((8, 4)) + np.eye(8, 4), device="cpu")
    with pytest.raises(ValueError, match="C rows"):
        gt.ormqr(packed, taus, np.ones((9, 2)), device="cpu")
    with pytest.raises(ValueError, match="same block"):
        gt.ormqr(packed, taus, np.ones((8, 2)), ts=[None, None],
                 device="cpu")
    packed_c, taus_c = gt.geqrf(np.eye(4, dtype=np.complex64) * 2,
                                device="cpu")
    assert packed_c.dtype == torch.complex64 and taus_c.shape == (4,)
