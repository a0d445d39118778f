"""The port's block-Jacobi svd and eigh (gemmul8_tpu_torch.eig) against
gemmul8_tpu.eig on the CPU under x64.

- With the native seam swapped (tests/torch_native_seam.py): eigh with
  max_sweeps=2, tol=0.0 is bit-equal to JAX's (its eigenvalues are a
  diagonal, not a sum); svd with max_sweeps=2 gives vt bit for bit and s, u
  within 4 ulps, since they come from the column-norm sum (gemmul8_tpu/
  eig.py:223), whose order XLA and torch do not share. Both svd shapes: the
  wide one runs on A^H.
- Unswapped and converged, eigenvalues and singular values are within
  1e-12 of JAX's relative to ||A||, and the vectors meet
  tests/test_eig.py's reconstruction and orthogonality contracts.
- Port-only: the round-robin schedule, the block choice, the complex
  tolerances, complex eigh and svd contracts, the mesh refusal with JAX's
  text, the bad inputs, and that no input is modified. (With a mesh the
  calls are held against JAX's in tests/test_torch_solvers_mesh.py.)
- The JAX package's svd stagnation rule (eig.py:220), a fault the port
  does not carry: JAX's singular values against the port's on an input
  where it stops early.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
import torch_native_seam as seam

eigj = importlib.import_module("gemmul8_tpu.eig")
eigt = importlib.import_module("gemmul8_tpu_torch.eig")


def _inputs():
    rng = np.random.default_rng(20261019)
    m = rng.standard_normal((48, 48))
    return dict(sym=(m + m.T) / 2, a=rng.standard_normal((48, 32)))


X = _inputs()
X["wide"] = np.ascontiguousarray(X["a"].T)


def _call(mod, dev, name, key, **kw):
    if mod is g8:
        return getattr(g8, name)(jnp.asarray(X[key]), **kw)
    return getattr(gt, name)(X[key], device=dev, **kw)


CASES = {
    "eigh[2 sweeps]": lambda mod, dev: _call(mod, dev, "eigh", "sym",
                                             max_sweeps=2, tol=0.0),
    "eigh": lambda mod, dev: _call(mod, dev, "eigh", "sym"),
    "svd[2 sweeps]": lambda mod, dev: _call(mod, dev, "svd", "a",
                                            max_sweeps=2),
    "svd[wide, 2 sweeps]": lambda mod, dev: _call(mod, dev, "svd", "wide",
                                                  max_sweeps=2),
    "svd": lambda mod, dev: _call(mod, dev, "svd", "a"),
}


@pytest.fixture(scope="module")
def jax_results():
    cache = {}

    def get(name):
        if name not in cache:
            with seam.swapped():
                cache[name] = tuple(np.asarray(r)
                                    for r in CASES[name](g8, None))
        return cache[name]
    return get


def _within_ulps(got, ref, ulps):
    got = seam._np(got)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= ulps * np.spacing(np.abs(ref)))


def test_eigh_bit_equal_with_native_seam(jax_results):
    ref = jax_results("eigh[2 sweeps]")
    with seam.swapped():
        got = CASES["eigh[2 sweeps]"](gt, "cpu")
    for g, r in zip(got, ref):
        seam.bits_equal(g, r)


@pytest.mark.parametrize("name", ["svd[2 sweeps]", "svd[wide, 2 sweeps]"])
def test_svd_with_native_seam(name, jax_results):
    """vt bit for bit; s and u within 4 ulps (the column-norm sum). On the
    wide shape the roles swap: u comes from V and vt from W."""
    u_r, s_r, vt_r = jax_results(name)
    with seam.swapped():
        u, s, vt = CASES[name](gt, "cpu")
    exact, summed = (vt, vt_r), (u, u_r)
    if "wide" in name:
        exact, summed = (u, u_r), (vt, vt_r)
    seam.bits_equal(*exact)
    _within_ulps(s, s_r, 4)
    _within_ulps(*summed, 4)


def test_eigh_native_path_within_1e12_of_jax(jax_results):
    w_r, _ = jax_results("eigh")
    sym = X["sym"]
    w, v = (x.numpy() for x in gt.eigh(sym, device="cpu"))
    scale = np.max(np.abs(w_r))
    assert np.all(np.diff(w) >= 0)
    assert np.max(np.abs(w - w_r)) / scale < 1e-12
    # tests/test_eig.py:75-86
    wref = np.linalg.eigvalsh(sym)
    assert np.max(np.abs(w - wref)) / scale < 1e-12
    assert np.max(np.abs(sym @ v - v * w[None, :])) / scale < 1e-12
    assert np.max(np.abs(v.T @ v - np.eye(48))) < 1e-12


def test_svd_native_path_within_1e12_of_jax(jax_results):
    _, s_r, _ = jax_results("svd")
    a = X["a"]
    u, s, vt = (x.numpy() for x in gt.svd(a, device="cpu"))
    assert np.all(np.diff(s) <= 0)
    assert np.max(np.abs(s - s_r)) / np.max(s_r) < 1e-12
    # tests/test_eig.py:23-43
    assert np.max(np.abs(s - np.linalg.svd(a, compute_uv=False))
                  / s) < 1e-12
    assert np.max(np.abs(u @ np.diag(s) @ vt - a)) / np.max(np.abs(a)) < 1e-11
    assert np.max(np.abs(u.T @ u - np.eye(32))) < 1e-11
    assert np.max(np.abs(vt @ vt.T - np.eye(32))) < 1e-11
    s_only = gt.svd(a, compute_uv=False, device="cpu").numpy()
    assert np.max(np.abs(s_only - s) / s) < 1e-12


def test_svd_wide_shape_contract():
    a = X["wide"]
    u, s, vt = (x.numpy() for x in gt.svd(a, device="cpu"))
    assert u.shape == (32, 32) and s.shape == (32,) and vt.shape == (32, 48)
    assert np.max(np.abs(u @ np.diag(s) @ vt - a)) / np.max(np.abs(a)) < 1e-11


def test_complex_eigh_and_svd_contracts():
    """tests/test_eig.py:134-166 (zheev, zgesvd) at a small size."""
    rng = np.random.default_rng(1003)
    m = rng.standard_normal((32, 32)) + 1j * rng.standard_normal((32, 32))
    herm = (m + m.conj().T) / 2
    w, v = (x.numpy() for x in gt.eigh(herm, device="cpu"))
    assert w.dtype == np.float64
    wref = np.linalg.eigvalsh(herm)
    scale = np.max(np.abs(wref))
    assert np.max(np.abs(w - wref)) / scale < 1e-13
    assert np.max(np.abs(herm @ v - v * w[None, :])) / scale < 1e-12
    assert np.max(np.abs(v.conj().T @ v - np.eye(32))) < 1e-11
    u, s, vt = (x.numpy() for x in gt.svd(m[:, :16], device="cpu"))
    assert s.dtype == np.float64
    assert np.max(np.abs(u @ np.diag(s) @ vt - m[:, :16])) / np.max(
        np.abs(m)) < 1e-11
    assert np.max(np.abs(u.conj().T @ u - np.eye(16))) < 1e-11


@pytest.mark.parametrize("nb", [2, 3, 4, 5, 8])
def test_round_robin_covers_all_pairs(nb):
    """tests/test_eig.py:185-195, and the same schedule as JAX's."""
    rounds = eigt._round_robin(nb)
    assert rounds == eigj._round_robin(nb)
    seen = set()
    for pairs in rounds:
        ids = [i for p in pairs for i in p]
        assert len(ids) == len(set(ids))
        seen |= set(pairs)
    assert seen == {(i, j) for i in range(nb) for j in range(i + 1, nb)}


def test_pick_block_and_default_nu_match_jax():
    for n in (1, 2, 7, 16, 30, 48, 100, 512, 4096):
        assert eigt._pick_block(n, None) == eigj._pick_block(n, None)
    for t, n in ((torch.float64, np.float64), (torch.float32, np.float32),
                 (torch.complex128, np.complex128),
                 (torch.complex64, np.complex64)):
        assert eigt._default_nu(t) == eigj._default_nu(n)


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_complex_tolerances_use_the_real_component(dtype):
    """torch.finfo of a complex dtype gives its real component's eps and
    tiny, as jnp.finfo does (eig.py:150-152, :187)."""
    t = torch.zeros(2, dtype=getattr(torch, dtype))
    j = jnp.zeros(2, dtype=dtype)
    assert eigt._tolerances(t, None) == eigj._tolerances(j, None)
    assert torch.finfo(t.dtype).tiny == float(jnp.finfo(j.dtype).tiny)


class _Grid:
    """A stand-in for a 2x2 DeviceMesh: the pair-split refusal reads only
    its rank grid, and a world of one cannot hold a real 2x2."""
    mesh = torch.empty(2, 2)


@pytest.mark.parametrize("name", eigt.__all__)
def test_mesh_refused_naming_queue_13(name):
    """The mesh refusal the JAX package makes (eig.py:124-147), with its
    text: 48 / 8 = 6 blocks give 3 pairs a round, which 4 ranks do not
    divide. (The test keeps the name it had when every mesh was refused.)"""
    import jax
    from jax.sharding import Mesh
    jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    with pytest.raises(ValueError) as ref:
        getattr(g8, name)(jnp.asarray(X["sym"]), mesh=jmesh)
    with pytest.raises(ValueError) as got:
        getattr(gt, name)(X["sym"], mesh=_Grid(), device="cpu")
    assert str(got.value) == str(ref.value)
    assert "pairs-per-round (3)" in str(got.value)


@pytest.mark.parametrize("name", eigt.__all__)
def test_inputs_not_modified(name):
    t = torch.from_numpy(X["sym"].copy())
    kept = t.clone()
    getattr(gt, name)(t, max_sweeps=1, device="cpu")
    assert torch.equal(t, kept)


def test_bad_inputs_refused():
    """tests/test_eig.py:100-104, and a block with no rotation pairs."""
    with pytest.raises(ValueError):
        gt.eigh(np.ones((4, 6)), device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        gt.svd(np.ones((32, 30)), block=7, device="cpu")
    with pytest.raises(ValueError, match="no rotation"):
        gt.eigh(np.eye(8), block=8, device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        gt.svd(np.ones(4), device="cpu")


def test_eig_220_svd_stagnation_on_a_rising_max_coupling():
    """A fault of the JAX package the port does not carry: svd stops when
    the largest normalized coupling of a sweep fails to fall after sweep 4
    (gemmul8_tpu/eig.py:220), but with many block pairs that measure rises
    for several sweeps before the quadratic phase, so JAX returns singular
    values wrong by about 1.6e-3 here, at 12 blocks of 3 (2e-2 at 4096^2,
    block 128, on the card). The port judges stagnation on the sweep's
    Frobenius measure, which falls sweep by sweep, and converges."""
    a = np.random.default_rng(7).standard_normal((36, 36))
    sref = np.linalg.svd(a, compute_uv=False)
    s_jax = np.asarray(g8.svd(jnp.asarray(a), block=3, compute_uv=False))
    assert np.max(np.abs(s_jax - sref)) / sref[0] > 1e-4
    s = gt.svd(a, block=3, compute_uv=False, device="cpu").numpy()
    assert np.max(np.abs(s - sref)) / sref[0] < 1e-12
