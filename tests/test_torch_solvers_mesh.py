"""The port's solvers, qr and eig with a mesh against the JAX package's with
one, on the CPU under x64.

The port runs on a gloo world of one (a 1x1 DeviceMesh), JAX on a 2x2 mesh
of conftest's virtual CPU devices: with a mesh the updates go through SUMMA,
whose bits are the same on every mesh shape and are not mesh=None's (the
JAX package says so at gemmul8_tpu/solvers.py:107-113), so the reference
is JAX with a mesh.

- With the native seam swapped (tests/torch_native_seam.py) every call --
  trsm, trmm, getrf, lu_solve, solve, inv, trtri, potrf (both triangles),
  potrs, posv, geqrf, ormqr, qr, lstsq, eigh and svd (two sweeps) -- is
  bit-equal to JAX's.
- Unswapped, within a relative 1e-12 of JAX's (permutations equal).
- eigh with a mesh gives mesh=None's bits (its pairs are split over the
  ranks, each product computed whole).

Every JAX result is computed once (n = 64, block 32, nu = 14; RHS 4 wide,
divisible by the 2x2 mesh's y).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
import torch_native_seam as seam
from gemmul8_tpu_torch.parallel import summa

NS, BLK, NU = 64, 32, 14
KW = dict(num_moduli=NU, block=BLK)
EKW = dict(block=8, max_sweeps=2, tol=0.0)


@pytest.fixture(scope="module")
def mesh():
    m = summa.make_mesh(device_type="cpu")
    try:
        yield m
    finally:
        dist.destroy_process_group()


def _inputs():
    rng = np.random.default_rng(20261023)
    n = NS
    g = rng.standard_normal((n, n))
    tl = np.tril(rng.standard_normal((n, n)) / np.sqrt(n))
    tl[np.arange(n), np.arange(n)] = 1.0 + rng.random(n)
    return dict(a=rng.standard_normal((n, n)) + n * np.eye(n),
                spd=g @ g.T / n + 2 * np.eye(n), tl=tl,
                tu=np.ascontiguousarray(tl.T), rhs=rng.standard_normal((n, 4)),
                tall=rng.standard_normal((2 * n, n)),
                c=rng.standard_normal((2 * n, 4)), sym=(g + g.T) / 2)


X = _inputs()


def _call(mod, dev, mesh, name, *keys, **kw):
    if mod is g8:
        return getattr(g8, name)(*[jnp.asarray(X[k]) for k in keys],
                                 mesh=mesh, **kw)
    return getattr(gt, name)(*[X[k] for k in keys], mesh=mesh, device=dev,
                             **kw)


def _cases():
    c = {}
    c["trsm[left lower]"] = lambda mod, dev, m: _call(
        mod, dev, m, "trsm", "tl", "rhs", alpha=-2.5, **KW)
    c["trsm[upper C unit]"] = lambda mod, dev, m: _call(
        mod, dev, m, "trsm", "tu", "rhs", side="left", lower=False,
        trans_a="C", unit_diag=True, **KW)
    c["trmm"] = lambda mod, dev, m: _call(mod, dev, m, "trmm", "tl", "rhs",
                                          alpha=0.5, **KW)
    c["getrf"] = lambda mod, dev, m: _call(mod, dev, m, "getrf", "a", **KW)

    def lu_solve(mod, dev, m):
        lu, perm = _call(mod, dev, m, "getrf", "a", **KW)
        if mod is g8:
            return g8.lu_solve(lu, perm, jnp.asarray(X["rhs"]), mesh=m, **KW)
        return gt.lu_solve(lu, perm, X["rhs"], mesh=m, device=dev, **KW)
    c["lu_solve"] = lu_solve
    c["solve"] = lambda mod, dev, m: _call(mod, dev, m, "solve", "a", "rhs",
                                           **KW)
    c["inv"] = lambda mod, dev, m: _call(mod, dev, m, "inv", "a", **KW)
    c["trtri"] = lambda mod, dev, m: _call(mod, dev, m, "trtri", "tl", **KW)
    for lower in (True, False):
        c[f"potrf[lower={lower}]"] = lambda mod, dev, m, lower=lower: _call(
            mod, dev, m, "potrf", "spd", lower=lower, **KW)

    def potrs(mod, dev, m):
        chol = _call(mod, dev, m, "potrf", "spd", **KW)
        if mod is g8:
            return g8.potrs(chol, jnp.asarray(X["rhs"]), mesh=m, **KW)
        return gt.potrs(chol, X["rhs"], mesh=m, device=dev, **KW)
    c["potrs"] = potrs
    c["posv"] = lambda mod, dev, m: _call(mod, dev, m, "posv", "spd", "rhs",
                                          **KW)
    c["geqrf"] = lambda mod, dev, m: _call(mod, dev, m, "geqrf", "tall", **KW)

    def ormqr(mod, dev, m):
        packed, taus = _call(mod, dev, m, "geqrf", "tall", **KW)
        if mod is g8:
            return g8.ormqr(packed, taus, jnp.asarray(X["c"]), trans=True,
                            mesh=m, **KW)
        return gt.ormqr(packed, taus, X["c"], trans=True, mesh=m, device=dev,
                        **KW)
    c["ormqr"] = ormqr
    c["qr"] = lambda mod, dev, m: _call(mod, dev, m, "qr", "tall", **KW)
    c["lstsq"] = lambda mod, dev, m: _call(mod, dev, m, "lstsq", "tall", "c",
                                           **KW)
    c["eigh"] = lambda mod, dev, m: _call(mod, dev, m, "eigh", "sym", **EKW)
    c["svd"] = lambda mod, dev, m: _call(mod, dev, m, "svd", "tall", **EKW)
    return c


CASES = _cases()


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _jax_mesh():
    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("x", "y"))


@pytest.fixture(scope="module")
def jax_results():
    cache = {}

    def get(name):
        if name not in cache:
            with seam.swapped():
                cache[name] = tuple(np.asarray(r) for r in _tuple(
                    CASES[name](g8, None, _jax_mesh())))
        return cache[name]
    return get


def _within_ulps(got, ref, ulps):
    got = seam._np(got)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= ulps * np.spacing(np.abs(ref)))


@pytest.mark.parametrize("name", list(CASES))
def test_bit_equal_with_native_seam(name, mesh, jax_results):
    """svd: vt bit for bit, s and u within 4 ulps -- they come from the
    column-norm sum, whose order XLA and torch do not share, as in
    tests/test_torch_eig.py."""
    ref = jax_results(name)
    with seam.swapped():
        got = _tuple(CASES[name](gt, "cpu", mesh))
    assert len(got) == len(ref)
    if name == "svd":
        seam.bits_equal(got[2], ref[2])
        _within_ulps(got[0], ref[0], 4)
        _within_ulps(got[1], ref[1], 4)
        return
    for g, r in zip(got, ref):
        seam.bits_equal(g, r)


@pytest.mark.parametrize("name", list(CASES))
def test_native_path_within_1e12_of_jax(name, mesh, jax_results):
    """eigh and svd: the eigenvalues and singular values (their vectors'
    signs are the native eigensolver's choice), relative to the largest."""
    ref = jax_results(name)
    got = _tuple(CASES[name](gt, "cpu", mesh))
    if name in ("eigh", "svd"):
        i = 0 if name == "eigh" else 1
        got, ref = got[i:i + 1], ref[i:i + 1]
    for g, r in zip(got, ref):
        g = seam._np(g)
        if r.dtype.kind == "i":
            np.testing.assert_array_equal(g, r)
        else:
            assert np.max(np.abs(g - r)) / np.max(np.abs(r)) < 1e-12, name


@pytest.mark.parametrize("name", ["eigh", "svd"])
def test_eig_mesh_bits_equal_mesh_none(name, mesh):
    """The pair split changes no bit (as in the JAX package)."""
    with seam.swapped():
        got = _tuple(CASES[name](gt, "cpu", mesh))
        ref = _tuple(CASES[name](gt, "cpu", None))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
