"""The port's triangular solves, LU and Cholesky (gemmul8_tpu_torch.solvers)
against gemmul8_tpu.solvers on the CPU under x64.

- With the native seam swapped to scipy/numpy on both sides
  (tests/torch_native_seam.py), every function is bit-equal to JAX's
  (tolerance 0): trsm in every side/triangle/op with unit_diag and alpha,
  trmm, getrf (square, tall, wide), lu_solve, solve with refinement, inv,
  trtri, potrf (both triangles), potrs, posv, and complex trsm, solve
  (its getrf included) and potrf.
- Unswapped (the port's own LAPACK), each result is within a relative 1e-12
  of JAX's at nu=14 and meets the JAX tests' own contracts
  (tests/test_solvers.py: reconstruction < 1e-12, residuals < 1e-11,
  refinement at nu=6 below 1e-12).
- The mesh refusals, with JAX's text; the vector right-hand side that drops
  the mesh; port-only: the bad-shape refusals, and that no input tensor is
  modified. (With a mesh the calls are held against JAX's in
  tests/test_torch_solvers_mesh.py.)

Every JAX result is computed once (XLA compiles dominate: n = 64, block 32,
nu = 14 throughout, the refinement case at nu = 6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
import torch_native_seam as seam
from gemmul8_tpu_torch import solvers

N, BLK, NU = 64, 32, 14
KW = dict(num_moduli=NU, block=BLK)


def _tri(rng, n, lower, dtype=np.float64):
    # off-diagonals damped by 1/sqrt(n), as tests/test_solvers.py builds them
    a = rng.standard_normal((n, n)) / np.sqrt(n)
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal((n, n)) / np.sqrt(n)
    a = (np.tril(a) if lower else np.triu(a)).astype(dtype)
    a[np.arange(n), np.arange(n)] = 1.0 + rng.random(n)
    return a


def _spd(rng, n, dtype=np.float64):
    g = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        g = g + 1j * rng.standard_normal((n, n))
    return ((g @ g.conj().T) / n + 2 * np.eye(n)).astype(dtype)


def _inputs():
    rng = np.random.default_rng(20261017)
    x = dict(
        tl=_tri(rng, N, True), tu=_tri(rng, N, False),
        b=rng.standard_normal((N, N)),
        a=rng.standard_normal((N, N)),
        tall=rng.standard_normal((96, N)), wide=rng.standard_normal((N, 96)),
        rhs=rng.standard_normal((N, 3)), vec=rng.standard_normal(N),
        spd=_spd(rng, N),
        ztl=_tri(rng, N, True, np.complex128),
        za=(rng.standard_normal((N, N))
            + 1j * rng.standard_normal((N, N))),
        zvec=rng.standard_normal(N) + 1j * rng.standard_normal(N),
        zhpd=_spd(rng, N, np.complex128),
    )
    x["ad"] = x["a"] + N * np.eye(N)     # diagonally dominant, as HPL-MxP
    x["zad"] = x["za"] + N * np.eye(N)
    return x


X = _inputs()

# trsm variants: side, lower, trans_a, unit_diag, alpha
TRSM = [("left", True, False, False, 1.0),
        ("left", True, True, True, -2.5),
        ("left", False, False, False, 0.5),
        ("left", False, "T", True, 1.0),
        ("right", True, False, True, 1.0),
        ("right", True, "C", False, -1.25),
        ("right", False, "N", False, 1.0),
        ("right", False, True, True, 3.0)]
TRMM = [("left", True, False, False, 1.0),
        ("left", False, True, True, 0.5),
        ("right", True, True, True, -2.0),
        ("right", False, False, False, 1.0)]


def _tri_of(lower):
    return X["tl"] if lower else X["tu"]


def _call(mod, name, *args, device=None, **kw):
    """mod.name(*args) on numpy inputs: JAX arrays for gemmul8_tpu, numpy
    (placed on `device`) for the port."""
    if mod is g8:
        return getattr(g8, name)(*[jnp.asarray(a) for a in args], **kw)
    return getattr(gt, name)(*args, device=device, **kw)


def _cases():
    """name -> fn(mod, device): the calls held bit for bit."""
    cases = {}
    for v in TRSM:
        side, lower, trans, unit, alpha = v
        cases[f"trsm{v}"] = lambda mod, dev, side=side, lower=lower, \
            trans=trans, unit=unit, alpha=alpha: _call(
                mod, "trsm", _tri_of(lower), X["b"], side=side, lower=lower,
                trans_a=trans, unit_diag=unit, alpha=alpha, device=dev, **KW)
    for v in TRMM:
        side, lower, trans, unit, alpha = v
        cases[f"trmm{v}"] = lambda mod, dev, side=side, lower=lower, \
            trans=trans, unit=unit, alpha=alpha: _call(
                mod, "trmm", _tri_of(lower), X["b"], side=side, lower=lower,
                trans_a=trans, unit_diag=unit, alpha=alpha, device=dev, **KW)
    for key in ("a", "tall", "wide"):
        cases[f"getrf[{key}]"] = lambda mod, dev, key=key: _call(
            mod, "getrf", X[key], device=dev, **KW)

    def lu_solve(mod, dev, rhs):
        lu, perm = _call(mod, "getrf", X["a"], device=dev, **KW)
        if mod is g8:
            return g8.lu_solve(lu, perm, jnp.asarray(X[rhs]), **KW)
        return gt.lu_solve(lu, perm, X[rhs], device=dev, **KW)

    cases["lu_solve[matrix]"] = lambda mod, dev: lu_solve(mod, dev, "rhs")
    cases["lu_solve[vector]"] = lambda mod, dev: lu_solve(mod, dev, "vec")
    cases["solve[nu=6, refine 2]"] = lambda mod, dev: _call(
        mod, "solve", X["ad"], X["vec"], num_moduli=6, block=BLK,
        refine_steps=2, device=dev)
    cases["inv"] = lambda mod, dev: _call(mod, "inv", X["a"], device=dev,
                                          **KW)
    cases["trtri[lower]"] = lambda mod, dev: _call(
        mod, "trtri", X["tl"], lower=True, device=dev, **KW)
    cases["trtri[upper, unit]"] = lambda mod, dev: _call(
        mod, "trtri", X["tu"], lower=False, unit_diag=True, device=dev, **KW)
    for lower in (True, False):
        cases[f"potrf[lower={lower}]"] = lambda mod, dev, lower=lower: \
            _call(mod, "potrf", X["spd"], lower=lower, device=dev, **KW)

    def potrs(mod, dev):
        chol = _call(mod, "potrf", X["spd"], device=dev, **KW)
        if mod is g8:
            return g8.potrs(chol, jnp.asarray(X["rhs"]), **KW)
        return gt.potrs(chol, X["rhs"], device=dev, **KW)

    cases["potrs"] = potrs
    cases["posv"] = lambda mod, dev: _call(mod, "posv", X["spd"], X["vec"],
                                           device=dev, **KW)
    # one column, so that the updates share zsolve's compiled shapes
    cases["ztrsm"] = lambda mod, dev: _call(
        mod, "trsm", X["ztl"], X["zvec"][:, None], trans_a="C",
        alpha=0.5 - 1.5j, device=dev, **KW)
    cases["zsolve"] = lambda mod, dev: _call(mod, "solve", X["zad"],
                                             X["zvec"], device=dev, **KW)
    cases["zpotrf"] = lambda mod, dev: _call(mod, "potrf", X["zhpd"],
                                             device=dev, **KW)
    return cases


CASES = _cases()


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.fixture(scope="module")
def jax_results():
    """Each case's JAX result, computed once with the seam swapped (JAX's
    own LAPACK pieces are scipy's already; its eager `@` becomes numpy's)."""
    cache = {}

    def get(name):
        if name not in cache:
            with seam.swapped():
                cache[name] = tuple(np.asarray(r) for r in _tuple(
                    CASES[name](g8, None)))
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(CASES))
def test_bit_equal_with_native_seam(name, jax_results):
    ref = jax_results(name)
    with seam.swapped():
        got = _tuple(CASES[name](gt, "cpu"))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        seam.bits_equal(g, r)


def _relerr(got, ref):
    got = seam._np(got)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("name", list(CASES))
def test_native_path_within_1e12_of_jax(name, jax_results):
    """The port's own LAPACK (no seam) against JAX's result: factors and
    solutions within a relative 1e-12 (perm equal); the refinement case
    (nu = 6) within the accuracy refinement reaches."""
    ref = jax_results(name)
    got = _tuple(CASES[name](gt, "cpu"))
    for g, r in zip(got, ref):
        if r.dtype.kind == "i":
            np.testing.assert_array_equal(seam._np(g), r)
        else:
            assert _relerr(g, r) < 1e-12, name


def _op(t, lower, trans, unit):
    t = np.tril(t) if lower else np.triu(t)
    if unit:
        t = t - np.diag(np.diag(t)) + np.eye(t.shape[0])
    return {False: t, "N": t, True: t.T, "T": t.T, "C": t.conj().T}[trans]


@pytest.mark.parametrize("v", TRSM, ids=str)
def test_trsm_contract(v):
    side, lower, trans, unit, alpha = v
    t = _op(_tri_of(lower), lower, trans, unit)
    x = gt.trsm(_tri_of(lower), X["b"], side=side, lower=lower,
                trans_a=trans, unit_diag=unit, alpha=alpha, device="cpu",
                **KW).numpy()
    r = t @ x if side == "left" else x @ t
    # tests/test_solvers.py:79-86's scaled residual
    scale = max(np.max(np.abs(t)) * np.max(np.abs(x)),
                np.max(np.abs(alpha * X["b"])))
    assert np.max(np.abs(r - alpha * X["b"])) / (scale * N) < 1e-14


@pytest.mark.parametrize("v", TRMM, ids=str)
def test_trmm_contract(v):
    side, lower, trans, unit, alpha = v
    t = _op(_tri_of(lower), lower, trans, unit)
    y = gt.trmm(_tri_of(lower), X["b"], side=side, lower=lower,
                trans_a=trans, unit_diag=unit, alpha=alpha, device="cpu",
                **KW).numpy()
    ref = alpha * (t @ X["b"] if side == "left" else X["b"] @ t)
    assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 1e-13


@pytest.mark.parametrize("key", ["a", "tall", "wide", "za"])
def test_getrf_contract(key):
    a = X[key]
    lu, perm = gt.getrf(a, device="cpu", **KW)
    lu, perm = lu.numpy(), perm.numpy()
    m, n = a.shape
    k = min(m, n)
    el = np.tril(lu[:, :k], -1) + np.eye(m, k)
    u = np.triu(lu[:k])
    assert perm.dtype == np.int32 and sorted(perm) == list(range(m))
    assert np.max(np.abs(el @ u - a[perm])) / np.max(np.abs(a)) < 1e-12


def test_solve_contracts():
    """lu_solve and solve's residuals (test_solvers.py:148-178) and the
    refinement at nu = 6 (:180-196), real and complex."""
    a, ad, rhs, vec = X["a"], X["ad"], X["rhs"], X["vec"]
    lu, perm = gt.getrf(a, device="cpu", **KW)
    x = gt.lu_solve(lu, perm, rhs, device="cpu", **KW).numpy()
    assert np.max(np.abs(a @ x - rhs)) / np.max(np.abs(rhs)) < 1e-11
    x0 = gt.solve(ad, vec, num_moduli=6, block=BLK, device="cpu").numpy()
    x2 = gt.solve(ad, vec, num_moduli=6, block=BLK, refine_steps=2,
                  device="cpu").numpy()
    r0, r2 = (np.max(np.abs(ad @ x - vec)) for x in (x0, x2))
    assert x2.shape == (N,) and r2 < r0 * 1e-2
    assert r2 / np.max(np.abs(vec)) < 1e-12
    z = gt.solve(X["zad"], X["zvec"], device="cpu", **KW).numpy()
    assert np.max(np.abs(X["zad"] @ z - X["zvec"])) < 1e-11 * np.max(
        np.abs(X["zvec"]))


def test_inv_trtri_contracts():
    a = X["a"]
    ai = gt.inv(a, device="cpu", **KW).numpy()
    assert np.max(np.abs(a @ ai - np.eye(N))) < 1e-11
    ti = gt.trtri(X["tl"], device="cpu", **KW).numpy()
    assert np.array_equal(ti, np.tril(ti))
    assert np.max(np.abs(np.tril(X["tl"]) @ ti - np.eye(N))) < 1e-12
    tu = gt.trtri(X["tu"], lower=False, unit_diag=True, device="cpu",
                  **KW).numpy()
    assert np.array_equal(tu, np.triu(tu))
    assert np.array_equal(np.diag(tu), np.ones(N))


@pytest.mark.parametrize("key,lower", [("spd", True), ("spd", False),
                                       ("zhpd", True)])
def test_potrf_posv_contracts(key, lower):
    """Reconstruction (tests/test_solvers.py:231-247) and the SPD solves."""
    a = X[key]
    f = gt.potrf(a, lower=lower, device="cpu", **KW).numpy()
    if lower:
        assert np.array_equal(f, np.tril(f))
        rec = f @ f.conj().T
    else:
        assert np.array_equal(f, np.triu(f))
        rec = f.conj().T @ f
    assert np.max(np.abs(rec - a)) / np.max(np.abs(a)) < 1e-13
    if key == "spd":
        x = gt.potrs(f, X["rhs"], lower=lower, device="cpu", **KW).numpy()
        assert np.max(np.abs(a @ x - X["rhs"])) / np.max(
            np.abs(X["rhs"])) < 1e-12
        x = gt.posv(a, X["vec"], lower=lower, num_moduli=6, block=BLK,
                    refine_steps=2, device="cpu").numpy()
        assert np.max(np.abs(a @ x - X["vec"])) / np.max(
            np.abs(X["vec"])) < 1e-12


# ---------------------------------------------------------------------------
# port only
# ---------------------------------------------------------------------------

class _Grid:
    """A stand-in for a 2x2 DeviceMesh: the mesh refusals read only the
    shape of its rank grid, and a world of one cannot hold a real 2x2."""
    mesh = torch.empty(2, 2)


MESH = _Grid()


def _refusing_calls(mod):
    """name -> fn(mesh, block): each solver on matrix operands, JAX's
    (mod is g8) or the port's."""
    arr = jnp.asarray if mod is g8 else torch.from_numpy
    dev = {} if mod is g8 else dict(device="cpu")
    a, b, tl, spd = (arr(X[k]) for k in ("a", "rhs", "tl", "spd"))
    lu, perm = mod.getrf(a, **dev, **KW)
    chol = mod.potrf(spd, **dev, **KW)
    kw = dict(num_moduli=NU, **dev)
    return {
        "trsm": lambda m, blk: mod.trsm(tl, b, mesh=m, block=blk, **kw),
        "trmm": lambda m, blk: mod.trmm(tl, b, mesh=m, block=blk, **kw),
        "getrf": lambda m, blk: mod.getrf(a, mesh=m, block=blk, **kw),
        "lu_solve": lambda m, blk: mod.lu_solve(lu, perm, b, mesh=m,
                                                block=blk, **kw),
        "solve": lambda m, blk: mod.solve(a, b, mesh=m, block=blk, **kw),
        "potrf": lambda m, blk: mod.potrf(spd, mesh=m, block=blk, **kw),
        "potrs": lambda m, blk: mod.potrs(chol, b, mesh=m, block=blk, **kw),
        "posv": lambda m, blk: mod.posv(spd, b, mesh=m, block=blk, **kw),
        "inv": lambda m, blk: mod.inv(a, mesh=m, block=blk, **kw),
        "trtri": lambda m, blk: mod.trtri(tl, mesh=m, block=blk, **kw),
    }


def _jax_mesh_2x2():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("x", "y"))


# the calls whose substitution updates have the RHS as their n dimension
RHS_CHECKED = ("trsm", "trmm", "lu_solve", "potrs")


@pytest.mark.parametrize("name", solvers.__all__)
def test_mesh_refused_naming_queue_13(name):
    """The mesh refusals the JAX package makes (_check_mesh_blocking), with
    its text: a block that does not divide the matrix (block 24 of 64), and
    for the calls that solve against the RHS, an RHS width (3) that mesh.y
    (2) does not divide. (The test keeps the name it had when every mesh
    was refused.)"""
    cases = [24] + ([BLK] if name in RHS_CHECKED else [])
    for blk in cases:
        with pytest.raises(ValueError) as ref:
            _refusing_calls(g8)[name](_jax_mesh_2x2(), blk)
        with pytest.raises(ValueError) as got:
            _refusing_calls(gt)[name](MESH, blk)
        assert str(got.value) == str(ref.value)
        assert "with mesh 2x2 needs" in str(got.value)


@pytest.mark.parametrize("name", ["lu_solve", "potrs"])
def test_vector_rhs_drops_mesh(name):
    """As in the JAX package (solvers.py:548, :667), a vector RHS is solved
    locally whatever the mesh: the same bits as mesh=None."""
    if name == "lu_solve":
        lu, perm = gt.getrf(X["a"], device="cpu", **KW)
        fn = lambda **k: gt.lu_solve(lu, perm, X["vec"], **k)  # noqa: E731
    else:
        chol = gt.potrf(X["spd"], device="cpu", **KW)
        fn = lambda **k: gt.potrs(chol, X["vec"], **k)  # noqa: E731
    assert torch.equal(fn(mesh=MESH, device="cpu", **KW),
                       fn(device="cpu", **KW))


def test_bad_shapes_refused():
    """tests/test_solvers.py:209-228 and the square-only entries."""
    ones = lambda *s, dt=torch.float64: torch.ones(*s, dtype=dt)  # noqa
    with pytest.raises(ValueError):
        gt.trsm(ones(4, 3), ones(4, 2), device="cpu")
    with pytest.raises(ValueError):
        gt.trsm(ones(4, 4), ones(5, 2), device="cpu")
    with pytest.raises(ValueError):
        gt.trsm(ones(4, 4), ones(4, 2), side="up", device="cpu")
    with pytest.raises(TypeError):
        gt.trsm(ones(4, 4, dt=torch.float32), ones(4, 2), device="cpu")
    with pytest.raises(ValueError, match="bad op"):
        gt.trmm(ones(4, 4), ones(4, 2), trans_a="X", device="cpu")
    for fn in (gt.potrf, gt.inv, gt.trtri):
        with pytest.raises(ValueError):
            fn(ones(4, 3), device="cpu")
    with pytest.raises(ValueError):
        gt.posv(ones(4, 3), ones(4), device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        gt.getrf(ones(4), device="cpu")


def _all_calls():
    """Every public function of the module, on CPU tensors."""
    t = {k: torch.from_numpy(v.copy()) for k, v in X.items()}
    lu, perm = gt.getrf(t["a"], device="cpu", **KW)
    chol = gt.potrf(t["spd"], device="cpu", **KW)
    return [
        (lambda: gt.trsm(t["tu"], t["b"], lower=False, trans_a=True,
                         alpha=2.0, device="cpu", **KW), ("tu", "b")),
        (lambda: gt.trmm(t["tu"], t["b"], lower=False, side="right",
                         device="cpu", **KW), ("tu", "b")),
        (lambda: gt.getrf(t["a"], device="cpu", **KW), ("a",)),
        (lambda: gt.lu_solve(lu, perm, t["rhs"], device="cpu", **KW),
         ("rhs",)),
        (lambda: gt.solve(t["ad"], t["vec"], refine_steps=1, device="cpu",
                          **KW), ("ad", "vec")),
        (lambda: gt.potrf(t["spd"], lower=False, device="cpu", **KW),
         ("spd",)),
        (lambda: gt.potrs(chol, t["rhs"], device="cpu", **KW), ("rhs",)),
        (lambda: gt.posv(t["spd"], t["rhs"], refine_steps=1, device="cpu",
                         **KW), ("spd", "rhs")),
        (lambda: gt.inv(t["a"], device="cpu", **KW), ("a",)),
        (lambda: gt.trtri(t["tu"], lower=False, device="cpu", **KW),
         ("tu",)),
        (lambda: gt.getrf(t["za"], device="cpu", **KW), ("za",)),
    ], t, (lu, perm, chol)


@pytest.mark.parametrize("i", range(11))
def test_inputs_not_modified(i):
    """_as_tensor hands back the caller's own CPU tensor, so a functional
    update written in place would corrupt it: every input keeps its bits."""
    calls, t, (lu, perm, chol) = _all_calls()
    kept = {k: v.clone() for k, v in t.items()}
    kept_lu, kept_perm, kept_chol = lu.clone(), perm.clone(), chol.clone()
    fn, keys = calls[i]
    fn()
    for k in keys:
        assert torch.equal(t[k], kept[k]), k
    assert torch.equal(lu, kept_lu) and torch.equal(perm, kept_perm)
    assert torch.equal(chol, kept_chol)


def test_pivots_to_perm_is_jax_lu_perm():
    """LAPACK's sequential swaps, replayed, give jax.lax.linalg.lu's
    absolute permutation."""
    import jax
    import scipy.linalg
    a = X["tall"]
    _, piv = scipy.linalg.lu_factor(a)
    _, _, perm = jax.lax.linalg.lu(jnp.asarray(a))
    np.testing.assert_array_equal(solvers._pivots_to_perm(piv, a.shape[0]),
                                  np.asarray(perm))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gt.trsm(X["tl"], X["b"])


@pytest.mark.parametrize("op", ["getrf", "potrf", "geqrf"])
def test_solver_flops_counts_match_the_jax_harness(op):
    """probes.solver_flops counts flops as benchmarks/solver_flops.py does,
    and takes its default block."""
    import importlib.util
    import os
    import sys
    from gemmul8_tpu_torch.probes import solver_flops
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "solver_flops.py")
    spec = importlib.util.spec_from_file_location("_jax_solver_flops", path)
    harness = importlib.util.module_from_spec(spec)
    saved = sys.path[:]          # the harness puts benchmarks/ on the path
    try:
        spec.loader.exec_module(harness)
    finally:
        sys.path[:] = saved
    for n in (64, 4096, 8192, 12345):
        assert solver_flops.flops_of(op, n) == harness.flops_of(op, n)
        assert solver_flops.default_block(n) == min(1024, max(256, n // 8))
