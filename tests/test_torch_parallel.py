"""The port's SUMMA (gemmul8_tpu_torch.parallel) against gemmul8_tpu.parallel
on the CPU under x64, real operands.

- The same numpy inputs go through JAX's summa_gemm on conftest's virtual
  CPU devices (meshes (1,1) and (2,2); JAX's result is the same on every
  mesh) and through the port's on a gloo world of one (a 1x1 DeviceMesh):
  bit-equal in every mode -- f64 and f32, epilogue "f64" and "ff",
  fastmode True, "robust" and False, FP8 gather and stream, k_panel streams
  with ring and psum, and the exact-integer case (tests/test_parallel.py:
  50-56).
- The int32 shift vectors of the distributed fast and accurate shifts equal
  JAX's _shift_fast_dist / _shift_accu_dist on random inputs from several
  seeds and on an edge corpus (zero rows, 2^-120, -2^100, f64 rows above
  2^126, rows whose fixed-point norm samples saturate int32).
- Every refusal of summa_gemm gives JAX's text.
- summa_work_bytes and summa_bytes_moved give JAX's numbers on a grid of
  shapes, meshes, backends and modes.

Across mesh shapes the port is held in tests/test_torch_parallel_cluster.py.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gemmul8_tpu.parallel import summa as jsumma
from gemmul8_tpu_torch.parallel import summa
from oracle import phi_matrix

M, K, N = 64, 128, 48


def mesh_of(x, y):
    return Mesh(np.asarray(jax.devices()[:x * y]).reshape(x, y), ("x", "y"))


@pytest.fixture(scope="module")
def mesh():
    """A world of one and its 1x1 mesh, destroyed after the module."""
    m = summa.make_mesh(device_type="cpu")
    try:
        yield m
    finally:
        dist.destroy_process_group()


def _inputs():
    rng = np.random.default_rng(20261021)
    return dict(a=phi_matrix(rng, M, K, 1.0), b=phi_matrix(rng, K, N, 1.0),
                ia=rng.integers(-40, 40, (32, 64)).astype(np.float64),
                ib=rng.integers(-40, 40, (64, 16)).astype(np.float64),
                la=rng.standard_normal((8, 1 << 18)),
                lb=rng.standard_normal((1 << 18, 8)))


X = _inputs()

# name -> (operands, dtype, keyword arguments, JAX mesh shapes)
CASES = {
    "f64 nu=10": (("a", "b"), np.float64, dict(num_moduli=10),
                  ((1, 1), (2, 2))),
    "f64 robust": (("a", "b"), np.float64,
                   dict(num_moduli=10, fastmode="robust"), ((2, 2),)),
    "f64 accurate": (("a", "b"), np.float64,
                     dict(num_moduli=10, fastmode=False), ((2, 2),)),
    "f64 ff": (("a", "b"), np.float64, dict(num_moduli=10, epilogue="ff"),
               ((2, 2),)),
    "f32 nu=7": (("a", "b"), np.float32, dict(num_moduli=7), ((2, 2),)),
    "f32 ff robust": (("a", "b"), np.float32,
                      dict(num_moduli=7, epilogue="ff", fastmode="robust"),
                      ((2, 2),)),
    "fp8 gather": (("a", "b"), np.float64, dict(num_moduli=9, backend="FP8"),
                   ((2, 2),)),
    "fp8 gather accurate": (("a", "b"), np.float64,
                            dict(num_moduli=9, backend="FP8",
                                 fastmode=False), ((2, 2),)),
    "fp8 stream": (("a", "b"), np.float64,
                   dict(num_moduli=9, backend="FP8", k_panel=32), ((2, 2),)),
    "fp8 stream ff": (("a", "b"), np.float64,
                      dict(num_moduli=9, backend="FP8", k_panel=32,
                           epilogue="ff"), ((2, 2),)),
    "stream ring": (("a", "b"), np.float64, dict(num_moduli=10, k_panel=16),
                    ((1, 1), (2, 2))),
    "stream psum": (("a", "b"), np.float64,
                    dict(num_moduli=10, k_panel=16, bcast="psum"), ((2, 2),)),
    "stream accurate ff": (("a", "b"), np.float64,
                           dict(num_moduli=10, k_panel=32, fastmode=False,
                                epilogue="ff"), ((2, 2),)),
    "exact integer": (("ia", "ib"), np.float64, dict(num_moduli=8),
                      ((2, 2),)),
    # k = 2^18 in 2^16 panels: the raw int32 sum is folded mod p past 2^17
    "stream past K_CHUNK": (("la", "lb"), np.float64,
                            dict(num_moduli=10, k_panel=1 << 16), ((1, 1),)),
}
RUNS = [(name, shape) for name, c in CASES.items() for shape in c[3]]


@pytest.fixture(scope="module")
def jax_results():
    cache = {}

    def get(name, shape):
        if (name, shape) not in cache:
            keys, dt, kw, _ = CASES[name]
            a, b = (jnp.asarray(X[k].astype(dt)) for k in keys)
            cache[name, shape] = np.asarray(jsumma.summa_gemm(
                a, b, mesh=mesh_of(*shape), **kw))
        return cache[name, shape]
    return get


def _port(mesh, name):
    keys, dt, kw, _ = CASES[name]
    a, b = (torch.from_numpy(X[k].astype(dt)) for k in keys)
    return summa.summa_gemm(a, b, mesh=mesh, **kw)


@pytest.mark.parametrize("name,shape", RUNS, ids=[f"{n}-{s}" for n, s in RUNS])
def test_bit_equal_to_jax(name, shape, mesh, jax_results):
    ref = jax_results(name, shape)
    got = _port(mesh, name)
    assert got.shape == ref.shape
    got = got.to_local().numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_exact_integer_is_exact(mesh):
    got = _port(mesh, "exact integer").to_local().numpy()
    np.testing.assert_array_equal(got, X["ia"] @ X["ib"])


def test_dtensor_operands(mesh):
    """DTensor operands (Shard(0), Shard(1)) give the full tensors' bits."""
    from torch.distributed.tensor import DTensor, Shard
    a, b = (torch.from_numpy(X[k]) for k in ("a", "b"))
    da, db = (DTensor.from_local(x, mesh, [Shard(0), Shard(1)])
              for x in (a, b))
    got = summa.summa_gemm(da, db, mesh=mesh, num_moduli=10)
    assert list(got.placements) == [Shard(0), Shard(1)]
    assert torch.equal(got.to_local(),
                       summa.summa_gemm(a, b, mesh=mesh,
                                        num_moduli=10).to_local())


def test_mesh_none_needs_the_card():
    """As in the JAX package, mesh=None takes make_mesh(), whose default
    device is the card: without CUDA it raises before any collective."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        summa.summa_gemm(torch.ones(4, 4, dtype=torch.float64),
                         torch.ones(4, 4, dtype=torch.float64))


# ---------------------------------------------------------------------------
# the shift vectors
# ---------------------------------------------------------------------------

def _edge(dtype):
    """Rows (of A; columns of B) at the edges of the shift formulas."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, 64))
    x[0] = 0.0
    x[1] *= 2.0 ** -120
    x[2] *= -2.0 ** 100
    x[3, 1:] *= 1e-3             # one dominant element: z^2 * 2^30 > 2^31
    x[3, 0] = 1.9
    x[4, :] = 1.5
    x[5, 5] = 0.0
    x[6] = 0.0
    x[6, 9] = -3.0
    if dtype == np.float64:
        x[7] *= 2.0 ** 200       # above 2^126: the f64 prescale
        x[8] *= 2.0 ** -1000
        x[9] = 0.0
        x[9, 0] = 2.0 ** 1020
    return x.astype(dtype)


def _random(seed, dtype):
    rng = np.random.default_rng(seed)
    return phi_matrix(rng, 16, 64, 2.0, dtype)


SHIFT_INPUTS = ([("edge", dt) for dt in (np.float64, np.float32)]
                + [(seed, dt) for seed in (1, 2, 3)
                   for dt in (np.float64, np.float32)])


def _jax_shift_fast(x, nu, backend, variant, rows):
    """JAX's distributed fast shifts of x's rows (A, reduced over "y") or
    of its transpose's columns (B, reduced over "x") on a 2x2 mesh."""
    mesh = mesh_of(2, 2)
    if rows:
        fn = functools.partial(jsumma._shift_fast_dist, num_moduli=nu,
                               backend=backend, reduce_axis=1, axis_name="y",
                               variant=variant)
        out = P("x")
    else:
        x = x.T
        fn = functools.partial(jsumma._shift_fast_dist, num_moduli=nu,
                               backend=backend, reduce_axis=0, axis_name="x",
                               variant=variant)
        out = P("y")
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x", "y")))
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P("x", "y"), out_specs=out,
        check_vma=False))(xs))


@pytest.mark.parametrize("which,dt", SHIFT_INPUTS,
                         ids=[f"{w}-{np.dtype(d).name}"
                              for w, d in SHIFT_INPUTS])
@pytest.mark.parametrize("variant", ["reference", "invariant"])
def test_fast_shift_vectors_equal_jax(which, dt, variant, mesh):
    x = _edge(dt) if which == "edge" else _random(which, dt)
    comm = summa.Comm(mesh)
    for rows in (True, False):
        ref = _jax_shift_fast(x, 10, "INT8", variant, rows)
        t = torch.from_numpy(x if rows else np.ascontiguousarray(x.T))
        got = summa._shift_fast_dist(t, 10, "INT8", 1 if rows else 0, comm,
                                     "y" if rows else "x", variant=variant)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_norm_samples_saturate_as_xla():
    """The edge corpus's row 3 holds z^2 * 2^30 >= 2^31: the fixed-point
    sample saturates at 2^31 - 1 as XLA's f32 -> int32 conversion does
    (torch's own conversion would give -2^31)."""
    z = torch.tensor([1.9, 1.5, 1.0, 0.5], dtype=torch.float32)
    got = summa._norm_samples(z).numpy()
    ref = np.asarray(jax.jit(lambda v: jnp.floor(
        (v * v) * np.float32(2.0 ** 30)).astype(jnp.int32))(z.numpy()))
    np.testing.assert_array_equal(got, ref)
    assert got[0] == got[1] == 2 ** 31 - 1


def _jax_shift_accu(a, b, nu, backend):
    mesh = mesh_of(2, 2)
    spec = P("x", "y")
    fn = functools.partial(jsumma._shift_accu_dist, num_moduli=nu,
                           backend=backend)
    xs = [jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
          for x in (a, b)]
    return [np.asarray(s) for s in jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(spec, spec), out_specs=(P("x"), P("y")),
        check_vma=False))(*xs)]


@pytest.mark.parametrize("which,dt", SHIFT_INPUTS[:4],
                         ids=[f"{w}-{np.dtype(d).name}"
                              for w, d in SHIFT_INPUTS[:4]])
@pytest.mark.parametrize("backend", ["INT8", "FP8"])
def test_accurate_shift_vectors_equal_jax(which, dt, backend, mesh):
    """k = 64 <= 252: FP8's estimate is bit-equal to JAX's there."""
    a = _edge(dt) if which == "edge" else _random(which, dt)
    b = np.ascontiguousarray((_random(9, dt) if which == "edge"
                              else _random(which + 10, dt)).T)
    ref = _jax_shift_accu(a, b, 10, backend)
    got = summa._shift_accu_dist(torch.from_numpy(a), torch.from_numpy(b), 10,
                                 backend, summa.Comm(mesh))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _refusals():
    a, b = X["a"], X["b"]
    big_a = np.ones((1, 1 << 18))
    big_b = np.ones((1 << 18, 1))
    long_a = np.ones((1, 1 << 23))
    long_b = np.ones((1 << 23, 1))
    return {
        "bcast": (a, b, dict(bcast="tree")),
        "num_moduli": (a, b, dict(num_moduli=21)),
        "num_moduli f32": (a.astype(np.float32), b.astype(np.float32),
                           dict(num_moduli=14)),
        "k_panel divides": (a, b, dict(k_panel=24)),
        "k_panel int8 limit": (big_a, big_b, dict(k_panel=1 << 18)),
        "k_panel fp8 limit": (big_a, big_b, dict(k_panel=1 << 17,
                                                 backend="FP8")),
        "stream overflow": (long_a, long_b, dict(k_panel=1)),
    }


REFUSALS = _refusals()


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_give_jax_text(name, mesh):
    a, b, kw = REFUSALS[name]
    with pytest.raises(ValueError) as ref:
        np.asarray(jsumma.summa_gemm(jnp.asarray(a), jnp.asarray(b),
                                     mesh=mesh_of(1, 1), **kw))
    with pytest.raises(ValueError) as got:
        summa.summa_gemm(torch.from_numpy(a), torch.from_numpy(b), mesh=mesh,
                         **kw)
    assert str(got.value) == str(ref.value)


def test_port_refusals(mesh):
    """The refusals the port adds: a bad backend (JAX fails deeper), a
    dtype it does not emulate, a mesh without the ("x", "y") names."""
    a, b = (torch.from_numpy(X[k]) for k in ("a", "b"))
    with pytest.raises(ValueError, match="backend must be"):
        summa.summa_gemm(a, b, mesh=mesh, backend="INT4")
    with pytest.raises(TypeError, match="float32 and float64"):
        summa.summa_gemm(a.half(), b.half(), mesh=mesh)
    with pytest.raises(ValueError, match="inner dimensions"):
        summa.summa_gemm(a, b.T, mesh=mesh)
    from torch.distributed.device_mesh import DeviceMesh
    other = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                       mesh_dim_names=("rows", "cols"))
    with pytest.raises(ValueError, match="mesh_dim_names"):
        summa.summa_gemm(a, b, mesh=other)


# ---------------------------------------------------------------------------
# the memory and traffic models
# ---------------------------------------------------------------------------

SHAPES = [(4096, 4096, 4096), (8192, 2048, 65536), (65536, 65536, 65536),
          (1024, 1024, (1 << 17) + 1024)]
MESHES = [(1, 1), (2, 4), (4, 8)]
MODEL_GRID = list(itertools.product(range(len(SHAPES)), MESHES,
                                    ["INT8", "FP8"]))


@pytest.mark.parametrize("si,mesh_dims,backend", MODEL_GRID,
                         ids=[f"{SHAPES[s]}-{m}-{b}"
                              for s, m, b in MODEL_GRID])
def test_models_give_jax_numbers(si, mesh_dims, backend):
    m, n, k = SHAPES[si]
    for nu, panel in ((16, None), (10, 1024), (14, 4096)):
        for jdt, tdt in ((jnp.float64, torch.float64),
                         (jnp.float32, torch.float32),
                         (jnp.complex128, torch.complex128)):
            assert summa.summa_work_bytes(
                m, n, k, mesh_dims, nu, dtype=tdt, k_panel=panel,
                backend=backend) == jsumma.summa_work_bytes(
                m, n, k, mesh_dims, nu, dtype=jdt, k_panel=panel,
                backend=backend)
        for bcast, fastmode, lanes in itertools.product(
                ("ring", "psum"), (True, "robust", False), (False, True)):
            kw = dict(k_panel=panel, bcast=bcast, backend=backend,
                      fastmode=fastmode, complex_lanes=lanes)
            assert summa.summa_bytes_moved(m, n, k, mesh_dims, nu, **kw) == \
                jsumma.summa_bytes_moved(m, n, k, mesh_dims, nu, **kw)
