"""The port's planar-complex SUMMA (summa_gemm_planar, and summa_gemm on
complex tensors) against gemmul8_tpu.parallel on the CPU under x64.

- Same numpy inputs; JAX on conftest's virtual CPU devices (mesh (2,2), one
  case on (1,1) too), the port on a gloo world of one: bit-equal for
  complex128 and complex64, gather and stream (ring and psum), fast, robust
  and accurate shifts, epilogue "f64" and "ff" (nu <= 16 through the
  complex epilogue, nu > 16 through the recombine and the real epilogue
  twice), and FP8 complex gather.
- The shared complex shift vectors (fast and accurate) equal JAX's.
- Every refusal gives JAX's text; FP8 complex streaming stays refused.
"""
import functools

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

M, K, N = 32, 128, 48


def mesh_of(x, y):
    return Mesh(np.asarray(jax.devices()[:x * y]).reshape(x, y), ("x", "y"))


@pytest.fixture(scope="module")
def mesh():
    m = summa.make_mesh(device_type="cpu")
    try:
        yield m
    finally:
        dist.destroy_process_group()


def _inputs():
    rng = np.random.default_rng(20261022)

    def cplx(m, n, phi):
        return phi_matrix(rng, m, n, phi) + 1j * phi_matrix(rng, m, n, phi)
    return dict(a=cplx(M, K, 0.5), b=cplx(K, N, 0.5),
                ia=rng.integers(-20, 20, (M, K)) + 1j * rng.integers(
                    -20, 20, (M, K)),
                ib=rng.integers(-20, 20, (K, N)) + 1j * rng.integers(
                    -20, 20, (K, N)))


X = _inputs()

# name -> (operands, dtype, planar?, keyword arguments, JAX mesh shapes)
CASES = {
    "c128 nu=16": (("a", "b"), np.complex128, True, dict(num_moduli=16),
                   ((1, 1), (2, 2))),
    "c128 nu=18 ff": (("a", "b"), np.complex128, True,
                      dict(num_moduli=18, epilogue="ff"), ((2, 2),)),
    "c128 robust ff": (("a", "b"), np.complex128, True,
                       dict(num_moduli=12, fastmode="robust", epilogue="ff"),
                       ((2, 2),)),
    "c128 accurate": (("a", "b"), np.complex128, True,
                      dict(num_moduli=12, fastmode=False), ((2, 2),)),
    "c64 nu=8": (("a", "b"), np.complex64, True, dict(num_moduli=8),
                 ((2, 2),)),
    "c128 stream ring": (("a", "b"), np.complex128, True,
                         dict(num_moduli=12, k_panel=16), ((2, 2),)),
    "c128 stream psum ff": (("a", "b"), np.complex128, True,
                            dict(num_moduli=12, k_panel=32, bcast="psum",
                                 epilogue="ff"), ((2, 2),)),
    "c128 stream accurate": (("a", "b"), np.complex128, True,
                             dict(num_moduli=12, k_panel=32, fastmode=False),
                             ((2, 2),)),
    "c64 fp8 gather": (("a", "b"), np.complex64, True,
                       dict(num_moduli=9, backend="FP8"), ((2, 2),)),
    "c128 fp8 gather ff": (("a", "b"), np.complex128, True,
                           dict(num_moduli=14, backend="FP8", epilogue="ff"),
                           ((2, 2),)),
    "c128 complex dtype": (("a", "b"), np.complex128, False,
                           dict(num_moduli=12), ((2, 2),)),
    "exact integer": (("ia", "ib"), np.complex128, True, dict(num_moduli=8),
                      ((2, 2),)),
}
RUNS = [(name, shape) for name, c in CASES.items() for shape in c[4]]


def _jax(name, shape):
    keys, dt, planar, kw, _ = CASES[name]
    a, b = (X[k].astype(dt) for k in keys)
    if not planar:
        return (np.asarray(jsumma.summa_gemm(
            jnp.asarray(a), jnp.asarray(b), mesh=mesh_of(*shape), **kw)),)
    parts = [jnp.asarray(p) for x in (a, b) for p in (x.real, x.imag)]
    return tuple(np.asarray(c) for c in jsumma.summa_gemm_planar(
        *parts, mesh=mesh_of(*shape), **kw))


def _port(mesh, name):
    keys, dt, planar, kw, _ = CASES[name]
    a, b = (X[k].astype(dt) for k in keys)
    if not planar:
        return (summa.summa_gemm(torch.from_numpy(a), torch.from_numpy(b),
                                 mesh=mesh, **kw).to_local(),)
    parts = [torch.from_numpy(np.ascontiguousarray(p))
             for x in (a, b) for p in (x.real, x.imag)]
    return tuple(c.to_local()
                 for c in summa.summa_gemm_planar(*parts, mesh=mesh, **kw))


@pytest.fixture(scope="module")
def jax_results():
    cache = {}

    def get(name, shape):
        if (name, shape) not in cache:
            cache[name, shape] = _jax(name, shape)
        return cache[name, shape]
    return get


@pytest.mark.parametrize("name,shape", RUNS, ids=[f"{n}-{s}" for n, s in RUNS])
def test_bit_equal_to_jax(name, shape, mesh, jax_results):
    ref = jax_results(name, shape)
    got = _port(mesh, name)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = g.numpy()
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8))


def test_exact_integer_is_exact(mesh):
    cr, ci = _port(mesh, "exact integer")
    ref = X["ia"] @ X["ib"]
    np.testing.assert_array_equal(cr.numpy(), ref.real)
    np.testing.assert_array_equal(ci.numpy(), ref.imag)


def _jax_shifts_cplx(ar, ai, br, bi, nu, fastmode, backend):
    mesh = mesh_of(2, 2)
    spec = P("x", "y")
    fn = functools.partial(jsumma._dist_shifts_cplx, num_moduli=nu,
                           fastmode=fastmode, backend=backend)
    xs = [jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
          for x in (ar, ai, br, bi)]
    return [np.asarray(s) for s in jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(spec,) * 4, out_specs=(P("x"), P("y")),
        check_vma=False))(*xs)]


@pytest.mark.parametrize("fastmode,backend", [(True, "INT8"),
                                              ("robust", "INT8"),
                                              (False, "INT8"),
                                              (False, "FP8")], ids=str)
def test_complex_shift_vectors_equal_jax(fastmode, backend, mesh):
    a, b = X["a"].copy(), X["b"].copy()
    a[0] = 0.0
    a[1] *= 2.0 ** -120
    a[2] *= 2.0 ** 200
    b[:, 3] *= -2.0 ** 100
    b[:, 4] = 1.9 + 0.01j
    parts = [np.ascontiguousarray(p) for x in (a, b) for p in (x.real, x.imag)]
    ref = _jax_shifts_cplx(*parts, 12, fastmode, backend)
    got = summa._dist_shifts_cplx(*(torch.from_numpy(p) for p in parts), 12,
                                  fastmode, backend, summa.Comm(mesh))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


def _refusals():
    a, b = X["a"], X["b"]
    return {
        "fp8 stream": ((a, b), dict(num_moduli=9, backend="FP8", k_panel=16)),
        "num_moduli": ((a, b), dict(num_moduli=21)),
        "num_moduli c64": ((a.astype(np.complex64), b.astype(np.complex64)),
                           dict(num_moduli=14)),
        "k_panel divides": ((a, b), dict(num_moduli=9, k_panel=24)),
        "backend": ((a, b), dict(backend="INT4")),
        "bcast": ((a, b), dict(bcast="tree")),
    }


REFUSALS = _refusals()


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_give_jax_text(name, mesh):
    (a, b), kw = REFUSALS[name]
    jparts = [jnp.asarray(p) for x in (a, b) for p in (x.real, x.imag)]
    tparts = [torch.from_numpy(np.ascontiguousarray(p))
              for x in (a, b) for p in (x.real, x.imag)]
    with pytest.raises(ValueError) as ref:
        jsumma.summa_gemm_planar(*jparts, mesh=mesh_of(1, 1), **kw)
    with pytest.raises(ValueError) as got:
        summa.summa_gemm_planar(*tparts, mesh=mesh, **kw)
    assert str(got.value) == str(ref.value)


def test_planar_type_refusals_give_jax_text(mesh):
    a = X["a"]
    bad = [(a.real, a.imag.astype(np.float32), a.real, a.imag),   # dtypes
           (a.real, a.imag[:, :64], a.real, a.imag)]             # shapes
    for parts in bad:
        with pytest.raises((TypeError, ValueError)) as ref:
            jsumma.summa_gemm_planar(*map(jnp.asarray, parts),
                                     mesh=mesh_of(1, 1))
        with pytest.raises((TypeError, ValueError)) as got:
            summa.summa_gemm_planar(
                *(torch.from_numpy(np.ascontiguousarray(p)) for p in parts),
                mesh=mesh)
        assert type(got.value) is type(ref.value)
        assert str(got.value) == str(ref.value)
