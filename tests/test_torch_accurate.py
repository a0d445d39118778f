"""Accurate mode (fastmode=False) of gemmul8_tpu_torch against gemmul8_tpu on
the CPU, bit for bit: the upper-bound extraction (the edge values of the
bf16 round-up, an f32-subnormal element and tail), the estimation product
(INT8 below and past its int32 range; FP8 where the JAX twin's f32 dot is
exact, and the upper-bound property past it), the shift formula, and the
accurate gemm on every ported path -- real INT8 and FP8, complex INT8 with
nu <= 16 and nu > 16, gemm_planar, herk and herk_planar. The JAX functions
are called jitted, as the gemm entry points run them; the gemm cases share
one shape per dtype, since XLA:CPU compiles dominate their time."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu import quantize as jq
from gemmul8_tpu_torch import quantize as tq


def _bits_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def _phi(rng, m, n, dtype=np.float64, phi=1.0):
    return ((rng.random((m, n)) - 0.5)
            * np.exp(rng.standard_normal((m, n)) * phi)).astype(dtype)


T = 2.0 ** -40     # an f64 tail below f32's precision at these magnitudes
# per backend: a row whose amax scales to itself (pre = 0) and the upper
# bounds its elements take. INT8: 63.5 + tail -> ceil 64 + bump = 65 (the
# largest value), 63 + tail -> 63 + bump = 64. FP8: 255.5 + tail -> 257,
# which bf16 rounds down to 256, bumped to 258; 254.5 + tail -> 256;
# 253.5 + tail -> 255 (bf16 holds every integer up to 256); 127 + tail ->
# 128.
EDGE_ROWS = {
    "INT8": ([63.5 + T, 63 + T, 63.0, 62.5, 32 + 2.0 ** -30, 17 - T,
              2.0 ** -20, 0.0],
             [65, 64, 63, 63, 33, 17, 1, 0]),
    "FP8": ([255.5 + T, 254.5 + T, 253.5 + T, 255 + T, 127 + T, 129.0, 0.3,
             0.0],
            [258, 256, 255, 256, 128, 129, 1, 0]),
}


def _edge_matrix(backend, dtype, rng):
    """The edge row at several power-of-two scales (the bounds do not move;
    f64's 2^-300 takes ilogb's route below f32's range; no f32 input is
    subnormal), a row holding an f32-subnormal element (2^-130 + 2^-160
    after scaling) and one with an f32-subnormal tail (2^-110 + 2^-140), a
    zero row and random rows."""
    vals, _ = EDGE_ROWS[backend]
    low = -300 if dtype == np.float64 else -80
    rows = [np.asarray(vals) * 2.0 ** s for s in (0, -37, 90, low)]
    rows.append([2.0 ** 40, (2.0 ** -130 + 2.0 ** -160) * 2.0 ** 35,
                 (2.0 ** -110 + 2.0 ** -140) * 2.0 ** 35, 0, 0, 0, 0, 0])
    rows.append(np.zeros(8))
    x = np.concatenate([np.asarray(rows), _phi(rng, 6, 8)])
    return x.astype(dtype)


@pytest.mark.parametrize("backend", ["INT8", "FP8"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_extract_ub_plane_bit_equal(backend, dtype):
    x = _edge_matrix(backend, dtype, np.random.default_rng(3))
    for axis, xs in ((0, x), (1, x.T.copy())):
        jit = jax.jit(functools.partial(jq.extract_ub_plane, backend=backend,
                                        scale_axis=axis))
        ref_ub, ref_pre = jit(jnp.asarray(xs))
        ub, pre = tq.extract_ub_plane(torch.from_numpy(xs), backend, axis)
        assert ub.dtype == (torch.int8 if backend == "INT8"
                            else torch.bfloat16)
        _bits_equal(pre, ref_pre)
        if backend == "FP8":
            ub = ub.view(torch.int16)
            ref_ub = np.asarray(ref_ub).view(np.int16)
        _bits_equal(ub, ref_ub)
    ub, pre = tq.extract_ub_plane(torch.from_numpy(x), backend, 0)
    ub = ub.double().numpy()
    vals, want = EDGE_ROWS[backend]
    if dtype == np.float32:
        # f32 rows carry no tail: the bound is the ceiling
        want = np.ceil(np.asarray(vals, np.float32))
    for r in range(4):
        np.testing.assert_array_equal(ub[r], want)
    if dtype == np.float64:
        # the subnormal element bounds to 1 in both; the subnormal tail
        # bumps, as jitted XLA bumps it
        assert ub[4, 1] == 1 and ub[4, 2] == 2
    top = {"INT8": 65, "FP8": 258} if dtype == np.float64 else \
        {"INT8": 64, "FP8": 256}
    assert ub.max() == top[backend]
    # a true upper bound of |x| * 2^pre
    y = np.abs(x.astype(np.float64)) * np.exp2(pre.numpy().astype(
        np.float64))[:, None]
    assert np.all(ub >= y) and np.all((ub == 0) == (x == 0))


def test_extract_ub_keeps_f32_subnormal_inputs():
    """An f32-subnormal input is a nonzero element to the port (bound 1);
    XLA:CPU flushes it to zero (bound 0), the deliberate difference that
    tests/test_torch_quantize.py pins for the encoder."""
    x = np.array([[1.0, 1e-42]], np.float32)
    for backend in ("INT8", "FP8"):
        ub, _ = tq.extract_ub_plane(torch.from_numpy(x), backend, 0)
        assert ub.double().tolist() == [[2 ** tq.MAX_UFP[backend], 1.0]]


def _ub_planes(rng, m, k, n, backend, signed=False):
    hi = 65 if backend == "INT8" else 258
    a = rng.integers(-hi if signed else 0, hi + 1, (m, k))
    b = rng.integers(-hi if signed else 0, hi + 1, (k, n))
    if backend == "INT8":
        return a.astype(np.int8), b.astype(np.int8)
    # bf16 integers: the ub planes never hold 257 (it rounds up to 258)
    a[a == 257], b[b == 257] = 258, 258
    return a, b


def _to(backend, x):
    if backend == "INT8":
        return jnp.asarray(x), torch.from_numpy(x)
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))


@pytest.mark.parametrize("backend,k,signed", [
    ("INT8", 300, False), ("INT8", 300, True), ("FP8", 252, False),
    ("FP8", 100, True)])
def test_estimate_gemm_bit_equal(backend, k, signed):
    a, b = _ub_planes(np.random.default_rng(k), 9, k, 7, backend, signed)
    (ja, ta), (jb, tb) = _to(backend, a), _to(backend, b)
    got = tq.estimate_gemm(ta, tb, backend)
    _bits_equal(got, jq.estimate_gemm(ja, jb, backend))
    # the same on a transposed (k-contiguous) rhs, as syrk and herk pass it
    _bits_equal(tq.estimate_gemm(ta, tb.T.contiguous().T, backend), got)


def test_estimate_gemm_int8_past_its_int32_range():
    """k past K_SAFE_INT8: f64 sums of 2^18-chunk products, exact where an
    int32 product would wrap (65^2 * 600000 > 2^31)."""
    k = 600_000
    assert k > tq.K_SAFE_INT8
    rng = np.random.default_rng(11)
    a = rng.integers(0, 66, (2, k)).astype(np.int8)
    b = rng.integers(-65, 66, (k, 3)).astype(np.int8)
    a[0], b[:, 0] = 65, 65
    got = tq.estimate_gemm(torch.from_numpy(a), torch.from_numpy(b), "INT8")
    assert got.dtype == torch.float64
    _bits_equal(got, jq.estimate_gemm(jnp.asarray(a), jnp.asarray(b), "INT8"))
    exact = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float64))
    assert got[0, 0] == 65 * 65 * k


@pytest.mark.parametrize("k", [253, 3000])
def test_estimate_gemm_fp8_past_exact_dot_is_an_upper_bound(k):
    """Past k = 252 the JAX twin's f32 dot rounds in XLA's order; the port's
    estimate (the exact sum rounded once, then the same inflation) stays an
    upper bound, within the inflation of the twin's, and gives the same
    shifts on these seeds."""
    rng = np.random.default_rng(k)
    a, b = _ub_planes(rng, 12, k, 10, "FP8")
    a[0], b[:, 0] = 258, 258
    (ja, ta), (jb, tb) = _to("FP8", a), _to("FP8", b)
    got = tq.estimate_gemm(ta, tb, "FP8").numpy()
    ref = np.asarray(jq.estimate_gemm(ja, jb, "FP8"))
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.all(got >= exact) and np.all(ref >= exact)
    np.testing.assert_allclose(got, ref, rtol=(k + 1) * 2.0 ** -23)
    pre = np.zeros(12, np.int32)
    for nu in (7, 12):
        for axis in (1, 0):
            _bits_equal(tq.shift_accu_from_chi(
                torch.from_numpy(got.max(axis)), torch.from_numpy(
                    pre[:got.shape[1 - axis]]), nu, "FP8"),
                jax.jit(jq.shift_accu_from_chi, static_argnums=(2, 3))(
                    jnp.asarray(ref.max(axis)), jnp.asarray(
                        pre[:got.shape[1 - axis]]), nu, "FP8"))


@pytest.mark.parametrize("backend,nu", [("INT8", 8), ("INT8", 16),
                                        ("INT8", 20), ("FP8", 14)])
def test_shift_accu_from_chi_bit_equal(backend, nu):
    """Row maxima of every type the estimates produce (int32, the chunked
    INT8 estimate's f64, FP8's f32), with pre-shifts, against the jitted
    twin (XLA takes log2 as log(x)/log(2) there; no floor flips on these
    seeds)."""
    rng = np.random.default_rng(nu)
    n = 4000
    pre = rng.integers(-300, 300, n).astype(np.int32)
    jit = jax.jit(jq.shift_accu_from_chi, static_argnums=(2, 3))
    cases = [rng.integers(0, 2 ** 31 - 1, n).astype(np.int32),
             np.floor(np.exp(rng.uniform(0, 50, n))),
             np.exp(rng.uniform(-2, 40, n)).astype(np.float32)]
    cases[0][:3] = (0, 1, 2 ** 31 - 1)
    for c in cases:
        _bits_equal(tq.shift_accu_from_chi(torch.from_numpy(c),
                                           torch.from_numpy(pre), nu,
                                           backend),
                    jit(jnp.asarray(c), jnp.asarray(pre), nu, backend))


M, K, N = 24, 60, 20
REAL = [
    # dtype, nu, backend, epilogue, trans_a, alpha, beta
    (np.float64, 16, "INT8", "f64", False, 1.0, 0.0),
    (np.float64, 16, "INT8", "ff", "T", -1.5, 0.7),
    (np.float32, 8, "INT8", "ff", False, 1.0, 0.0),
    (np.float32, 8, "INT8", "f64", "T", -1.5, 0.7),
    (np.float64, 14, "FP8", "ff", False, 1.0, 0.0),
    (np.float64, 14, "FP8", "f64", "T", -1.5, 0.7),
    (np.float32, 7, "FP8", "ff", False, 1.0, 0.0),
]


@pytest.mark.parametrize("dtype,nu,backend,epilogue,trans_a,alpha,beta",
                         REAL)
def test_accurate_gemm_real_bit_equal(dtype, nu, backend, epilogue, trans_a,
                                      alpha, beta):
    rng = np.random.default_rng(nu)
    a = _phi(rng, *((K, M) if trans_a else (M, K)), dtype, 2.0)
    b = _phi(rng, K, N, dtype, 2.0)
    c = _phi(rng, M, N, dtype)
    kw = dict(num_moduli=nu, fastmode=False, backend=backend,
              epilogue=epilogue, trans_a=trans_a, alpha=alpha, beta=beta)
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), c=jnp.asarray(c), **kw)
    got = gt.gemm(a, b, c=c, device="cpu", **kw)
    _bits_equal(got, ref)


def test_accurate_shifts_buy_bits():
    """At equal nu, the accurate shifts are at least the fast ones on a
    spread operand: the bits accurate mode buys."""
    from gemmul8_tpu_torch import core
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_phi(rng, M, K, phi=2.0))
    b = torch.from_numpy(_phi(rng, K, N, phi=2.0))
    sa, sb = core.shifts(a, b, 16, False, "INT8")
    fa, fb = core.shifts(a, b, 16, True, "INT8")
    assert torch.equal(fa, tq.shift_fast(a, 16, "INT8", 1))
    assert torch.equal(fb, tq.shift_fast(b, 16, "INT8", 0))
    assert float((sa - fa).float().mean() + (sb - fb).float().mean()) > 0


C128, C64 = np.complex128, np.complex64


def _cplx(rng, m, n, dtype):
    return (_phi(rng, m, n, phi=2.0) + 1j * _phi(rng, m, n, phi=2.0)
            ).astype(dtype)


@pytest.mark.parametrize("dtype,nu,epilogue,op_a,op_b,alpha,beta", [
    (C128, 16, "ff", "N", "N", 1.0, 0.0),
    (C128, 16, "f64", "C", "T", -1.5 + 0.25j, 0.7 - 0.3j),
    (C128, 20, "ff", "N", "C", 1.0, 0.7 - 0.3j),
    (C64, 8, "ff", "T", "N", -1.5 + 0.25j, 0.7 - 0.3j),
    (C64, 8, "f64", "N", "N", 1.0, 0.0),
])
def test_accurate_gemm_complex_bit_equal(dtype, nu, epilogue, op_a, op_b,
                                         alpha, beta):
    rng = np.random.default_rng(nu + len(epilogue))
    a = _cplx(rng, *((M, K) if op_a == "N" else (K, M)), dtype)
    b = _cplx(rng, *((K, N) if op_b == "N" else (N, K)), dtype)
    c = _cplx(rng, M, N, dtype)
    kw = dict(num_moduli=nu, fastmode=False, epilogue=epilogue, trans_a=op_a,
              trans_b=op_b, alpha=alpha, beta=beta)
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), c=jnp.asarray(c), **kw)
    _bits_equal(gt.gemm(a, b, c=c, device="cpu", **kw), ref)


def test_accurate_gemm_planar_bit_equal():
    rng = np.random.default_rng(21)
    a, b = _cplx(rng, K, M, C128), _cplx(rng, K, N, C128)
    planes = [np.ascontiguousarray(x) for x in (a.real, a.imag, b.real,
                                                b.imag)]
    kw = dict(num_moduli=16, fastmode=False, trans_a="C")
    ref_r, ref_i = g8.gemm_planar(*map(jnp.asarray, planes), **kw)
    got_r, got_i = gt.gemm_planar(*planes, device="cpu", **kw)
    _bits_equal(got_r, ref_r)
    _bits_equal(got_i, ref_i)


@pytest.mark.parametrize("dtype,nu,trans,alpha,beta", [
    (C128, 16, False, 1.0, 0.0), (C128, 20, True, -0.5, 2.0),
    (C64, 8, False, 1.5, 1.0)])
def test_accurate_herk_bit_equal(dtype, nu, trans, alpha, beta):
    rng = np.random.default_rng(nu)
    a = _cplx(rng, M, K, dtype)
    mdim = K if trans else M
    c = _cplx(rng, mdim, mdim, dtype)
    kw = dict(num_moduli=nu, fastmode=False, trans=trans, alpha=alpha,
              beta=beta)
    ref = g8.herk(jnp.asarray(a), c=jnp.asarray(c), **kw)
    _bits_equal(gt.herk(a, c=c, device="cpu", **kw), ref)


def test_accurate_herk_planar_bit_equal():
    rng = np.random.default_rng(22)
    a = _cplx(rng, M, K, C128)
    ar, ai = np.ascontiguousarray(a.real), np.ascontiguousarray(a.imag)
    ref_r, ref_i = g8.herk_planar(jnp.asarray(ar), jnp.asarray(ai),
                                  num_moduli=16, fastmode=False)
    got_r, got_i = gt.herk_planar(ar, ai, num_moduli=16, fastmode=False,
                                  device="cpu")
    _bits_equal(got_r, ref_r)
    _bits_equal(got_i, ref_i)


def test_accurate_complex_fp8_bit_equal_and_herk_fp8_refused():
    """Accurate complex FP8 (queue 8), once refused here, gives gemmul8_tpu's
    bits; herk on FP8 stays refused, as in the JAX package."""
    a = np.ones((4, 8), C128)
    _bits_equal(gt.gemm(a, a.T.copy(), backend="FP8", fastmode=False,
                        device="cpu"),
                g8.gemm(jnp.asarray(a), jnp.asarray(a.T.copy()),
                        backend="FP8", fastmode=False))
    with pytest.raises(NotImplementedError, match="use gemm"):
        gt.herk(a, backend="FP8", fastmode=False, device="cpu")


def test_int_mm_copies_one_row_operands_with_short_row_stride():
    """A k = 1 plane in the k-contiguous layout is a (1, n) tensor with row
    stride 1; torch's CPU _int_mm misreads it (the complex gemm with k = 1
    gave garbage through it), int_mm copies it to row-major first."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 1)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (4, 1)).astype(np.int8)).T
    a1 = torch.from_numpy(rng.integers(-127, 128, (5, 1)).astype(np.int8)).T
    b1 = torch.from_numpy(rng.integers(-127, 128, (5, 4)).astype(np.int8))
    assert b.shape == (1, 4) and b.stride() == (1, 1)
    assert torch.equal(tq.int_mm(a, b), a.int() @ b.int())
    assert torch.equal(tq.int_mm(a1, b1), a1.int() @ b1.int())
