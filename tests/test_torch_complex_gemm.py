"""The complex slice end to end: gemmul8_tpu_torch.gemm on complex64 and
complex128, gemm_planar, herk and herk_planar with device="cpu", bit-equal to
gemmul8_tpu on the CPU -- both epilogues, ops N/T/C, trivial and general
complex alpha/beta, a ragged shape, k = 0 and the K-chunked path -- plus the
error surface. The cases share few JAX configurations: XLA:CPU compiles
dominate their time."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt

M, K, N = 20, 50, 12                       # ragged


def _cplx(rng, m, n, dtype):
    z = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n)))
    return (z * np.exp(rng.standard_normal((m, n)))).astype(dtype)


def _operands(seed, dtype, op_a, op_b, k=K):
    rng = np.random.default_rng(seed)
    a = _cplx(rng, *((M, k) if op_a == "N" else (k, M)), dtype)
    b = _cplx(rng, *((k, N) if op_b == "N" else (N, k)), dtype)
    c = _cplx(rng, M, N, dtype)
    return a, b, c


def _bits_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


C128, C64 = np.complex128, np.complex64
CASES = [
    # dtype, nu, epilogue, fastmode, op_a, op_b, alpha, beta
    (C128, 16, "ff", True, "N", "N", 1.0, 0.0),
    (C128, 16, "f64", True, "T", "C", -1.5 + 0.25j, 0.7 - 0.3j),
    (C128, 16, "ff", "robust", "C", "T", -1.5 + 0.25j, 1.0),
    (C128, 20, "ff", True, "N", "C", 1.0, 0.7 - 0.3j),
    (C128, 20, "f64", True, "C", "N", -0.5, 0.0),
    (C64, 8, "ff", True, "T", "N", -1.5 + 0.25j, 0.7 - 0.3j),
    (C64, 8, "f64", "robust", "N", "T", 1, 1),
]


@pytest.mark.parametrize("dtype,nu,epilogue,fastmode,op_a,op_b,alpha,beta",
                         CASES)
def test_gemm_complex_bit_equal(dtype, nu, epilogue, fastmode, op_a, op_b,
                                alpha, beta):
    a, b, c = _operands(nu + len(op_a + op_b), dtype, op_a, op_b)
    kw = dict(num_moduli=nu, epilogue=epilogue, fastmode=fastmode,
              trans_a=op_a, trans_b=op_b, alpha=alpha, beta=beta)
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), c=jnp.asarray(c), **kw)
    got = gt.gemm(a, b, c=c, device="cpu", **kw)
    assert got.device.type == "cpu"
    _bits_equal(got, ref)


@pytest.mark.parametrize("dtype,nu", [(C128, 16), (C64, 8)])
def test_gemm_complex_k0_gives_zeros(dtype, nu):
    a = np.zeros((5, 0), dtype)
    b = np.zeros((0, 7), dtype)
    got = gt.gemm(a, b, num_moduli=nu, device="cpu")
    _bits_equal(got, g8.gemm(jnp.asarray(a), jnp.asarray(b), num_moduli=nu))
    assert not got.any()


def test_gemm_complex_chunked_k_bit_equal():
    """k = 2^17 + 64 crosses the int32-exact chunk bound: the K-chunked
    residue sums go into the complex epilogue."""
    rng = np.random.default_rng(7)
    k = (1 << 17) + 64
    a, b = _cplx(rng, 8, k, C128), _cplx(rng, k, 8, C128)
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), num_moduli=16,
                  epilogue="ff")
    got = gt.gemm(a, b, num_moduli=16, epilogue="ff", device="cpu")
    _bits_equal(got, ref)


def test_gemm_planar_bit_equal_and_matches_complex_gemm():
    a, b, _ = _operands(8, C64, "C", "T")
    planes = [np.ascontiguousarray(x) for x in (a.real, a.imag, b.real, b.imag)]
    kw = dict(num_moduli=8, trans_a="C", trans_b="T", epilogue="ff")
    ref_r, ref_i = g8.gemm_planar(*map(jnp.asarray, planes), **kw)
    got_r, got_i = gt.gemm_planar(*planes, device="cpu", **kw)
    _bits_equal(got_r, ref_r)
    _bits_equal(got_i, ref_i)
    z = gt.gemm(a, b, device="cpu", **kw)
    assert torch.equal(z, torch.complex(got_r, got_i))


@pytest.mark.parametrize("dtype,nu,trans,alpha,beta", [
    (C128, 16, False, -0.5, 2.0),
    (C64, 8, True, 1.5, 1.0),
])
def test_herk_bit_equal(dtype, nu, trans, alpha, beta):
    rng = np.random.default_rng(9)
    a = _cplx(rng, 24, 40, dtype)
    mdim = 40 if trans else 24
    c = _cplx(rng, mdim, mdim, dtype)
    kw = dict(trans=trans, num_moduli=nu, alpha=alpha, beta=beta)
    ref = g8.herk(jnp.asarray(a), c=jnp.asarray(c), **kw)
    got = gt.herk(a, c=c, device="cpu", **kw)
    _bits_equal(got, ref)


def test_herk_planar_bit_equal_and_matches_herk():
    rng = np.random.default_rng(9)
    a = _cplx(rng, 24, 40, C128)            # the first herk case's operand
    ar, ai = np.ascontiguousarray(a.real), np.ascontiguousarray(a.imag)
    ref_r, ref_i = g8.herk_planar(jnp.asarray(ar), jnp.asarray(ai),
                                  num_moduli=16)
    got_r, got_i = gt.herk_planar(ar, ai, num_moduli=16, device="cpu")
    _bits_equal(got_r, ref_r)
    _bits_equal(got_i, ref_i)
    assert torch.equal(gt.herk(a, num_moduli=16, device="cpu"),
                       torch.complex(got_r, got_i))


def test_gemm_complex_accepts_tensors_and_conjugate_views():
    a, b, _ = _operands(10, C128, "N", "N")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ref = gt.gemm(a.conj(), b, num_moduli=16, device="cpu")
    assert torch.equal(gt.gemm(ta.conj(), tb, num_moduli=16, device="cpu"),
                       ref)
    assert float((ref - torch.from_numpy(a.conj() @ b)).abs().max()) < 1e-9


def test_complex_error_surface():
    a = np.ones((4, 8), C128)
    b = np.ones((8, 3), C128)
    # complex FP8 and accurate mode, refused until they were ported, give
    # gemmul8_tpu's bits
    _bits_equal(gt.gemm(a, b, backend="FP8", device="cpu"),
                g8.gemm(jnp.asarray(a), jnp.asarray(b), backend="FP8"))
    _bits_equal(gt.gemm(a, b, fastmode=False, device="cpu"),
                g8.gemm(jnp.asarray(a), jnp.asarray(b), fastmode=False))
    _bits_equal(gt.herk(a, fastmode=False, device="cpu"),
                g8.herk(jnp.asarray(a), fastmode=False))
    with pytest.raises(NotImplementedError, match="use gemm"):
        gt.herk(a, backend="FP8", device="cpu")
    with pytest.raises(ValueError, match="bad op"):
        gt.gemm(a, b, trans_a="X", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        gt.gemm(a, b, backend="int8", device="cpu")
    for nu in (1, 14):
        with pytest.raises(ValueError, match="out of range"):
            gt.gemm(a.astype(C64), b.astype(C64), num_moduli=nu,
                    device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        gt.gemm_planar(a.real, a.imag, b.real, b.imag, num_moduli=21,
                       device="cpu")
    with pytest.raises(TypeError, match="complex-only"):
        gt.herk(a.real, device="cpu")
    with pytest.raises(TypeError, match="dtype mismatch"):
        gt.gemm(a, b.astype(C64), device="cpu")


def test_complex_default_device_is_cuda_never_a_hidden_cpu():
    a = np.ones((32, 64), C128)
    if torch.cuda.is_available():
        assert gt.gemm(a, a.T.copy()).device.type == "cuda"
        assert gt.herk(a).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gt.gemm(a, a.T.copy())
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gt.herk(a)
