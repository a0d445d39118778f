"""The FP8 backend end to end: gemmul8_tpu_torch.gemm(..., backend="FP8",
device="cpu") bit-equal to gemmul8_tpu.gemm(..., backend="FP8") on the CPU,
for f64 (square moduli only at nu=2, then mixed) and f32, both epilogues,
fast and robust shifts, ops T, general alpha/beta, the K-chunked path past
2^16 and k=0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt


def _operands(seed, m, k, n, dtype):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)) * np.exp(rng.standard_normal((m, k)))
    b = rng.standard_normal((k, n)) * np.exp(rng.standard_normal((k, n)))
    return a.astype(dtype), b.astype(dtype)


def assert_same_bits(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("dtype,nu", [(np.float64, 2), (np.float64, 7),
                                      (np.float64, 14), (np.float64, 20),
                                      (np.float32, 3), (np.float32, 7),
                                      (np.float32, 13)])
@pytest.mark.parametrize("epilogue", ["ff", "f64"])
def test_gemm_fp8_bit_equal(dtype, nu, epilogue):
    a, b = _operands(nu, 40, 300, 33, dtype)       # ragged shape
    kw = dict(num_moduli=nu, backend="FP8", epilogue=epilogue)
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), **kw)
    got = gt.gemm(a, b, device="cpu", **kw)
    assert got.device.type == "cpu"
    assert_same_bits(got, ref)


@pytest.mark.parametrize("dtype,nu,epilogue", [(np.float64, 14, "ff"),
                                               (np.float32, 7, "f64")])
def test_gemm_fp8_robust_bit_equal(dtype, nu, epilogue):
    a, b = _operands(2, 33, 200, 47, dtype)
    a *= 1e-6                                     # the scale robust mode is for
    kw = dict(num_moduli=nu, backend="FP8", fastmode="robust",
              epilogue=epilogue)
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), **kw)
    assert_same_bits(gt.gemm(a, b, device="cpu", **kw), ref)


@pytest.mark.parametrize("dtype,epilogue,alpha,beta,trans_a,trans_b", [
    (np.float64, "ff", -1.5, 0.7, "T", "N"),
    (np.float64, "f64", 1.0, 0.7, True, False),
    (np.float32, "ff", -1.5, 1.0, "T", "N"),
    (np.float32, "f64", -1.5, 0.7, "N", "T"),
])
def test_gemm_fp8_alpha_beta_trans_bit_equal(dtype, epilogue, alpha, beta,
                                             trans_a, trans_b):
    rng = np.random.default_rng(int(10 * alpha + 100 * beta) % 97)
    nu = 14 if dtype == np.float64 else 7
    a = rng.standard_normal((64, 24) if trans_a in ("T", True)
                            else (24, 64)).astype(dtype)
    b = rng.standard_normal((16, 64) if trans_b == "T"
                            else (64, 16)).astype(dtype)
    c = rng.standard_normal((24, 16)).astype(dtype)
    kw = dict(num_moduli=nu, backend="FP8", alpha=alpha, beta=beta,
              trans_a=trans_a, trans_b=trans_b, epilogue=epilogue)
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), c=jnp.asarray(c), **kw)
    got = gt.gemm(a, b, c=c, device="cpu", **kw)
    assert got.shape == (24, 16)
    assert_same_bits(got, ref)


@pytest.mark.parametrize("epilogue", ["ff", "f64"])
def test_gemm_fp8_chunked_k_bit_equal(epilogue):
    """k = 2^16 + 512 crosses the f32-exact chunk bound of the FP8 sums."""
    a, b = _operands(3, 8, (1 << 16) + 512, 8, np.float64)
    kw = dict(num_moduli=14, backend="FP8", epilogue=epilogue)
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), **kw)
    assert_same_bits(gt.gemm(a, b, device="cpu", **kw), ref)


def test_gemm_fp8_k0_gives_zeros():
    a = np.zeros((5, 0))
    b = np.zeros((0, 7))
    got = gt.gemm(a, b, num_moduli=14, backend="FP8", device="cpu")
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), num_moduli=14,
                  backend="FP8")
    assert_same_bits(got, ref)
    assert not got.any()


def test_gemm_fp8_accuracy_rises_with_nu():
    """More moduli, smaller error: the FP8 path is a working emulation, not
    only a bit-copy of the reference."""
    a, b = _operands(4, 24, 200, 16, np.float64)
    exact = a.astype(np.longdouble) @ b.astype(np.longdouble)
    errs = [float(np.max(np.abs(gt.gemm(a, b, num_moduli=nu, backend="FP8",
                                        device="cpu").numpy() - exact)))
            for nu in (4, 8, 12, 16)]
    assert errs == sorted(errs, reverse=True) and errs[-1] < 1e-9
