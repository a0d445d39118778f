"""The slice end to end: gemmul8_tpu_torch.gemm(..., device="cpu") bit-equal
to gemmul8_tpu.gemm on the CPU, for f64 at nu=16 and f32 at nu=8, both
epilogues, fast and robust shifts, ragged shapes, the K-chunked path and k=0.
(The alpha/beta and transpose cases are in test_torch_gemm_ops.py.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt

NU = {np.float32: 8, np.float64: 16}


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


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("epilogue", ["f64", "ff"])
def test_gemm_bit_equal(dtype, epilogue):
    a, b = _operands(1, 40, 300, 33, dtype)       # ragged shape
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), num_moduli=NU[dtype],
                  epilogue=epilogue)
    got = gt.gemm(a, b, num_moduli=NU[dtype], epilogue=epilogue, device="cpu")
    assert got.device.type == "cpu"
    assert_same_bits(got, ref)


@pytest.mark.parametrize("dtype,epilogue", [(np.float64, "ff"),
                                            (np.float32, "f64")])
def test_gemm_robust_bit_equal(dtype, epilogue):
    a, b = _operands(2, 33, 200, 47, dtype)
    a *= 1e-6                                     # the scale robust mode is for
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), num_moduli=NU[dtype],
                  fastmode="robust", epilogue=epilogue)
    got = gt.gemm(a, b, num_moduli=NU[dtype], fastmode="robust",
                  epilogue=epilogue, device="cpu")
    assert_same_bits(got, ref)


@pytest.mark.parametrize("epilogue", ["ff", "f64"])
def test_gemm_chunked_k_bit_equal(epilogue):
    """k = 2^17 + 64 crosses the int32-exact chunk bound."""
    a, b = _operands(3, 8, (1 << 17) + 64, 8, np.float64)
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), num_moduli=16,
                  epilogue=epilogue)
    got = gt.gemm(a, b, num_moduli=16, epilogue=epilogue, device="cpu")
    assert_same_bits(got, ref)


def test_gemm_auto_epilogue_is_f64_on_cpu():
    a, b = _operands(4, 40, 300, 33, np.float64)
    auto = gt.gemm(a, b, num_moduli=16, device="cpu")
    assert torch.equal(auto, gt.gemm(a, b, num_moduli=16, epilogue="f64",
                                     device="cpu"))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gemm_k0_gives_zeros(dtype):
    a = np.zeros((5, 0), dtype)
    b = np.zeros((0, 7), dtype)
    got = gt.gemm(a, b, num_moduli=NU[dtype], device="cpu")
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), num_moduli=NU[dtype])
    assert_same_bits(got, ref)
    assert not got.any()


def test_gemm_accepts_tensors_and_matmul_alias():
    a, b = _operands(5, 12, 20, 9, np.float64)
    c1 = gt.gemm(torch.from_numpy(a), torch.from_numpy(b), num_moduli=16,
                 device="cpu")
    c2 = gt.matmul(a, b, num_moduli=16, device="cpu")
    assert torch.equal(c1, c2)
    assert float((c1 - torch.from_numpy(a @ b)).abs().max()) < 1e-9
