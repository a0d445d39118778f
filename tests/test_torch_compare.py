"""The port's comparison baselines against gemmul8_tpu.compare on the CPU
under x64. matmul_os1_int8: bit for bit (tolerance 0), f64 and f32, d = 8
and d = 4, ragged shapes. matmul_bf16x9: the split bit for bit, and the
product within |port - jax| <= 2 * k * 2^-24 * (|A| |B|) elementwise: the
nine sums and their order are JAX's, but each product's own summation
order is the library's (XLA's dot there, an f32 matmul here)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu import compare as jcmp
from gemmul8_tpu_torch import compare as tcmp


def _bits_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def _phi(rng, m, n, dtype=np.float64, phi=1.0):
    return ((rng.random((m, n)) - 0.5)
            * np.exp(rng.standard_normal((m, n)) * phi)).astype(dtype)


def test_exported_as_in_jax():
    assert gt.compare is tcmp and g8.compare is jcmp


@pytest.mark.parametrize("dtype,d", [(np.float64, 8), (np.float64, 4),
                                     (np.float32, 8)])
def test_matmul_os1_int8_bit_equal(dtype, d):
    rng = np.random.default_rng(d)
    a = _phi(rng, 37, 90, dtype)
    b = _phi(rng, 90, 23, dtype)
    a[3] = 0.0                                    # a zero row
    b[:, 5] *= 2.0 ** 80                          # a wide column
    ref = jcmp.matmul_os1_int8(jnp.asarray(a), jnp.asarray(b), d=d)
    got = tcmp.matmul_os1_int8(a, b, d=d, device="cpu")
    assert got.device.type == "cpu"
    _bits_equal(got, ref)
    if dtype == np.float64 and d == 8:
        exact = a.astype(np.longdouble) @ b.astype(np.longdouble)
        scale = np.abs(a) @ np.abs(b)
        err = np.abs(got.numpy() - exact)
        assert np.all(err[scale == 0] == 0)
        assert np.max(err[scale > 0] / scale[scale > 0]) < 1e-13


def test_matmul_os1_int8_refuses_k_past_2_17():
    a = torch.zeros((2, (1 << 17) + 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="k <= 2"):
        tcmp.matmul_os1_int8(a, a.T, device="cpu")


def test_round_bf16_is_reduce_precision():
    """RNE to bf16's grid in f32, on the integer view: ties both ways,
    negatives, the overflow to inf, subnormals, inf and NaN."""
    u = 2.0 ** -8
    vals = np.array([1.0, 1 + u, 1 + 3 * u, 1 + u / 2, 1 + 1.5 * u,
                     -(1 + u), -(1 + 3 * u), 3.3895313892515355e38,
                     3.4e38, -3.4e38, 1e-40, -3e-42, 2.0 ** -149, 0.0,
                     -0.0, np.inf, -np.inf, np.nan, np.pi, -np.e, 65535.0,
                     1.00390625, 1.01171875], np.float32)
    ref = np.asarray(jax.lax.reduce_precision(jnp.asarray(vals), 8, 7))
    got = tcmp._round_bf16(torch.from_numpy(vals)).numpy()
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    _bits_equal(got[~nan], ref[~nan])


def test_bf16_split_bit_equal_and_exact():
    rng = np.random.default_rng(9)
    x = _phi(rng, 17, 33, np.float32, phi=3.0)
    ref = jcmp._bf16_split3(jnp.asarray(x))
    got = tcmp._bf16_split3(torch.from_numpy(x))
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        _bits_equal(g.to(torch.float32), np.asarray(r).astype(np.float32))
    parts = [g.to(torch.float64).numpy() for g in got]
    resid = np.abs(x.astype(np.float64) - sum(parts))
    assert np.all(resid <= 2.0 ** -48 * np.abs(x.astype(np.float64)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matmul_bf16x9_within_summation_order(dtype):
    rng = np.random.default_rng(10)
    k = 96
    a = _phi(rng, 40, k, dtype)
    b = _phi(rng, k, 29, dtype)
    ref = np.asarray(jcmp.matmul_bf16x9(jnp.asarray(a), jnp.asarray(b)))
    got = tcmp.matmul_bf16x9(a, b, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    scale = np.abs(a.astype(np.float32)).astype(np.float64) @ np.abs(
        b.astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(got.numpy().astype(np.float64) - ref)
                  <= 2 * k * 2.0 ** -24 * scale)
    exact = a.astype(np.float32).astype(np.float64) @ b.astype(
        np.float32).astype(np.float64)
    assert np.all(np.abs(got.numpy() - exact) <= 2 * k * 2.0 ** -24 * scale)


def test_default_device_is_cuda():
    a = np.ones((4, 4))
    if torch.cuda.is_available():
        assert tcmp.matmul_os1_int8(a, a).device.type == "cuda"
        assert tcmp.matmul_bf16x9(a, a).device.type == "cuda"
    else:
        for fn in (tcmp.matmul_os1_int8, tcmp.matmul_bf16x9):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(a, a)
