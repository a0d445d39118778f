"""Precomputed operands of gemmul8_tpu_torch (precompute, gemm_quantized,
QuantizedOperand, quantized_from_numpy) against gemmul8_tpu on the CPU, bit
for bit: two- and one-sided reuse on INT8 and FP8, the planes themselves
(INT8), the round trip of a JAX operand's arrays, and the argument errors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu_torch import core


def _bits_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def _phi(rng, shape, phi=0.5, dtype=np.float64):
    x = (rng.random(shape) - 0.5) * np.exp(rng.standard_normal(shape) * phi)
    return x.astype(dtype)


def _pre(x, side, nu, backend="INT8"):
    return gt.precompute(x, side, num_moduli=nu, backend=backend,
                         device="cpu")


@pytest.mark.parametrize("backend,nu", [("INT8", 9), ("FP8", 6)])
def test_one_sided_precompute(backend, nu):
    """Both sides precomputed, and either one, equal the JAX package's
    gemm_quantized and its gemm (reference: skip_scalA XOR skip_scalB,
    gemmul8_real.hpp:123-139); two raw operands raise TypeError."""
    rng = np.random.default_rng(101)
    a, b = _phi(rng, (24, 100)), _phi(rng, (100, 20))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ref = g8.gemm_quantized(g8.precompute(ja, "A", num_moduli=nu,
                                          backend=backend),
                            g8.precompute(jb, "B", num_moduli=nu,
                                          backend=backend))
    _bits_equal(ref, g8.gemm(ja, jb, num_moduli=nu, backend=backend))
    qa, qb = _pre(a, "A", nu, backend), _pre(b, "B", nu, backend)
    assert isinstance(qa, gt.QuantizedOperand) and qa.dims == (24, 100)
    _bits_equal(gt.gemm_quantized(qa, qb), ref)
    _bits_equal(gt.gemm_quantized(qa, torch.from_numpy(b)), ref)
    _bits_equal(gt.gemm_quantized(a, qb), ref)
    with pytest.raises(TypeError):
        gt.gemm_quantized(a, b)


def test_precompute_skip_scal():
    """One A reused against two Bs (tests/test_hook.py's skip-scal case):
    each product equals gemm's bits."""
    rng = np.random.default_rng(102)
    a = rng.standard_normal((24, 64))
    qa = _pre(a, "A", 10)
    for _ in range(2):
        b = rng.standard_normal((64, 12))
        got = gt.gemm_quantized(qa, _pre(b, "B", 10), out_dtype=torch.float64)
        _bits_equal(got, g8.gemm(jnp.asarray(a), jnp.asarray(b),
                                 num_moduli=10))
        _bits_equal(got, gt.gemm(a, b, num_moduli=10, device="cpu"))


def test_precompute_fp8_matches_direct_f32_out():
    """FP8 planes are the port's own e4m3 stacks (JAX's CPU planes are
    (nu, 3, m, k) bf16), so the outputs are held: f32 operands, f32 and the
    default f64 output."""
    rng = np.random.default_rng(103)
    a = _phi(rng, (24, 128), dtype=np.float32)
    b = _phi(rng, (128, 20), dtype=np.float32)
    qa, qb = _pre(a, "A", 6, "FP8"), _pre(b, "B", 6, "FP8")
    assert qa.planes.shape == (18, 24, 128) and qb.planes.shape == (18, 128, 20)
    jqa = g8.precompute(jnp.asarray(a), "A", num_moduli=6, backend="FP8")
    jqb = g8.precompute(jnp.asarray(b), "B", num_moduli=6, backend="FP8")
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        _bits_equal(gt.gemm_quantized(qa, qb, out_dtype=dt),
                    g8.gemm_quantized(jqa, jqb, out_dtype=jdt))
    _bits_equal(gt.gemm_quantized(qa, qb, out_dtype=torch.float32),
                gt.gemm(a, b, num_moduli=6, backend="FP8", device="cpu"))


def test_precompute_int8_planes_and_round_trip():
    """INT8 planes and shifts equal the JAX operand's; a JAX operand's arrays
    brought over by quantized_from_numpy give the JAX product's bits."""
    rng = np.random.default_rng(104)
    a, b = _phi(rng, (20, 72)), _phi(rng, (72, 16))
    jqa = g8.precompute(jnp.asarray(a), "A", num_moduli=9)
    jqb = g8.precompute(jnp.asarray(b), "B", num_moduli=9)
    ref = g8.gemm_quantized(jqa, jqb)
    for q, j in ((_pre(a, "A", 9), jqa), (_pre(b, "B", 9), jqb)):
        np.testing.assert_array_equal(q.planes.numpy(), np.asarray(j.planes))
        np.testing.assert_array_equal(q.sft.numpy(), np.asarray(j.sft))
    qa, qb = (core.quantized_from_numpy(np.asarray(j.planes), np.asarray(j.sft),
                                        j.side, 9, "INT8", j.dims,
                                        device="cpu")
              for j in (jqa, jqb))
    _bits_equal(gt.gemm_quantized(qa, qb), ref)
    _bits_equal(gt.gemm_quantized(qa, b), ref)
    with pytest.raises(ValueError, match="INT8"):
        core.quantized_from_numpy(np.asarray(jqa.planes), np.asarray(jqa.sft),
                                  "A", 9, "FP8", jqa.dims, device="cpu")
    with pytest.raises(ValueError, match="planes"):
        core.quantized_from_numpy(np.asarray(jqa.planes), np.asarray(jqa.sft),
                                  "A", 8, "INT8", jqa.dims, device="cpu")


def test_precompute_errors_and_device_rule():
    a = np.ones((8, 16))
    qa, qb = _pre(a, "A", 8), _pre(a.T, "B", 8)
    with pytest.raises(ValueError, match="side"):
        _pre(a, "C", 8)
    with pytest.raises(ValueError, match="side A then side B"):
        gt.gemm_quantized(qb, qa)
    with pytest.raises(ValueError, match="different settings"):
        gt.gemm_quantized(qa, _pre(a.T, "B", 9))
    with pytest.raises(ValueError, match="cannot multiply"):
        gt.gemm_quantized(qa, _pre(np.ones((8, 4)), "B", 8))
    with pytest.raises(TypeError, match="float32 and float64"):
        _pre(a.astype(np.complex128), "A", 8)
    with pytest.raises(ValueError, match="k > 0"):
        _pre(np.ones((4, 0)), "A", 8)
    with pytest.raises(ValueError, match="out of range"):
        _pre(a.astype(np.float32), "A", 14)
    # the default device is the card: without one it raises, never a
    # silent CPU run
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gt.precompute(a, "A")
