"""The port's tensor-core CRT epilogue (kernels.fused_epilogue_mxu,
csrc/epilogue_mxu.cu's plain version) on the CPU:

  * bit-equal to tools/probe_epilogue.py's fused_epilogue_mxu (interpreted
    on the CPU) where the probe's descale stays in f32's range;
  * bit-equal to the port's K2 pair (core.mod_reduce -> ff.crt_limbs_matrix
    -> ff.descale_pair) for every shift, and to the JAX package's shipped
    Pallas fused_epilogue where the probe's half-split descale fails.
"""
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu import pallas_kernels as pk
from gemmul8_tpu_torch import kernels
from gemmul8_tpu_torch.probes import epilogue

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_probe_epilogue():
    bench = os.path.join(_ROOT, "benchmarks")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    spec = importlib.util.spec_from_file_location(
        "_tool_probe_epilogue",
        os.path.join(_ROOT, "tools", "probe_epilogue.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


probe_epilogue = _load_probe_epilogue()
M = N = 256          # the probe's blocks are 128 x 256


def _inputs(seed, nu, shifts, m=M, n=N):
    """C_hi uniform in [-2^30, 2^30) (the probe's), shifts in [lo, hi)."""
    rng = np.random.default_rng(seed)
    c_hi = rng.integers(-2 ** 30, 2 ** 30, (nu, m, n)).astype(np.int32)
    lo, hi = shifts
    return (c_hi, rng.integers(lo, hi, m).astype(np.int32),
            rng.integers(lo, hi, n).astype(np.int32))


def _port(c_hi, sa, sb, nu, out_bits):
    hi, lo = kernels.fused_epilogue_mxu(torch.from_numpy(c_hi),
                                        torch.from_numpy(sa),
                                        torch.from_numpy(sb), nu, "INT8",
                                        out_bits)
    assert hi.dtype == lo.dtype == torch.float32
    assert hi.shape == lo.shape == c_hi.shape[1:]
    return hi.numpy(), lo.numpy()


def _probe(c_hi, sa, sb, nu, out_bits):
    hi, lo = probe_epilogue.fused_epilogue_mxu(
        jnp.asarray(c_hi), jnp.asarray(sa), jnp.asarray(sb), nu, "INT8",
        out_bits)
    return np.asarray(hi), np.asarray(lo)


def _bits_equal(x, y):
    return np.array_equal(x.view(np.uint32), y.view(np.uint32))


@pytest.mark.parametrize("nu,shifts,out_bits", [
    (8, (0, 1), 53), (8, (30, 60), 24), (16, (0, 1), 53), (16, (30, 60), 53),
    (16, (30, 60), 24), (20, (60, 90), 53), (20, (60, 90), 24)])
def test_k8_bit_equal_to_probe_epilogue(nu, shifts, out_bits):
    c_hi, sa, sb = _inputs(nu + shifts[0], nu, shifts)
    got = _port(c_hi, sa, sb, nu, out_bits)
    ref = _probe(c_hi, sa, sb, nu, out_bits)
    assert np.isfinite(got[0]).any()
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.view(np.uint32), r.view(np.uint32))


@pytest.mark.parametrize("nu,shifts", [(8, (100, 140)), (16, (-20, 20)),
                                       (16, (130, 160)), (20, (0, 1)),
                                       (16, (253, 378))])
@pytest.mark.parametrize("out_bits", [53, 24])
def test_k8_plain_equals_k2_pair(nu, shifts, out_bits):
    """Every shift, f32 overflow and underflow included: the same pair as
    K2's plain steps; at 24 bits hi + lo is K2's f32 output."""
    c_hi, sa, sb = (torch.from_numpy(x) for x in _inputs(
        3 * nu + out_bits, nu, shifts, m=24, n=40))
    hi, lo = kernels.fused_epilogue_mxu_plain(c_hi, sa, sb, nu, "INT8",
                                              out_bits)
    ref_hi, ref_lo = epilogue.k2_pair_plain(c_hi, sa, sb, nu, out_bits)
    assert _bits_equal(hi.numpy(), ref_hi.numpy())
    assert _bits_equal(lo.numpy(), ref_lo.numpy())
    if out_bits == 24:
        k2 = kernels.fused_epilogue_plain(c_hi, sa, sb, nu, "INT8",
                                          torch.float32)
        assert _bits_equal((hi + lo).numpy(), k2.numpy())


def test_probe_half_split_descale_fault():
    """tools/probe_epilogue.py:75-80 splits 2^-sft in two halves, whose
    exponents leave f32's range past |sft| = 252 and assemble garbage; the
    library's K2 (pallas_kernels.py:292-306) splits it in three. The port's
    K8 takes the three factors: past 252 it equals the shipped K2 pair and
    differs from the probe's."""
    nu = 16
    c_hi, sa, sb = _inputs(7, nu, (253, 300))
    got = _port(c_hi, sa, sb, nu, 53)
    k2 = pk.fused_epilogue(jnp.asarray(c_hi), jnp.asarray(sa),
                           jnp.asarray(sb), nu, "INT8", 53)
    for g, r in zip(got, k2):
        np.testing.assert_array_equal(g.view(np.uint32),
                                      np.asarray(r).view(np.uint32))
    probe = _probe(c_hi, sa, sb, nu, 53)
    assert not _bits_equal(got[0], probe[0])


def test_k8_refuses_fp8_and_bad_out_bits():
    c_hi, sa, sb = (torch.from_numpy(x) for x in _inputs(9, 4, (0, 1), 8, 8))
    for fn in (kernels.fused_epilogue_mxu, kernels.fused_epilogue_mxu_plain):
        with pytest.raises(ValueError, match="INT8"):
            fn(c_hi, sa, sb, 4, "FP8", 53)
    with pytest.raises(ValueError, match="out_bits"):
        kernels.fused_epilogue_mxu(c_hi, sa, sb, 4, "INT8", 32)


def test_k8_cpu_takes_plain_version_and_plan_fits():
    kernels.reset_launches()
    c_hi, sa, sb = (torch.from_numpy(x) for x in _inputs(11, 20, (60, 90),
                                                         16, 24))
    got = kernels.fused_epilogue_mxu(c_hi, sa, sb, 20, "INT8", 53)
    ref = kernels.fused_epilogue_mxu_plain(c_hi, sa, sb, 20, "INT8", 53)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert not any(kernels.LAUNCHES.values())
    for nu in range(1, 21):
        for out_bits in (24, 53):
            plan = kernels._epilogue_plan_mxu(nu, "INT8", out_bits)
            assert 1 <= plan.n_cols <= 2 * plan.crt.L <= 2 * kernels._MAX_L
            assert plan.n_cols <= kernels._MXU_COLS


def test_probe_epilogue_main_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe runs on it (chip_smoke.py)")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        epilogue.main()
