"""gemmul8_tpu_torch.quantize: shifts and the residue-plane encoder (the
plain version of csrc/encode.cu) bit-equal to gemmul8_tpu on the CPU.

The same numpy inputs go to both packages. Every encode test feeds the JAX
shift vector to the port, so a last-ulp log2 difference in the shifts can
neither hide nor fake a fault in the encoder."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu import pallas_kernels as pk
from gemmul8_tpu import quantize as jq
from gemmul8_tpu_torch import kernels, quantize as tq

DTYPES = [np.float32, np.float64]


def _operand(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp(2.0 * rng.standard_normal(shape))
    x[3] = 0.0                                           # a zero row
    x[:, 5] = 0.0                                        # and a zero column
    return x.astype(dtype)


def _edge(dtype):
    """tests/test_pallas.py's edge corpus: zero rows, 2^-120, -2^100, pi."""
    x = np.zeros((32, 128))
    x[1] = 2.0 ** -120
    x[2] = -(2.0 ** 100)
    x[3, ::2] = np.pi
    return x.astype(dtype)


def test_pow2_and_pow2_scale_exact():
    e = np.arange(-140, 140, dtype=np.int32)
    for dt, tdt in ((np.float32, torch.float32), (np.float64, torch.float64)):
        ok = (e >= -126) & (e <= 127)
        got = tq.pow2(torch.from_numpy(e[ok]), tdt).numpy()
        np.testing.assert_array_equal(got, np.exp2(e[ok].astype(np.float64)).astype(dt))
    x = np.linspace(-3.0, 3.0, e.size)
    # outputs stay normal: XLA:CPU flushes subnormal results to zero
    sft = np.linspace(-1000, 1000, e.size).astype(np.int32)
    got = tq.pow2_scale(torch.from_numpy(x), torch.from_numpy(sft)).numpy()
    ref = np.asarray(jq.pow2_scale(jnp.asarray(x), jnp.asarray(sft)))
    np.testing.assert_array_equal(got.view(np.uint64), ref.view(np.uint64))


@pytest.mark.parametrize("dtype", DTYPES)
def test_decompose_and_ilogb(dtype):
    x = _operand(0, (16, 64), dtype)
    x[0, :4] = [2.0 ** -120, 3e38 if dtype == np.float32 else 1e300, -1e-20, 1.0]
    xt = torch.from_numpy(x)
    comps_t = tq.f32_components(xt, 3)
    comps_j = jq.f32_components(jnp.asarray(x), 3)
    assert len(comps_t) == len(comps_j)
    for ct, cj in zip(comps_t, comps_j):
        np.testing.assert_array_equal(ct.numpy().view(np.uint32),
                                      np.asarray(cj).view(np.uint32))
        for got, ref in zip(tq.f32_decompose(ct), jq.f32_decompose(cj)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    pos = np.abs(x) + (x == 0)
    np.testing.assert_array_equal(tq.ilogb(torch.from_numpy(pos)).numpy(),
                                  np.asarray(jq.ilogb(jnp.asarray(pos))))


def test_subnormal_components_kept():
    """The port keeps IEEE subnormals, as numpy and the card do; XLA:CPU
    flushes them to zero, so JAX on the CPU differs for such inputs."""
    x = np.array([2.0 ** -130, -(2.0 ** -140), 2.0 ** -100 + 2.0 ** -140])
    comps = tq.f32_components(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(comps[0].numpy(), x.astype(np.float32))
    assert comps[1].numpy()[2] == np.float32(2.0 ** -140)


# Shift vectors: the f32 log2 and row sums of the two frameworks may differ
# in the last bit, so a row within about an ulp of an integer can floor the
# other way. These seeds and shapes (seed 0..3, 48x200 and 200x40 operands,
# both variants, nu 4/8/16/20) agree exactly.
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["reference", "invariant"])
@pytest.mark.parametrize("reduce_axis", [0, 1])
def test_shift_fast_equal(dtype, variant, reduce_axis):
    for seed, nu in ((0, 4), (1, 8), (2, 16), (3, 20)):
        if dtype == np.float32 and nu > 13:
            continue
        x = _operand(seed, (48, 200) if reduce_axis else (200, 40), dtype)
        if dtype == np.float64:
            x[7] *= 1e200           # rows past f32's range take the prescale
        got = tq.shift_fast(torch.from_numpy(x), nu, "INT8", reduce_axis,
                            variant).numpy()
        ref = np.asarray(jq.shift_fast(jnp.asarray(x), nu, "INT8",
                                       reduce_axis, variant))
        np.testing.assert_array_equal(got, ref)
    got = tq.shift_fast(torch.from_numpy(_edge(dtype)), 10, "INT8", 1).numpy()
    ref = np.asarray(jq.shift_fast(jnp.asarray(_edge(dtype)), 10, "INT8", 1))
    np.testing.assert_array_equal(got, ref)


def _encode_both(x, nu, scale_axis):
    """(port int8 planes via the kernel wrapper on CPU, JAX residues)."""
    xj = jnp.asarray(x)
    sft = jq.shift_fast(xj, nu, "INT8", 1 - scale_axis)
    ref = np.asarray(jq.residues_wrapped(xj, sft, scale_axis, nu, "INT8"))
    sft_t = torch.from_numpy(np.asarray(sft))
    res = tq.residues_wrapped(torch.from_numpy(x), sft_t, scale_axis, nu,
                              "INT8").numpy()
    np.testing.assert_array_equal(res, ref)
    planes = kernels.encode_planes(torch.from_numpy(x), sft_t, scale_axis,
                                   nu, "INT8")
    return planes.numpy(), ref.astype(np.int8), np.asarray(sft)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nu", [2, 8, 16, 20])
@pytest.mark.parametrize("scale_axis", [0, 1])
def test_encode_bit_equal(dtype, nu, scale_axis):
    x = _operand(10 + nu, (40, 72), dtype)
    got, ref, _ = _encode_both(x, nu, scale_axis)
    assert got.dtype == np.int8 and got.shape == (nu, 40, 72)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale_axis", [0, 1])
def test_encode_edge_corpus(dtype, scale_axis):
    got, ref, _ = _encode_both(_edge(dtype), 10, scale_axis)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("nu", [8, 13])
@pytest.mark.parametrize("scale_axis", [0, 1])
def test_encode_f32_equals_pallas_interpret(nu, scale_axis):
    """For f32 (one component) the port's encoder also equals the Pallas
    kernel it replaces, run in interpret mode."""
    x = _operand(30 + nu, (64, 256), np.float32)
    got, _, sft = _encode_both(x, nu, scale_axis)
    pallas = np.asarray(pk.encode_planes_tiles(jnp.asarray(x), None,
                                               jnp.asarray(sft), scale_axis,
                                               nu, "INT8"))
    np.testing.assert_array_equal(got, pallas)


def test_encode_wrapper_cpu_takes_plain_version():
    kernels.reset_launches()
    x = torch.from_numpy(_operand(5, (16, 24), np.float64))
    sft = tq.shift_fast(x, 8, "INT8", 1)
    got = kernels.encode_planes(x, sft, 0, 8, "INT8")
    ref = kernels.encode_planes_plain(x, sft, 0, 8, "INT8")
    assert torch.equal(got, ref)
    assert kernels.LAUNCHES == {"shift_fast": 0, "extract_ub": 0,
                                "encode_planes": 0, "encode_lanes": 0,
                                "encode_planes_fp8": 0,
                                "encode_lanes_fp8": 0, "fused_epilogue": 0,
                                "fused_epilogue_ab": 0,
                                "fused_epilogue_fp8": 0, "reassemble_fp8": 0,
                                "fused_epilogue_complex": 0,
                                "fused_recombine_3m": 0,
                                "matmul_i8_wgmma_kloop": 0,
                                "matmul_i8_wgmma_astat": 0,
                                "transpose_i8": 0,
                                "fused_epilogue_mxu": 0}


def test_limb_counts_fit_the_kernel():
    for nu in range(2, 21):
        assert 2 <= tq.n_limbs(nu, "INT8") <= kernels._MAX_NL
