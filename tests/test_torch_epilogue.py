"""gemmul8_tpu_torch epilogues bit-equal to gemmul8_tpu on the CPU:

  * the fused epilogue's plain version (csrc/epilogue.cu's twin):
    mod_reduce -> ff.reconstruct_scale_ff, fed an unwrapped C_hi and a
    K-chunked residue accumulator, f32 and f64 out; for f32 also equal to the
    Pallas fused_epilogue in interpret mode;
  * the "f64" epilogue crt_reconstruct -> inverse_scale, whose mul+add chains
    XLA contracts to FMAs under jit (pinned here with torch.addcmul).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu import core as jc, ff as jff, pallas_kernels as pk
from gemmul8_tpu import tables as jt
from gemmul8_tpu_torch import core as tc, ff as tff, kernels


def _inputs(seed, nu, m, n, chunked):
    """Realistic C_hi (int8 residue products summed over k=300) or a K-chunked
    accumulator (sums of three per-chunk residues in [0, p)), plus shifts."""
    rng = np.random.default_rng(seed)
    mods = jt.moduli("INT8")[:nu]
    if chunked:
        chi = np.stack([rng.integers(0, p, (3, m, n)).sum(0) for p in mods])
    else:
        a = rng.integers(-128, 128, (nu, m, 300))
        b = rng.integers(-128, 128, (nu, 300, n))
        chi = np.einsum("imk,ikn->imn", a, b)
    sft_a = rng.integers(-30, 50, m).astype(np.int32)
    sft_b = rng.integers(-30, 50, n).astype(np.int32)
    return chi.astype(np.int32), sft_a, sft_b


def _jax_ff(chi, sa, sb, nu, out_dtype):
    c_mid = jc.mod_reduce(jnp.asarray(chi), nu, "INT8")
    return np.asarray(jff.reconstruct_scale_ff(
        c_mid, jnp.asarray(sa), jnp.asarray(sb), nu, "INT8", out_dtype))


@pytest.mark.parametrize("out_dtype,nu", [(np.float32, 2), (np.float32, 8),
                                          (np.float32, 13), (np.float64, 8),
                                          (np.float64, 16), (np.float64, 20)])
@pytest.mark.parametrize("chunked", [False, True])
def test_fused_epilogue_plain_bit_equal(out_dtype, nu, chunked):
    chi, sa, sb = _inputs(nu, nu, 24, 40, chunked)
    tdt = torch.float64 if out_dtype == np.float64 else torch.float32
    got = kernels.fused_epilogue(torch.from_numpy(chi), torch.from_numpy(sa),
                                 torch.from_numpy(sb), nu, "INT8", tdt).numpy()
    ref = _jax_ff(chi, sa, sb, nu, out_dtype)
    assert got.dtype == ref.dtype and got.shape == (24, 40)
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("nu", [2, 8, 13])
def test_fused_epilogue_f32_equals_pallas_interpret(nu):
    chi, sa, sb = _inputs(100 + nu, nu, 128, 128, False)
    hi, lo = pk.fused_epilogue(jnp.asarray(chi), jnp.asarray(sa),
                               jnp.asarray(sb), nu, "INT8", 24)
    pallas = np.asarray(hi + lo)
    got = kernels.fused_epilogue_plain(torch.from_numpy(chi),
                                       torch.from_numpy(sa),
                                       torch.from_numpy(sb), nu, "INT8",
                                       torch.float32).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), pallas.view(np.uint32))


@pytest.mark.parametrize("nu", [8, 16, 20])
def test_crt_limbs_match_jax(nu):
    """The int32 multiply-add limbs equal the JAX f32-column-product limbs."""
    chi, _, _ = _inputs(200 + nu, nu, 16, 24, False)
    c_mid = jc.mod_reduce(jnp.asarray(chi), nu, "INT8")
    for out_bits in (24, 53):
        ref, base_j = jff.crt_limbs_matrix(c_mid, nu, "INT8", out_bits)
        got, base_t = tff.crt_limbs_matrix(torch.from_numpy(np.asarray(c_mid)),
                                           nu, "INT8", out_bits)
        assert base_t == base_j and len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_limb_plan_fits_the_kernel():
    for nu in range(2, 21):
        for out_bits in (24, 53):
            base, L, w16, p16, invp = tff.limb_plan(nu, "INT8", out_bits)
            assert 1 <= L <= kernels._MAX_L
            assert all(0 <= w < 1 << 16 for row in w16 for w in row)
            assert tff._crt_matrix_plan(nu, "INT8", out_bits)[0] == \
                jff._crt_matrix_plan(nu, "INT8", out_bits)[0]


# XLA:CPU contracts `x*y + z*w` to fma(x, y, z*w) under jit (the first
# product fuses); torch.addcmul computes the fused result.
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_xla_contraction_pattern_pinned(dtype):
    rng = np.random.default_rng(7)
    x, y, z, w = (rng.standard_normal(4099).astype(dtype) for _ in range(4))
    ref = np.asarray(jax.jit(lambda x, y, z, w: x * y + z * w)(x, y, z, w))
    X, Y, Z, W = map(torch.from_numpy, (x, y, z, w))
    np.testing.assert_array_equal(torch.addcmul(Z * W, X, Y).numpy(), ref)
    assert not np.array_equal((X * Y + Z * W).numpy(), ref)


@pytest.mark.parametrize("out_dtype,nu", [(np.float64, 5), (np.float64, 16),
                                          (np.float32, 8)])
def test_f64_epilogue_bit_equal_under_jit(out_dtype, nu):
    """crt_reconstruct -> inverse_scale as JAX's gemm runs it (jitted, so
    XLA contracts its chains): single f64 for P < 2^53 or f32 output,
    double-double above."""
    chi, sa, sb = _inputs(300 + nu, nu, 24, 40, False)
    c_mid = jc.mod_reduce(jnp.asarray(chi), nu, "INT8")

    @jax.jit
    def jax_f64(c_mid, sa, sb):
        t = jc.crt_reconstruct(c_mid, nu, "INT8", out_dtype)
        return jc.inverse_scale(t, sa, sb, out_dtype)

    ref = np.asarray(jax_f64(c_mid, jnp.asarray(sa), jnp.asarray(sb)))
    tdt = torch.float64 if out_dtype == np.float64 else torch.float32
    cm = torch.from_numpy(np.asarray(c_mid))
    got = tc.inverse_scale(tc.crt_reconstruct(cm, nu, "INT8", tdt),
                           torch.from_numpy(sa), torch.from_numpy(sb),
                           tdt).numpy()
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_mod_reduce_and_chunked_residue_acc():
    rng = np.random.default_rng(11)
    nu = 6
    a = rng.integers(-128, 128, (nu, 5, 40)).astype(np.int8)
    b = rng.integers(-128, 128, (nu, 40, 7)).astype(np.int8)
    chi_t = tc.residue_matmul(torch.from_numpy(a), torch.from_numpy(b))
    chi_j = jc.residue_matmul(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(chi_t.numpy(), np.asarray(chi_j))
    np.testing.assert_array_equal(tc.mod_reduce(chi_t, nu, "INT8").numpy(),
                                  np.asarray(jc.mod_reduce(chi_j, nu, "INT8")))
    old = tc.K_CHUNK
    try:                     # a 16-wide chunk splits k=40 into 16+16+8
        tc.K_CHUNK = 16
        acc = tc._chunked_residue_acc(torch.from_numpy(a), torch.from_numpy(b),
                                      nu, "INT8")
        ref = np.zeros((nu, 5, 7), np.int64)
        for s in (slice(0, 16), slice(16, 32), slice(32, 40)):
            prod = np.einsum("imk,ikn->imn", a[:, :, s].astype(np.int64),
                             b[:, s].astype(np.int64))
            ref += np.stack([prod[i] % p
                             for i, p in enumerate(jt.moduli("INT8")[:nu])])
        np.testing.assert_array_equal(acc.numpy(), ref)
        np.testing.assert_array_equal(
            tc.residue_gemm(torch.from_numpy(a), torch.from_numpy(b), nu,
                            "INT8").numpy(),
            np.asarray(jc.mod_reduce(chi_j, nu, "INT8")))
    finally:
        tc.K_CHUNK = old


def test_epilogue_wrapper_cpu_takes_plain_version():
    kernels.reset_launches()
    chi, sa, sb = _inputs(1, 8, 8, 8, False)
    args = (torch.from_numpy(chi), torch.from_numpy(sa), torch.from_numpy(sb),
            8, "INT8", torch.float64)
    assert torch.equal(kernels.fused_epilogue(*args),
                       kernels.fused_epilogue_plain(*args))
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
