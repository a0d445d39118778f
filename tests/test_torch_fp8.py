"""gemmul8_tpu_torch's FP8 backend, piece by piece, bit-equal to gemmul8_tpu on
the CPU:

  * fp8.split_planes, _gemm_stack and lhs_to_rhs_stack (e4m3 planes against
    JAX's bf16 carriers, value for value);
  * the FP8 encoder's plain version (csrc/encode_fp8.cu's twin) against
    fp8._gemm_stack(fp8.split_planes(residues_wrapped)), f32 and f64, both
    sides, the edge corpus included, and for f32 against the Pallas
    encode_planes_fp8_tiles in interpret mode;
  * fp8.residue_matmul_fp8's CPU path against fp8._batched_dot;
  * the FP8 epilogue's plain version (csrc/epilogue_fp8.cu's twin) against
    fp8._reassemble -> ff.reconstruct_scale_ff, and for f32 against the
    Pallas fused_epilogue_fp8 in interpret mode;
  * the real epilogue's plain version on FP8 K-chunked residue sums (whose
    residues do not fit int8) and residue_gemm_fp8 across the 2^16 chunk.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu import ff as jff, fp8 as jf, pallas_kernels as pk
from gemmul8_tpu import quantize as jq, tables as jt
from gemmul8_tpu_torch import core as tc, fp8 as tf, kernels
from gemmul8_tpu_torch import quantize as tq

MODS = jt.moduli("FP8")


def _residues(seed, nu, r, c):
    """Wrapped FP8 residues in [-p/2, p/2), each plane's first row holding
    its extremes -p/2 and p/2 - 1."""
    rng = np.random.default_rng(seed)
    res = np.stack([rng.integers(-(p // 2), p - p // 2, (r, c))
                    for p in MODS[:nu]])
    for i, p in enumerate(MODS[:nu]):
        res[i, 0, ::2] = -(p // 2)
        res[i, 0, 1::2] = p - p // 2 - 1
    return res.astype(np.int32)


def _f32(x):
    """A plane stack as f32 numpy (e4m3 and bf16 both hold the values
    exactly)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("nu", [2, 6, 9, 13, 20])
def test_split_and_stacks_equal_jax(nu):
    res = _residues(nu, nu, 16, 24)
    planes = tf.split_planes(torch.from_numpy(res), nu)
    ref = jf.split_planes(jnp.asarray(res), nu)
    assert planes.dtype == torch.float8_e4m3fn and planes.shape == (nu, 3, 16, 24)
    np.testing.assert_array_equal(_f32(planes), _f32(ref))
    # error-free, every value in [-16, 16]
    x, y, z = (_f32(planes)[:, s].astype(np.int64) for s in range(3))
    assert np.abs(_f32(planes)).max() <= 16
    for i, p in enumerate(MODS[:nu]):
        if i < jt.NOT_KARATSUBA:
            q = tf._sqrt_moduli()[i]
            assert q * q == p
            np.testing.assert_array_equal(q * x[i] + y[i], res[i])
        else:
            np.testing.assert_array_equal(16 * x[i] + y[i], res[i])
            np.testing.assert_array_equal(z[i], x[i] + y[i])
    for side in ("lhs", "rhs"):
        stack = tf._gemm_stack(planes, nu, side)
        np.testing.assert_array_equal(_f32(stack),
                                      _f32(jf._gemm_stack(ref, nu, side)))
    lhs = tf._gemm_stack(planes, nu, "lhs")
    np.testing.assert_array_equal(
        _f32(tf.lhs_to_rhs_stack(lhs, nu)),
        _f32(jf.lhs_to_rhs_stack(jf._gemm_stack(ref, nu, "lhs"), nu)))
    np.testing.assert_array_equal(_f32(tf.lhs_to_rhs_stack(lhs, nu)),
                                  _f32(tf._gemm_stack(planes, nu, "rhs")))


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


def _encode_both(x, nu, scale_axis):
    """(the port's stack from the kernel wrapper on the CPU, JAX's stack of
    the same residues, the JAX shifts)."""
    xj = jnp.asarray(x)
    sft = jq.shift_fast(xj, nu, "FP8", 1 - scale_axis)
    side = "lhs" if scale_axis == 0 else "rhs"
    res = jq.residues_wrapped(xj, sft, scale_axis, nu, "FP8")
    ref = jf._gemm_stack(jf.split_planes(res, nu), nu, side)
    got = kernels.encode_planes_fp8(torch.from_numpy(x),
                                    torch.from_numpy(np.array(sft)),
                                    scale_axis, nu)
    assert got.dtype == torch.float8_e4m3fn
    assert got.shape == (3 * nu, *x.shape)
    return _f32(got), _f32(ref), np.asarray(sft)


@pytest.mark.parametrize("dtype,nu", [(np.float32, 7), (np.float32, 13),
                                      (np.float64, 14), (np.float64, 20)])
@pytest.mark.parametrize("scale_axis", [0, 1])
def test_encode_fp8_plain_bit_equal(dtype, nu, scale_axis):
    got, ref, _ = _encode_both(_operand(40 + nu, (40, 72), dtype), nu,
                               scale_axis)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("scale_axis", [0, 1])
def test_encode_fp8_edge_corpus(dtype, scale_axis):
    got, ref, _ = _encode_both(_edge(dtype), 13, scale_axis)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("nu", [6, 13])
@pytest.mark.parametrize("scale_axis", [0, 1])
def test_encode_fp8_f32_equals_pallas_interpret(nu, scale_axis):
    """For f32 (one component) the port's FP8 encoder also equals the Pallas
    kernel it replaces, run in interpret mode."""
    x = _operand(50 + nu, (64, 256), np.float32)
    got, _, sft = _encode_both(x, nu, scale_axis)
    pallas = pk.encode_planes_fp8_tiles(jnp.asarray(x), None,
                                        jnp.asarray(sft), scale_axis, nu)
    np.testing.assert_array_equal(got, _f32(pallas))


def _planes(seed, n_planes, r, c):
    rng = np.random.default_rng(seed)
    return rng.integers(-16, 17, (n_planes, r, c)).astype(np.float32)


def test_residue_matmul_fp8_equals_batched_dot():
    a = _planes(1, 21, 24, 300)
    b = _planes(2, 21, 300, 40)
    a[:, 0] = 16                               # a row of +-2^8 products
    b[:, :, 0] = -16
    got = tf.residue_matmul_fp8(torch.from_numpy(a).to(torch.float8_e4m3fn),
                                torch.from_numpy(b).to(torch.float8_e4m3fn))
    ref = jf._batched_dot(jnp.asarray(a, jnp.bfloat16),
                          jnp.asarray(b, jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        got.numpy(), np.einsum("imk,ikn->imn", a.astype(np.int64),
                               b.astype(np.int64)))


def _lane_products(seed, nu, m, n, source):
    """(3nu, m, n) f32 exact integer lane products: of random planes over
    k=300, or any integer of |C| <= 2^24 (the K-chunk bound)."""
    if source == "products":
        a = _planes(seed, 3 * nu, m, 300)
        b = _planes(seed + 1, 3 * nu, 300, n)
        return np.einsum("imk,ikn->imn", a, b).astype(np.float32)
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << 24), (1 << 24) + 1,
                        (3 * nu, m, n)).astype(np.float32)


def _shifts(seed, m, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(-30, 50, m).astype(np.int32),
            rng.integers(-30, 50, n).astype(np.int32))


@pytest.mark.parametrize("out_dtype,nu", [(np.float32, 2), (np.float32, 7),
                                          (np.float32, 13), (np.float64, 7),
                                          (np.float64, 14), (np.float64, 20)])
@pytest.mark.parametrize("source", ["products", "extreme"])
def test_fused_epilogue_fp8_plain_bit_equal(out_dtype, nu, source):
    c3 = _lane_products(nu, nu, 24, 40, source)
    sa, sb = _shifts(nu, 24, 40)
    tdt = torch.float64 if out_dtype == np.float64 else torch.float32
    got = kernels.fused_epilogue_fp8(torch.from_numpy(c3), torch.from_numpy(sa),
                                     torch.from_numpy(sb), nu, tdt).numpy()
    c_mid = jf._reassemble(jnp.asarray(c3).astype(jnp.int32),
                           nu).astype(jnp.int16)
    ref = np.asarray(jff.reconstruct_scale_ff(c_mid, jnp.asarray(sa),
                                              jnp.asarray(sb), nu, "FP8",
                                              out_dtype))
    assert got.dtype == ref.dtype and got.shape == (24, 40)
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))
    res = tf._reassemble(torch.from_numpy(c3).to(torch.int32), nu)
    np.testing.assert_array_equal(res.numpy(), np.asarray(c_mid))


@pytest.mark.parametrize("nu", [2, 7, 13])
def test_fused_epilogue_fp8_f32_equals_pallas_interpret(nu):
    c3 = _lane_products(60 + nu, nu, 128, 128, "products")
    sa, sb = _shifts(60 + nu, 128, 128)
    hi, lo = pk.fused_epilogue_fp8(jnp.asarray(c3), jnp.asarray(sa),
                                   jnp.asarray(sb), nu, 24)
    pallas = np.asarray(hi + lo)
    got = kernels.fused_epilogue_fp8_plain(torch.from_numpy(c3),
                                           torch.from_numpy(sa),
                                           torch.from_numpy(sb), nu,
                                           torch.float32).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), pallas.view(np.uint32))


def _chunk_sums(seed, nu, m, n):
    """K-chunked FP8 residue sums: three per-chunk wrapped residues."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(-(p // 2), p - p // 2, (3, m, n)).sum(0)
                     for p in MODS[:nu]]).astype(np.int32)


@pytest.mark.parametrize("out_dtype,nu", [(np.float32, 7), (np.float64, 14),
                                          (np.float64, 20)])
def test_fused_epilogue_plain_on_fp8_chunk_sums(out_dtype, nu):
    """The real epilogue on the FP8 plan keeps int16 residues: an int8 cast
    of residues up to +-544 would wrap them (the wrapped residues checked
    here exceed int8)."""
    acc = _chunk_sums(70 + nu, nu, 24, 40)
    sa, sb = _shifts(70 + nu, 24, 40)
    mids = tc.mod_reduce(torch.from_numpy(acc), nu, "FP8")
    ref_mid = np.stack([np.where(2 * (acc[i] % p) >= p, acc[i] % p - p,
                                 acc[i] % p) for i, p in enumerate(MODS[:nu])])
    assert mids.dtype == torch.int16 and np.abs(ref_mid).max() > 127
    np.testing.assert_array_equal(mids.numpy(), ref_mid)
    tdt = torch.float64 if out_dtype == np.float64 else torch.float32
    got = kernels.fused_epilogue(torch.from_numpy(acc), torch.from_numpy(sa),
                                 torch.from_numpy(sb), nu, "FP8", tdt).numpy()
    ref = np.asarray(jff.reconstruct_scale_ff(
        jnp.asarray(ref_mid.astype(np.int16)), jnp.asarray(sa),
        jnp.asarray(sb), nu, "FP8", out_dtype))
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_fused_epilogue_fp8_chunk_sums_equal_pallas_interpret():
    """f32 out: the real epilogue's plain version on FP8 chunk sums equals
    the Pallas fused_epilogue on the FP8 plan (its shift-20 wrap)."""
    nu = 9
    acc = _chunk_sums(80, nu, 128, 128)
    sa, sb = _shifts(80, 128, 128)
    hi, lo = pk.fused_epilogue(jnp.asarray(acc), jnp.asarray(sa),
                               jnp.asarray(sb), nu, "FP8", 24)
    got = kernels.fused_epilogue_plain(torch.from_numpy(acc),
                                       torch.from_numpy(sa),
                                       torch.from_numpy(sb), nu, "FP8",
                                       torch.float32).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.asarray(hi + lo).view(np.uint32))


def test_residue_gemm_fp8_across_the_k_chunk():
    """k = 2^16 + 512: two chunks summed in residue space, equal to JAX's
    residue_gemm_fp8 (and its accumulator to JAX's)."""
    nu, m, n, k = 7, 4, 8, (1 << 16) + 512
    rng = np.random.default_rng(90)
    a = rng.integers(-16, 17, (3 * nu, m, k)).astype(np.float32)
    b = rng.integers(-16, 17, (3 * nu, k, n)).astype(np.float32)
    a[:, 0] = 16                         # partial sums out to 2^24 per chunk
    b[:, :, 0] = 16
    a3 = torch.from_numpy(a).to(torch.float8_e4m3fn)
    b3 = torch.from_numpy(b).to(torch.float8_e4m3fn)
    aj, bj = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    np.testing.assert_array_equal(
        tf._chunked_residue_acc(a3, b3, nu).numpy(),
        np.asarray(jf._chunked_residue_acc(aj, bj, nu)))
    got = tf.residue_gemm_fp8(a3, b3, nu)
    ref = np.asarray(jf.residue_gemm_fp8(aj, bj, nu))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fp8_wrappers_cpu_take_plain_versions():
    kernels.reset_launches()
    x = torch.from_numpy(_operand(5, (16, 24), np.float64))
    sft = tq.shift_fast(x, 9, "FP8", 1)
    got = kernels.encode_planes_fp8(x, sft, 0, 9)
    assert torch.equal(got.view(torch.uint8),
                       kernels.encode_planes_fp8_plain(x, sft, 0, 9)
                       .view(torch.uint8))
    c3 = torch.from_numpy(_lane_products(6, 9, 8, 8, "products"))
    sa, sb = (torch.from_numpy(s) for s in _shifts(6, 8, 8))
    assert torch.equal(kernels.fused_epilogue_fp8(c3, sa, sb, 9, torch.float64),
                       kernels.fused_epilogue_fp8_plain(c3, sa, sb, 9,
                                                        torch.float64))
    assert not any(kernels.LAUNCHES.values())


def test_fp8_plans_fit_the_kernels():
    """Every FP8 plan fits the kernels' fixed limits, and the integer
    headroom holds: the encoder's limb dot stays below 2^31 and each CRT
    multiply-add term below 2^26."""
    r_max = max(MODS) // 2 + 1
    assert r_max * 65535 < 1 << 26              # |r * w16| in the CRT limbs
    for nu in range(2, 21):
        nl = tq.n_limbs(nu, "FP8")
        assert 2 <= nl <= kernels._MAX_NL
        assert nl * (1 << 19) * r_max < 1 << 31      # the encoder's limb dot
        enc = kernels._encode_plan_fp8(nu, "rhs")
        assert [enc.sq[i] for i in range(nu)] == \
            [int(round(np.sqrt(p))) if i < jt.NOT_KARATSUBA else 0
             for i, p in enumerate(MODS[:nu])]
        order = tf.slot_order(nu, "rhs")
        for i in range(nu):
            x, y, z = enc.plane[i]
            assert order[x] == (i, 0) and order[y] == (i, 1)
            assert order[z] == (i, 2 if i >= jt.NOT_KARATSUBA else 1)
        for out_bits in (24, 53):
            plan = kernels._epilogue_plan(nu, "FP8", out_bits)
            assert 1 <= plan.L <= kernels._MAX_L
            assert max(plan.w16[i][li] for i in range(nu)
                       for li in range(plan.L)) < 1 << 16
