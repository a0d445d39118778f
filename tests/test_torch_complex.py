"""The complex (3M) path's pieces in gemmul8_tpu_torch bit-equal to
gemmul8_tpu on the CPU: the shared shift (fast and robust), the three lane
plane sets of each side (conj on and off) and their layout, the residue-space
recombine, herk's rhs lanes, and the plain versions of the two complex
epilogue kernels (csrc/complex.cu's twins) -- against the Pallas kernels in
interpret mode where those emit the port's output, and against the JAX
unfused chain where they do not (f64 output). Plus the identities the split
path rests on: the recombine kernel followed by two real epilogues equals the
single complex epilogue, and the real epilogue reads int8 residues as it
reads the same values in int32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu import complex_gemm as jcg, core as jc, ff as jff
from gemmul8_tpu import pallas_kernels as pk
from gemmul8_tpu import tables as jt
from gemmul8_tpu_torch import complex_gemm as tcg, kernels


def _planes(seed, m, n, dtype):
    """A complex operand's (re, im) with a wide spread of magnitudes, and
    some zero rows and columns."""
    rng = np.random.default_rng(seed)
    re, im = (rng.standard_normal((m, n)) * np.exp(2 * rng.standard_normal((m, n)))
              for _ in range(2))
    re[1] = im[1] = 0.0
    re[:, 2] = 0.0
    return re.astype(dtype), im.astype(dtype)


def _lane_products(seed, nu, m, n, chunked):
    """(3nu, m, n) int32 lane products Crr | Cii | Crii: sums of int8 residue
    products over k=300, or K-chunked sums of three per-chunk residues."""
    rng = np.random.default_rng(seed)
    mods = jt.moduli("INT8")[:nu]
    if chunked:
        chi = np.concatenate([np.stack([rng.integers(0, p, (3, m, n)).sum(0)
                                        for p in mods]) for _ in range(3)])
    else:
        a = rng.integers(-128, 128, (3 * nu, m, 300))
        b = rng.integers(-128, 128, (3 * nu, 300, n))
        chi = np.einsum("imk,ikn->imn", a, b)
    sft_a = rng.integers(-30, 50, m).astype(np.int32)
    sft_b = rng.integers(-30, 50, n).astype(np.int32)
    return chi.astype(np.int32), sft_a, sft_b


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _bits_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("variant", ["reference", "invariant"])
def test_shift_complex_fast_bit_equal(dtype, variant):
    re, im = _planes(1, 30, 70, dtype)
    re[3] *= 1e-30                           # the scales robust mode is for
    im[4] *= 1e25
    for axis in (1, 0):
        ref = jcg._shift_complex_fast(jnp.asarray(re), jnp.asarray(im), 13,
                                      "INT8", axis, variant=variant)
        got = tcg._shift_complex_fast(*_t(re, im), 13, "INT8", axis,
                                      variant=variant)
        _bits_equal(got, ref)


@pytest.mark.parametrize("dtype,nu", [(np.float64, 16), (np.float32, 8)])
@pytest.mark.parametrize("conj", [False, True])
def test_quantize_complex_lanes_bit_equal(dtype, nu, conj):
    re, im = _planes(2, 24, 40, dtype)
    for axis in (0, 1):
        sft = tcg._shift_complex_fast(*_t(re, im), nu, "INT8", 1 - axis)
        ref = jcg._quantize_complex(jnp.asarray(re), jnp.asarray(im),
                                    jnp.asarray(sft.numpy()), axis, nu,
                                    "INT8", conj)
        got = tcg._quantize_complex(*_t(re, im), sft, axis, nu, "INT8", conj)
        _bits_equal(got.contiguous(), ref)


def test_quantize_complex_b_lanes_are_k_contiguous():
    """B's (3, nu, k, n) lanes lie on (3, nu, n, k) storage, so that the
    3nu-plane stack the int8 product reads is a view with each plane
    k-contiguous; A's lanes are row-major."""
    nu, k, n = 5, 40, 24
    re, im = _planes(3, k, n, np.float64)
    sft = tcg._shift_complex_fast(*_t(re, im), nu, "INT8", 0)
    pb = tcg._quantize_complex(*_t(re, im), sft, 1, nu, "INT8", False)
    assert pb.shape == (3, nu, k, n)
    assert pb.stride() == (nu * n * k, n * k, 1, k)
    flat = pb.reshape(3 * nu, k, n)
    assert flat.data_ptr() == pb.data_ptr() and flat.stride() == (n * k, 1, k)
    pa = tcg._quantize_complex(*_t(re.T.copy(), im.T.copy()), sft, 0, nu,
                               "INT8", False)
    assert pa.is_contiguous()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nu", [2, 8, 16])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("conj", [False, True])
def test_encode_planes_lanes_bit_equal(dtype, nu, axis, conj):
    """kernels.encode_planes with im= (the lane encoder's route, and on the
    CPU its plain version) gives the JAX package's three lanes."""
    re, im = _planes(7 + nu, 20, 36, dtype)
    sft = tcg._shift_complex_fast(*_t(re, im), nu, "INT8", 1 - axis)
    ref = jcg._quantize_complex(jnp.asarray(re), jnp.asarray(im),
                                jnp.asarray(sft.numpy()), axis, nu, "INT8",
                                conj)
    x, y = _t(re, im)
    got = kernels.encode_planes(x, sft, axis, nu, "INT8", im=y, conj=conj)
    assert got.shape == (3, nu, 20, 36)
    _bits_equal(got, ref)
    _bits_equal(kernels.encode_planes_plain(x, sft, axis, nu, "INT8", y,
                                            conj), ref)


def _meta_lane_args(axis, fault):
    """encode_planes(..., im=, out=) arguments on the meta device, sound but
    for `fault`."""
    nu, rows, cols = 4, 16, 24
    x = torch.empty((rows, cols), dtype=torch.float64, device="meta")
    im = torch.empty_like(x)
    sft = torch.empty(x.shape[axis], dtype=torch.int32, device="meta")
    out = kernels.plane_buffer((3, nu), rows, cols, axis, "meta")
    if fault == "im shape":
        im = torch.empty((rows, cols + 4), dtype=x.dtype, device="meta")
    elif fault == "im dtype":
        im = torch.empty_like(x, dtype=torch.float32)
    elif fault == "im contiguity":
        im = torch.empty((cols, rows), dtype=x.dtype, device="meta").T
    elif fault == "out layout":
        out = kernels.plane_buffer((3, nu), rows, cols, 1 - axis, "meta")
    elif fault == "out shape":
        out = kernels.plane_buffer((nu,), rows, cols, axis, "meta")
    elif fault == "out dtype":
        out = torch.empty(out.shape, dtype=torch.int32, device="meta")
    return x, sft, axis, nu, "INT8", out, im


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("fault,match", [
    ("im shape", "im must be"), ("im dtype", "im must be"),
    ("im contiguity", "im must be"), ("out layout", "out must be"),
    ("out shape", "out must be"), ("out dtype", "out must be"),
    (None, "unsupported device meta")])
def test_encode_planes_lanes_refusals(axis, fault, match):
    """Off the CPU the lane route refuses an im of another shape, dtype or
    contiguity and an out of another layout, shape or dtype, before any
    launch (meta tensors: the sound arguments reach the device check)."""
    x, sft, axis, nu, backend, out, im = _meta_lane_args(axis, fault)
    kernels.reset_launches()
    with pytest.raises(ValueError, match=match):
        kernels.encode_planes(x, sft, axis, nu, backend, out=out, im=im,
                              conj=True)
    assert kernels.LAUNCHES["encode_lanes"] == 0


def test_quantize_complex_fp8_raises_naming_queue_8():
    """Complex FP8 (queue 8), once refused here, gives the JAX lanes: the
    (3, 3nu, ...) e4m3 stacks in the side's slot order."""
    from gemmul8_tpu import fp8 as jfp8
    re, im = _planes(4, 8, 16, np.float64)
    sft = torch.zeros(8, dtype=torch.int32)
    got = tcg._quantize_complex(*_t(re, im), sft, 0, 4, "FP8", False)
    ref = jcg._quantize_complex(jnp.asarray(re), jnp.asarray(im),
                                jnp.asarray(sft.numpy()), 0, 4, "FP8", False)
    assert got.shape == (3, 12, 8, 16)
    for lane in range(3):
        _bits_equal(got[lane].to(torch.float32), np.asarray(
            jfp8._gemm_stack(ref[lane], 4, "lhs"), np.float32))


def test_recombine_3m_bit_equal():
    rng = np.random.default_rng(5)
    nu = 20
    mods = jt.moduli("INT8")[:nu]
    mids = np.stack([np.stack([rng.integers(-(p // 2), p - p // 2, (9, 11))
                               for p in mods]) for _ in range(3)])
    mids = mids.astype(np.int8)
    ref_r, ref_i = jcg._recombine_3m(jnp.asarray(mids), nu, "INT8")
    got_r, got_i = tcg._recombine_3m(torch.from_numpy(mids), nu, "INT8")
    _bits_equal(got_r, ref_r)
    _bits_equal(got_i, ref_i)


@pytest.mark.parametrize("nu", [8, 16])
def test_herk_rhs_lanes_bit_equal(nu):
    re, im = _planes(6, 20, 36, np.float64)
    sft = tcg._shift_complex_fast(*_t(re, im), nu, "INT8", 1)
    pa = tcg._quantize_complex(*_t(re, im), sft, 0, nu, "INT8", False)
    ref = jcg._herk_rhs_lanes(jnp.asarray(pa.numpy()), nu, "INT8")
    got = tcg._herk_rhs_lanes(pa, nu, "INT8")
    assert got.stride()[-2] == 1                 # k-contiguous, as B is read
    _bits_equal(got.contiguous(), ref)


@pytest.mark.parametrize("nu", [8, 13])
def test_fused_epilogue_complex_f32_equals_pallas_interpret(nu):
    chi, sa, sb = _lane_products(10 + nu, nu, 64, 128, False)
    hire, lore, hiim, loim = pk.fused_epilogue_complex(
        jnp.asarray(chi), jnp.asarray(sa), jnp.asarray(sb), nu, "INT8", 24)
    got_r, got_i = kernels.fused_epilogue_complex_plain(
        *_t(chi, sa, sb), nu, "INT8", torch.float32)
    _bits_equal(got_r, (hire + lore).astype(jnp.float32))
    _bits_equal(got_i, (hiim + loim).astype(jnp.float32))


def _jax_unfused_complex(chi, sa, sb, nu, out_dtype):
    mids = jnp.stack([jc.mod_reduce(jnp.asarray(chi[lane * nu:(lane + 1) * nu]),
                                    nu, "INT8") for lane in range(3)])
    mid_r, mid_i = jcg._recombine_3m(mids, nu, "INT8")
    return [jff.reconstruct_scale_ff(x, jnp.asarray(sa), jnp.asarray(sb), nu,
                                     "INT8", out_dtype) for x in (mid_r, mid_i)]


@pytest.mark.parametrize("out_dtype,nu", [(np.float64, 16), (np.float64, 5),
                                          (np.float32, 2)])
@pytest.mark.parametrize("chunked", [False, True])
def test_fused_epilogue_complex_plain_equals_jax_chain(out_dtype, nu, chunked):
    """f64 output: the full-range f64 descale of the JAX CPU path (the
    Pallas kernel's f32 pair cannot hold it)."""
    chi, sa, sb = _lane_products(20 + nu, nu, 12, 20, chunked)
    tdt = torch.float64 if out_dtype == np.float64 else torch.float32
    ref_r, ref_i = _jax_unfused_complex(chi, sa, sb, nu, out_dtype)
    got_r, got_i = kernels.fused_epilogue_complex(*_t(chi, sa, sb), nu,
                                                  "INT8", tdt)
    _bits_equal(got_r, ref_r)
    _bits_equal(got_i, ref_i)
    cdt = torch.complex128 if tdt == torch.float64 else torch.complex64
    z = kernels.fused_epilogue_complex(*_t(chi, sa, sb), nu, "INT8", cdt)
    assert z.dtype == cdt
    _bits_equal(z.real.contiguous(), ref_r)
    _bits_equal(z.imag.contiguous(), ref_i)


@pytest.mark.parametrize("nu", [17, 20])
def test_fused_recombine_3m_plain_equals_pallas_interpret(nu):
    chi, _, _ = _lane_products(30 + nu, nu, 64, 128, False)
    ref_r, ref_i = pk.fused_recombine_3m(jnp.asarray(chi), nu, "INT8")
    got_r, got_i = kernels.fused_recombine_3m(torch.from_numpy(chi), nu,
                                              "INT8")
    _bits_equal(got_r, ref_r)
    _bits_equal(got_i, ref_i)


@pytest.mark.parametrize("out_dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("chunked", [False, True])
def test_split_epilogue_equals_single_kernel_plain(out_dtype, chunked):
    """K5 then two K2 passes on its int8 output == K4 (nu = 10), and K2 on
    int8 residues == K2 on the same values in int32."""
    nu = 10
    chi, sa, sb = _t(*_lane_products(40, nu, 16, 24, chunked))
    mid_r, mid_i = kernels.fused_recombine_3m(chi, nu, "INT8")
    assert mid_r.dtype == torch.int8 and mid_r.shape == (nu, 16, 24)
    split = [kernels.fused_epilogue(x, sa, sb, nu, "INT8", out_dtype)
             for x in (mid_r, mid_i)]
    single = kernels.fused_epilogue_complex(chi, sa, sb, nu, "INT8",
                                            out_dtype)
    for s, g in zip(split, single):
        _bits_equal(s, g.numpy())
    as_i32 = kernels.fused_epilogue(mid_r.to(torch.int32), sa, sb, nu, "INT8",
                                    out_dtype)
    _bits_equal(split[0], as_i32.numpy())


def test_complex_wrappers_cpu_take_plain_versions():
    kernels.reset_launches()
    chi, sa, sb = _t(*_lane_products(50, 6, 8, 8, False))
    z = kernels.fused_epilogue_complex(chi, sa, sb, 6, "INT8",
                                       torch.complex128)
    ref = kernels.fused_epilogue_complex_plain(chi, sa, sb, 6, "INT8",
                                               torch.complex128)
    assert torch.equal(z, ref)
    re, im = kernels.fused_recombine_3m(chi, 6, "INT8")
    ref_r, ref_i = kernels.fused_recombine_3m_plain(chi, 6, "INT8")
    assert torch.equal(re, ref_r) and torch.equal(im, ref_i)
    assert not any(kernels.LAUNCHES.values())


def test_norm_op_matches_jax():
    for t in (True, False, np.bool_(True), None, "n", "T", "c", "C"):
        assert tcg._norm_op(t) == jcg._norm_op(t)
    with pytest.raises(ValueError, match="bad op"):
        tcg._norm_op("X")
