"""K10 (csrc/shift.cu), the fast-mode shift kernel, from the CPU.

The kernel runs only on the card (chip_smoke.py phase 3 holds it to its
plain version there). Here: its wrapper on CPU tensors is the plain version
bit for bit; its refusals; the layouts it is handed; and a numpy mirror of
what the kernel computes otherwise than the plain version -- the maximum
from the |x| bits, amax0 from the maximum alone, and the sum of squares in
the kernel's fixed order (its threads, butterflies and slices) -- held to
the plain version's shifts on an edge corpus: no shift may flip."""
import numpy as np
import pytest
import torch

from gemmul8_tpu_torch import complex_gemm, kernels, quantize, tables

F32 = np.float32
ROW_THREADS = (32, 64, 128, 256, 512, 1024)


# ---------------------------------------------------------------------------
# the kernel's order, in numpy
# ---------------------------------------------------------------------------

def _butterfly(v):
    """A warp's xor butterfly (16, 8, 4, 2, 1) over the last axis of 32."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ off]).astype(F32)
    return v[..., 0]


def _row_sums(sq, width):
    """Each row's sum of sq (rows, L) in shift_rows_kernel's order."""
    rows, length = sq.shape
    nt = kernels.shift_row_threads(length, width)
    nvec = -(-length // width)
    chunks = -(-nvec // nt)
    pad = np.zeros((rows, chunks * nt * width), F32)
    pad[:, :length] = sq
    vecs = pad.reshape(rows, chunks, nt, width)     # vector i * nt + t
    acc = np.zeros((rows, nt), F32)
    for i in range(chunks):
        for s in range(width):
            acc = (acc + vecs[:, i, :, s]).astype(F32)
    warps = _butterfly(acc.reshape(rows, nt // 32, 32))
    pad32 = np.zeros((rows, 32), F32)
    pad32[:, :nt // 32] = warps
    return _butterfly(pad32)


def _col_sums(sq, width):
    """Each column's sum of sq (L, cols) in shift_cols_*_kernel's order."""
    length, cols = sq.shape
    slice_len, slices = kernels.shift_col_slices(length, cols, width)
    warps = kernels.SHIFT_COL_WARPS
    pad = np.zeros((slices * slice_len, cols), F32)
    pad[:length] = sq
    part = pad.reshape(slices, slice_len // warps, warps, cols)
    acc = np.zeros((slices, warps, cols), F32)
    for i in range(slice_len // warps):               # row kb + w + 8 i
        acc = (acc + part[:, i]).astype(F32)
    per_slice = acc[:, 0]
    for w in range(1, warps):
        per_slice = (per_slice + acc[:, w]).astype(F32)
    total = per_slice[0]
    for q in range(1, slices):
        total = (total + per_slice[q]).astype(F32)
    return total


def _amax_from_bits(x, axis):
    """max |x| as K10 takes it: the largest |x| bit pattern, unsigned."""
    if x.dtype == np.float64:
        bits = x.view(np.uint64) & np.uint64(0x7FFFFFFFFFFFFFFF)
        return bits.max(axis=axis).view(np.float64)
    bits = x.view(np.uint32) & np.uint32(0x7FFFFFFF)
    return bits.max(axis=axis).view(np.float32)


def kernel_mirror(x, num_moduli, backend, reduce_axis, variant="reference",
                  im=None):
    """K10's shifts in numpy where it departs from the plain version's
    operators (the elementwise steps are the same operators: shift_terms'),
    with (amax0, E, s2) beside them."""
    if im is not None:
        x = np.concatenate([x, im], axis=reduce_axis)
    xt = torch.from_numpy(x)
    z, amax0_plain, E_plain = kernels.shift_terms(xt, reduce_axis)
    amax = _amax_from_bits(x, reduce_axis)
    if x.dtype == np.float64:
        big = amax > 2.0 ** 126
        e0 = np.where(big, quantize.ilogb(torch.from_numpy(
            np.where(big, amax, 1.0))).numpy(), 0).astype(np.int32)
        amax0 = np.abs(quantize.pow2_scale(
            torch.from_numpy(amax), torch.from_numpy(-e0)).numpy()
            .astype(F32))
    else:
        e0, amax0 = np.zeros(amax.shape, np.int32), amax
    safe = np.where(amax0 > 0, amax0, F32(1))
    e_loc = quantize.ilogb(torch.from_numpy(
        (safe * F32(1.0 + 2.0 ** -22)).astype(F32))).numpy()
    E = (e_loc + e0).astype(np.int32)
    np.testing.assert_array_equal(amax0.view(np.uint32),
                                  amax0_plain.numpy().view(np.uint32))
    np.testing.assert_array_equal(E, E_plain.numpy())
    sq = (z * z).numpy()
    width = kernels.shift_width(xt.dtype)
    s2 = (_row_sums(sq, width) if reduce_axis == 1
          else _col_sums(sq, width))
    sft = kernels.shift_from_sum(torch.from_numpy(s2), amax0_plain, E_plain,
                                 num_moduli, backend, variant)
    return sft, s2


# ---------------------------------------------------------------------------
# the corpus
# ---------------------------------------------------------------------------

def _random(rng, shape, dt, spread=2.0):
    x = rng.standard_normal(shape) * np.exp(spread * rng.standard_normal(shape))
    return x.astype(dt)


def edge_operand(rng, shape, dt, reduce_axis):
    """Random values with zero rows, rows above 2^126 (f64), subnormal
    rows, a row of one nonzero and rows spanning many binades, along the
    reduce axis."""
    x = _random(rng, shape, dt)
    x = x if reduce_axis == 1 else x.T.copy()       # rows along the reduce
    n = x.shape[0]
    tiny = 1e-310 if dt == np.float64 else 1e-40
    if n > 0:
        x[0] = 0.0
    if n > 1:
        x[1] = rng.standard_normal(x.shape[1]) * tiny
    if n > 2:
        x[2] = 0.0
        x[2, -1] = -3.0
    if n > 3:
        x[3] *= np.exp2(rng.integers(-60, 60, x.shape[1])).astype(dt)
    if n > 4 and dt == np.float64:
        x[4] *= 2.0 ** 900
        x[4, 0] = 1.7e308
    if n > 5 and dt == np.float64:
        x[5] *= 2.0 ** -1000
    if n > 6:
        x[6] = 2.0 ** -120
    if n > 7:
        x[7, ::2] = np.pi
        x[7, 1::2] = 0.0
    return x if reduce_axis == 1 else x.T.copy()


# (rows, cols) of the operand: k = 1, ragged widths (1, 3, 5, 130, 263) off
# the 16-byte vector, whole ones, rows past the registers (f64 > 16384)
SHAPES = [(9, 1), (9, 3), (11, 5), (13, 130), (8, 263), (17, 256),
          (40, 1000), (9, 4100), (9, 17000)]
COL_SHAPES = [(1, 9), (3, 9), (5, 11), (130, 13), (263, 8), (256, 17),
              (1000, 40), (2100, 9), (600, 300)]


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("reduce_axis", [1, 0])
@pytest.mark.parametrize("variant", ["reference", "invariant"])
@pytest.mark.parametrize("lanes", [1, 2])
def test_mirror_of_the_kernel_flips_no_shift(dt, reduce_axis, variant,
                                             lanes):
    """The kernel's maximum from the bits, its amax0 from the maximum and
    its order of the sum give the plain version's shifts on the corpus."""
    rng = np.random.default_rng(19 + 2 * reduce_axis + lanes)
    for shape in SHAPES if reduce_axis == 1 else COL_SHAPES:
        x = edge_operand(rng, shape, dt, reduce_axis)
        im = None if lanes == 1 else edge_operand(rng, shape, dt, reduce_axis)
        for nu, backend in ((16, "INT8"), (8, "INT8"), (14, "FP8")):
            ref = kernels.shift_fast_plain(
                torch.from_numpy(x), nu, backend, reduce_axis, variant,
                None if im is None else torch.from_numpy(im))
            got, _ = kernel_mirror(x, nu, backend, reduce_axis, variant, im)
            np.testing.assert_array_equal(got.numpy(), ref.numpy(),
                                          err_msg=f"{shape} nu={nu}")


@pytest.mark.parametrize("reduce_axis", [1, 0])
def test_mirror_at_the_cells_widths(reduce_axis):
    """Rows and columns of 8192 f64 (and 512, upd's k; 16384 of a complex
    pair), standard normal, as the benchmark's operands: no shift flips;
    how many sums differ in their last bits from torch.sum's is printed."""
    rng = np.random.default_rng(8192 + reduce_axis)
    for shape, lanes in (((64, 8192), 1), ((48, 512), 1), ((32, 8192), 2)):
        shape = shape if reduce_axis == 1 else shape[::-1]
        x = rng.standard_normal(shape)
        im = rng.standard_normal(shape) if lanes == 2 else None
        got, s2 = kernel_mirror(x, 16, "INT8", reduce_axis, im=im)
        cat = x if im is None else np.concatenate([x, im], axis=reduce_axis)
        z, _, _ = kernels.shift_terms(torch.from_numpy(cat), reduce_axis)
        s2_plain = torch.sum(z * z, dim=reduce_axis).numpy()
        ref = kernels.shift_fast_plain(
            torch.from_numpy(x), 16, "INT8", reduce_axis,
            im=None if im is None else torch.from_numpy(im))
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        print(shape, lanes, "sums differing from torch.sum's:",
              int((s2 != s2_plain).sum()), "of", s2.size)


def _to_floor_edge(rng, x, im, reduce_axis, num_moduli):
    """x and im with each row (column) scaled by 2^u, u in [0, 1) chosen so
    that the reference shift's floor argument lands within about 2^-16 of
    an integer (as chip_smoke.py's to_floor_edge)."""
    s2 = (x * x).sum(axis=reduce_axis)
    if im is not None:
        s2 = s2 + (im * im).sum(axis=reduce_axis)
    arg = (tables.log2P(num_moduli, "INT8") - 1.5 - quantize.SFT_MARGIN
           - quantize.LOG2_HALF_RU * (np.log2(s2) + 2.0 ** -18))
    off = (rng.random(s2.shape) - 0.5) * 2.0 ** -15
    scale = np.expand_dims(np.exp2(np.mod(arg - np.floor(arg) + off, 1.0)),
                           reduce_axis)
    return x * scale, None if im is None else im * scale


@pytest.mark.parametrize("reduce_axis", [1, 0])
@pytest.mark.parametrize("lanes", [1, 2])
def test_mirror_at_the_floors_edge(reduce_axis, lanes):
    """Rows and columns of 8192 and 512 f64 moved so that their floor
    argument sits at an integer, where two orders of the sum can floor one
    apart: the kernel's order flips no shift against the plain version's
    on these operands."""
    rng = np.random.default_rng(2 ** 16 + 2 * reduce_axis + lanes)
    on_edge = 0
    for shape in ((96, 8192), (128, 512)):
        shape = shape if reduce_axis == 1 else shape[::-1]
        x = rng.standard_normal(shape)
        im = rng.standard_normal(shape) if lanes == 2 else None
        x, im = _to_floor_edge(rng, x, im, reduce_axis, 16)
        got, _ = kernel_mirror(x, 16, "INT8", reduce_axis, im=im)
        ref = kernels.shift_fast_plain(
            torch.from_numpy(x), 16, "INT8", reduce_axis,
            im=None if im is None else torch.from_numpy(im))
        np.testing.assert_array_equal(got.numpy(), ref.numpy(),
                                      err_msg=f"{shape} lanes={lanes}")
        on_edge += int((ref != kernels.shift_fast_plain(
            torch.from_numpy(x * (1 + 2.0 ** -12)), 16, "INT8", reduce_axis,
            im=None if im is None else torch.from_numpy(im * (1 + 2.0 ** -12))
        )).sum())
    assert on_edge > 0       # a nudge of 2^-12 in scale crosses the floor


def test_row_sum_order_is_the_kernels():
    """The mirror's row order on a hand case: 40 f64 elements take 32
    threads, thread t holding elements 2t and 2t + 1, whose sums meet in
    the butterflies, not from left to right."""
    assert kernels.shift_row_threads(40, 2) == 32
    sq = np.zeros((1, 40), F32)
    sq[0, 0], sq[0, 2], sq[0, 6] = 1.0, 2.0 ** -24, 2.0 ** -24
    # left to right: 1 + 2^-24 rounds to 1 (ties to even), twice
    assert np.cumsum(sq[0], dtype=F32)[-1] == 1.0
    # threads 1 and 3 meet at xor 2 (2^-23), then thread 0 at xor 1
    assert _row_sums(sq, 2)[0] == F32(1.0 + 2.0 ** -23)


@pytest.mark.parametrize("length, width, threads", [
    (1, 2, 32), (512, 2, 32), (8192, 2, 512), (16384, 2, 1024),
    (100000, 2, 1024), (8192, 4, 256), (4097, 2, 512)])
def test_row_threads(length, width, threads):
    nt = kernels.shift_row_threads(length, width)
    assert nt == threads and nt in ROW_THREADS
    nvec = -(-length // width)
    resident = nvec <= nt * kernels.SHIFT_VPT
    assert resident == (length <= 8192 * width)


@pytest.mark.parametrize("length, cols, width", [
    (8192, 8192, 2), (16384, 8192, 2), (512, 8192, 2), (4096, 4096, 2),
    (1, 1, 2), (7, 3, 4), (100000, 5, 4), (2100, 9, 2)])
def test_col_slices_cover_the_column(length, cols, width):
    slice_len, slices = kernels.shift_col_slices(length, cols, width)
    assert slice_len % kernels.SHIFT_COL_WARPS == 0
    assert slice_len * (slices - 1) < length <= slice_len * slices
    assert 1 <= slices <= 512
    strips = -(-cols // (32 * width))
    assert kernels.shift_scratch_bytes(cols, slices, width) == \
        12 * slices * cols + 4 * strips


def test_col_slices_at_the_cells():
    """sq8192's B: 128 strips of 64 columns in 4 slices of 2048 rows."""
    assert kernels.shift_col_slices(8192, 8192, 2) == (2048, 4)
    assert kernels.shift_col_slices(16384, 8192, 2) == (4096, 4)
    assert kernels.shift_col_slices(512, 8192, 2) == (128, 4)
    assert kernels.shift_col_slices(4096, 4096, 2) == (512, 8)


# ---------------------------------------------------------------------------
# the wrapper on the CPU, its refusals and its layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("reduce_axis", [0, 1])
@pytest.mark.parametrize("variant", ["reference", "invariant"])
@pytest.mark.parametrize("backend", ["INT8", "FP8"])
def test_wrapper_on_cpu_is_the_plain_version(dt, reduce_axis, variant,
                                             backend):
    rng = np.random.default_rng(7)
    hi = 20 if dt == np.float64 else 13
    for nu in range(2, hi + 1, 3):
        x = torch.from_numpy(edge_operand(rng, (23, 37), dt, reduce_axis))
        got = kernels.shift_fast(x, nu, backend, reduce_axis, variant)
        ref = kernels.shift_fast_plain(x, nu, backend, reduce_axis, variant)
        assert got.dtype == torch.int32
        assert torch.equal(got, ref)
        assert torch.equal(quantize.shift_fast(x, nu, backend, reduce_axis,
                                               variant), ref)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("reduce_axis", [0, 1])
def test_two_lanes_are_the_cat_form(dt, reduce_axis):
    rng = np.random.default_rng(11)
    re = torch.from_numpy(edge_operand(rng, (19, 29), dt, reduce_axis))
    im = torch.from_numpy(_random(rng, (19, 29), dt))
    cat = torch.cat([re, im], dim=reduce_axis)
    for variant in ("reference", "invariant"):
        ref = quantize.shift_fast(cat, 16 if dt == np.float64 else 8, "INT8",
                                  reduce_axis, variant)
        nu = 16 if dt == np.float64 else 8
        assert torch.equal(kernels.shift_fast(re, nu, "INT8", reduce_axis,
                                              variant, im=im), ref)
        assert torch.equal(complex_gemm._shift_complex_fast(
            re, im, nu, "INT8", reduce_axis, variant), ref)


def _meta(shape, dtype=torch.float64):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("args, match", [
    ((_meta((4, 8), torch.float16), 1), "2-D f32 or f64"),
    ((_meta((4, 8), torch.int32), 1), "2-D f32 or f64"),
    ((_meta((2, 4, 8)), 1), "2-D f32 or f64"),
    ((_meta((8,)), 0), "2-D f32 or f64"),
    ((_meta((4, 8)), 2), "reduce_axis"),
    ((_meta((4, 8)), -1), "reduce_axis"),
    ((_meta((4, 0)), 1), "reduce axis is empty"),
    ((_meta((4, 8)), 1), "unsupported device"),
])
def test_wrapper_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        kernels.shift_fast(args[0], 16, "INT8", args[1])


@pytest.mark.parametrize("x, im, axis", [
    (_meta((8, 4)).T, None, 1), (_meta((4, 16))[:, ::2], None, 0),
    (_meta((4, 8)), _meta((4, 16))[:, :8], 1),
    (_meta((4, 8)).T, _meta((4, 8)).T, 0)])
def test_wrapper_lays_out_any_layout(x, im, axis):
    """A transposed view, every other column and an im strided unlike x are
    laid out (shift_operands) and pass every check up to the device."""
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.shift_fast(x, 16, "INT8", axis, im=im)


def test_wrapper_refuses_a_mismatched_im_and_variant():
    x = _meta((4, 8))
    for im in (_meta((4, 9)), _meta((4, 8), torch.float32)):
        with pytest.raises(ValueError, match="im must have"):
            kernels.shift_fast(x, 16, "INT8", 1, im=im)
    with pytest.raises(ValueError, match="variant"):
        kernels.shift_fast(x, 16, "INT8", 1, variant="robust")


def test_launch_count_is_kept_and_reset():
    assert "shift_fast" in kernels.LAUNCHES
    kernels.LAUNCHES["shift_fast"] = 5
    kernels.reset_launches()
    assert kernels.LAUNCHES["shift_fast"] == 0
    kernels.shift_fast(torch.ones(3, 4, dtype=torch.float64), 16, "INT8", 1)
    assert kernels.LAUNCHES["shift_fast"] == 0       # the plain version


def test_shift_operands_layouts():
    x = torch.arange(48.0, dtype=torch.float64).reshape(6, 8)
    same = kernels.shift_operands(x, None, 1)
    assert same[0] is x and same[1] is None and same[2] == 1
    strip = x[:, 2:6]                          # a column strip: rows kept
    assert kernels.shift_operands(strip, None, 0)[0] is strip
    t, _, axis = kernels.shift_operands(x.T, None, 1)
    assert axis == 0 and t.is_contiguous() and t.data_ptr() == x.data_ptr()
    odd = x[::2, ::2]                          # neither: copied
    c, _, axis = kernels.shift_operands(odd, None, 0)
    assert axis == 0 and c.is_contiguous() and torch.equal(c, odd)
    re, im = x.T, (x + 1).T
    a, b, axis = kernels.shift_operands(re, im, 0)
    assert axis == 1 and a.is_contiguous() and b.is_contiguous()
    mixed = kernels.shift_operands(x, (x + 1).T.contiguous().T, 1)
    assert mixed[0].stride() == mixed[1].stride() == (8, 1)


@pytest.mark.parametrize("reduce_axis", [0, 1])
def test_shift_operands_keep_the_shifts(reduce_axis):
    """A layout shift_operands changes gives the same plain shifts: the
    route it picks reads the same rows or columns."""
    rng = np.random.default_rng(3)
    base = torch.from_numpy(_random(rng, (30, 22), np.float64))
    for x in (base, base.T, base[::2, ::3], base[:, 4:17]):
        ref = kernels.shift_fast_plain(x, 16, "INT8", reduce_axis)
        y, _, axis = kernels.shift_operands(x, None, reduce_axis)
        assert torch.equal(kernels.shift_fast_plain(y, 16, "INT8", axis), ref)
