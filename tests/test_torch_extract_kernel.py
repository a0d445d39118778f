"""K11 (csrc/extract.cu), accurate mode's upper-bound extraction, from the CPU.

The kernel runs only on the card (chip_smoke.py phase 3 holds it to its
plain version there). Here: a numpy mirror of its steps -- the maximum from
the |x| bits (the column route's per-slice maxima combined), ilogb's two
branches, the pre-shift, pow2_scale's three factors, the ceiling with the
f64 tail, the clamp and each backend's conversion -- held to the plain
version bit for bit on an edge corpus; the index arithmetic of its two
frames, which must write every element once; its wrapper on CPU tensors,
which is the plain version; its refusals; and, on meta tensors with the
launches recorded, the layouts it hands out and the launches it makes."""
import numpy as np
import pytest
import torch

from gemmul8_tpu_torch import kernels, quantize

F32, F64 = np.float32, np.float64
BACKENDS = ("INT8", "FP8")


# ---------------------------------------------------------------------------
# the kernel's steps, in numpy
# ---------------------------------------------------------------------------

def _abs_bits(x):
    """The |x| bit patterns as unsigned integers (shift.cuh: Word)."""
    if x.dtype == F64:
        return x.view(np.uint64) & np.uint64(0x7FFFFFFFFFFFFFFF)
    return x.view(np.uint32) & np.uint32(0x7FFFFFFF)


def _amax_bits(x, reduce_axis):
    """max |x| as K11 takes it. Rows: the maximum of each row's bits. Columns:
    each k-slice's maxima (K10's first launch, kernels.shift_col_slices),
    then their maximum over the slices (K11's second launch)."""
    bits = _abs_bits(x)
    if reduce_axis == 1:
        return bits.max(axis=1)
    rows, cols = x.shape
    slice_len, slices = kernels.shift_col_slices(
        rows, cols, kernels.shift_width(torch.float64 if x.dtype == F64
                                        else torch.float32))
    per_slice = [bits[q * slice_len:(q + 1) * slice_len].max(axis=0)
                 for q in range(slices)]
    m = per_slice[0]
    for p in per_slice[1:]:
        m = np.maximum(m, p)
    return m


def _to_int32(v):
    """The device's f64 -> int32 conversion, toward zero: the CPU's here
    (INT_MIN out of range); the card's saturates, as torch's does there."""
    return torch.from_numpy(np.asarray(v, F64)).to(torch.int32).numpy()


def _pre_shift(bits, dtype, backend):
    """sft_pre = MAX_UFP - ilogb(amax), amax = 1 where it is not > 0."""
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        a = bits.view(dtype)
        a = np.where(a > 0, a, np.ones((), dtype))
        a32 = a.astype(F32)                       # RNE
        e32 = ((a32.view(np.uint32) >> 23) & 0xFF).astype(np.int64) - 127
        if dtype == F64:
            in_range = (a32 >= F32(2.0 ** -126)) & np.isfinite(a32) & (a32 > 0)
            ef = _to_int32(np.floor(np.log2(np.maximum(
                a, np.finfo(F64).tiny)) + 2.0 ** -32))
            e32 = np.where(in_range, e32, ef)
    s = quantize.MAX_UFP[backend] - e32.astype(np.int64)
    return ((s + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)   # wraps


def _pow2(e, dtype):
    """2^e by exponent-field assembly, wrapping as torch's int shifts do."""
    e = e.astype(np.int64)
    if dtype == F64:
        return ((e + 1023).view(np.uint64) << np.uint64(52)).view(F64)
    return (((e + 127) & 0xFFFFFFFF).astype(np.uint32)
            << np.uint32(23)).view(F32)


def _factors(sft, dtype):
    """pow2_scale's three factors of each shift (common.cuh: Pow2Split)."""
    s = sft.astype(np.int64)
    h1 = np.floor_divide(s, 3)
    h2 = np.floor_divide(s - h1, 2)
    return _pow2(h1, dtype), _pow2(h2, dtype), _pow2(s - h1 - h2, dtype)


def _bf16_rne(v):
    """f32 -> bf16 bits by round to nearest even (NaN: the CPU's 0x7FC0)."""
    u = v.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(np.isnan(v), np.uint16(0x7FC0), r)


def _emit(ub, backend):
    """A bound's bits: int8, or bf16 one ulp up where RNE rounded down."""
    if backend == "INT8":
        return torch.from_numpy(ub).to(torch.int8).numpy().view(np.uint8)
    b = _bf16_rne(ub)
    up = (b.astype(np.uint32) << 16).view(F32) < ub
    return np.where(up, b + np.uint16(1), b).astype(np.uint16)


def _bounds(x, sft, reduce_axis):
    """Each element's f32 bound under its row's (column's) shift."""
    f1, f2, f3 = (np.expand_dims(f, reduce_axis)
                  for f in _factors(sft, x.dtype))
    with np.errstate(over="ignore", invalid="ignore", under="ignore"):
        ax = np.abs(x)
        y = ((ax * f1) * f2) * f3
        c1 = y.astype(F32)
        ub = np.ceil(c1)
        if x.dtype == F64:
            ub = (ub + ((y - c1.astype(F64)).astype(F32) > 0)
                  .astype(F32)).astype(F32)
        ub = np.where(np.isnan(ub), ub, np.maximum(ub, F32(1)))
        return np.where(ax > 0, ub, F32(0)).astype(F32)


def kernel_mirror(x, backend, scale_axis):
    """K11's (plane bits, pre-shifts) of x (numpy), the plane in x's
    orientation."""
    reduce_axis = 1 - scale_axis
    sft = _pre_shift(_amax_bits(x, reduce_axis), x.dtype, backend)
    return _emit(_bounds(x, sft, reduce_axis), backend), sft


def _plain_bits(x, backend, scale_axis):
    ub, pre = kernels.extract_ub_plain(torch.from_numpy(x), backend,
                                       scale_axis)
    view = torch.uint8 if backend == "INT8" else torch.int16
    return ub.contiguous().view(view).numpy().view(
        np.uint8 if backend == "INT8" else np.uint16), pre.numpy()


# ---------------------------------------------------------------------------
# the corpus
# ---------------------------------------------------------------------------

def _random(rng, shape, dt, spread=2.0):
    x = rng.standard_normal(shape) * np.exp(spread * rng.standard_normal(shape))
    return x.astype(dt)


def edge_operand(rng, shape, dt, reduce_axis):
    """Random values spanning many binades with, along the reduce axis: a
    zero row, an amax just under a power of two (f64: rounds up in f32),
    amax above 2^126 and 2^128, below 2^-126, a subnormal row, subnormal
    elements among normal ones, +-Inf, NaN and a row of one nonzero."""
    x = _random(rng, shape, dt)
    x = x if reduce_axis == 1 else x.T.copy()       # rows along the reduce
    n, w = x.shape
    big = 2.0 ** 126 if dt == F32 else 1e300
    sub = 1e-40 if dt == F32 else 1e-310
    rows = [
        np.zeros(w),
        x[1 % n] / np.abs(x[1 % n]).max() * 2.0 ** 10 * (1 - 2.0 ** -30),
        x[2 % n] / np.abs(x[2 % n]).max() * big,
        x[3 % n] / np.abs(x[3 % n]).max() * (2.0 ** -130),
        rng.standard_normal(w) * sub,
        np.where(rng.random(w) < 0.5, x[5 % n], x[5 % n] * sub),
        np.where(np.arange(w) == w // 2, np.inf, x[6 % n]),
        np.where(np.arange(w) == 0, -np.inf, x[7 % n]),
        np.where(np.arange(w) == w - 1, np.nan, x[8 % n]),
        np.where(np.arange(w) == w // 3, -3.0, 0.0),
    ]
    if dt == F64:
        rows += [x[10 % n] / np.abs(x[10 % n]).max()    # f32: Inf
                 * (2.0 ** 128 * (1 - 2.0 ** -26)),
                 x[11 % n] / np.abs(x[11 % n]).max() * 2.0 ** 127]
    with np.errstate(over="ignore", invalid="ignore"):
        for i, v in enumerate(rows[:n]):
            x[i] = v.astype(dt)
    return x if reduce_axis == 1 else x.T.copy()


# (rows, cols) of the operand: k = 1, widths off the 16-byte vectors (1,
# 3, 5, 13, 263) and whole ones, f64 rows past the registers (17000), long
# columns (several slices), rows not a multiple of 4
SHAPES = [(13, 1), (12, 3), (14, 5), (16, 130), (12, 263), (17, 256),
          (40, 1000), (12, 17000)]
COL_SHAPES = [(1, 13), (3, 12), (5, 14), (130, 16), (263, 12), (256, 17),
              (1000, 40), (2101, 12), (600, 300)]


@pytest.mark.parametrize("dt", [F32, F64])
@pytest.mark.parametrize("scale_axis", [0, 1])
@pytest.mark.parametrize("backend", BACKENDS)
def test_mirror_of_the_kernel_is_the_plain_version(dt, scale_axis, backend):
    """The kernel's steps give the plain version's planes and pre-shifts,
    bit for bit, on the corpus."""
    rng = np.random.default_rng(25 + 4 * scale_axis + (dt == F64))
    for shape in SHAPES if scale_axis == 0 else COL_SHAPES:
        x = edge_operand(rng, shape, dt, 1 - scale_axis)
        got, got_pre = kernel_mirror(x, backend, scale_axis)
        ref, ref_pre = _plain_bits(x, backend, scale_axis)
        np.testing.assert_array_equal(got_pre, ref_pre, err_msg=f"{shape}")
        np.testing.assert_array_equal(got, ref, err_msg=f"{shape}")


@pytest.mark.parametrize("scale_axis", [0, 1])
@pytest.mark.parametrize("backend", BACKENDS)
def test_mirror_on_stripes_and_transposed_views(scale_axis, backend):
    """Row-pitched stripes (the blocked path's b[:, ni:ni + n_block]) and
    transposed views: the mirror of the same values is the plain version
    of the view."""
    rng = np.random.default_rng(2500 + scale_axis)
    base = edge_operand(rng, (96, 160), F64, 1 - scale_axis)
    for view in (base[:, 3:131], base[:, 64:], base.T.copy().T, base[::2]):
        got, got_pre = kernel_mirror(np.ascontiguousarray(view), backend,
                                     scale_axis)
        ref, ref_pre = _plain_bits(view, backend, scale_axis)
        np.testing.assert_array_equal(got_pre, ref_pre)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mirror_at_the_cells_operands(backend):
    """The accurate cell's phi = 2 operands, (U - 0.5) exp(2 N), at 8192
    wide: rows of A and columns of B in the mirror and the plain version."""
    rng = np.random.default_rng(8192)
    for shape, scale_axis in (((16, 8192), 0), ((8192, 16), 1)):
        x = (rng.random(shape) - 0.5) * np.exp(2.0 * rng.standard_normal(shape))
        got, got_pre = kernel_mirror(x, backend, scale_axis)
        ref, ref_pre = _plain_bits(x, backend, scale_axis)
        np.testing.assert_array_equal(got_pre, ref_pre)
        np.testing.assert_array_equal(got, ref)
        limit = 65 if backend == "INT8" else 0x4381   # bf16(258)
        assert got.max() <= limit


def test_f64_amax_rounding_up_takes_the_next_exponent():
    """An f64 amax just under 2^10 rounds to 2^10 in f32: E = 10, so the
    pre-shift is MAX_UFP - 10 and the largest bound 2^MAX_UFP, not 2^6."""
    x = np.array([[2.0 ** 10 * (1 - 2.0 ** -30), 1.0]])
    for backend in BACKENDS:
        got, pre = kernel_mirror(x, backend, 0)
        _, ref_pre = _plain_bits(x, backend, 0)
        assert pre[0] == ref_pre[0] == quantize.MAX_UFP[backend] - 10


@pytest.mark.parametrize("amax, e", [(1e300, 996),
                                     (2.0 ** 128 * (1 - 2.0 ** -26), 127),
                                     (1e-40, -133), (1e-310, -1022)])
def test_the_log2_branch(amax, e):
    """f64 amax outside f32's normal range: E from floor(log2(max(amax,
    DBL_MIN)) + 2^-32), in the mirror and the plain version alike (a
    subnormal amax takes DBL_MIN's -1022)."""
    x = np.array([[amax, amax / 3]])
    _, pre = kernel_mirror(x, "INT8", 0)
    _, ref_pre = _plain_bits(x, "INT8", 0)
    assert pre[0] == ref_pre[0] == quantize.MAX_UFP["INT8"] - e


def test_fp8_bound_rounds_up_past_bf16s_grid():
    """A bound of 257 has no bf16: RNE gives 256, one ulp up gives 258."""
    assert _emit(np.array([257.0, 256.0, 65.0], F32), "FP8").tolist() == \
        [0x4381, 0x4380, 0x4282]


# ---------------------------------------------------------------------------
# the frames' index arithmetic: every element written once
# ---------------------------------------------------------------------------

def _rows_cover(cols, width, threads):
    """extract_rows_kernel's stores of one row: thread t, vector i of chunk
    base writes elements (base + t + i nt) W ... + W - 1 below cols."""
    seen = np.zeros(cols, int)
    nvec = -(-cols // width)
    for base in range(0, nvec, threads * kernels.SHIFT_VPT):
        for t in range(threads):
            for i in range(kernels.SHIFT_VPT):
                j0 = (base + t + i * threads) * width
                for s in range(width):
                    if j0 < cols and j0 + s < cols:
                        seen[j0 + s] += 1
    return seen


def _cols_cover(rows, cols, width):
    """extract_cols_kernel's stores: block (strip, q) writes, in passes of
    128 rows from its slice's start, warp w's columns w, w + 8, ... and
    lane l's rows 4l .. 4l + 3 of each, below the slice's end and cols."""
    slice_len, slices = kernels.shift_col_slices(rows, cols, width)
    cb = 32 * width
    seen = np.zeros((cols, rows), int)
    for strip in range(-(-cols // cb)):
        for q in range(slices):
            kb, ke = q * slice_len, min(rows, (q + 1) * slice_len)
            for k0 in range(kb, ke, 128):
                for cl in range(cb):
                    c = strip * cb + cl
                    for lane in range(32):
                        k = k0 + 4 * lane
                        if c >= cols or k >= ke:
                            continue
                        for r in range(4):
                            if k + r < ke:
                                seen[c, k + r] += 1
    return seen


@pytest.mark.parametrize("cols, width", [(1, 2), (3, 2), (263, 4), (8192, 2),
                                         (17000, 2), (4097, 4)])
def test_row_frame_writes_each_element_once(cols, width):
    threads = kernels.shift_row_threads(cols, width)
    assert (_rows_cover(cols, width, threads) == 1).all()


@pytest.mark.parametrize("rows, cols, width", [
    (1, 1, 2), (3, 13, 2), (130, 16, 4), (263, 65, 2), (2101, 12, 2),
    (512, 200, 4), (1030, 3, 4)])
def test_col_frame_writes_each_element_once(rows, cols, width):
    assert (_cols_cover(rows, cols, width) == 1).all()


# ---------------------------------------------------------------------------
# the wrapper on the CPU, its refusals, its layouts and launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [F32, F64])
@pytest.mark.parametrize("scale_axis", [0, 1])
@pytest.mark.parametrize("backend", BACKENDS)
def test_wrapper_on_cpu_is_the_plain_version(dt, scale_axis, backend):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(edge_operand(rng, (23, 37), dt, 1 - scale_axis))
    kernels.reset_launches()
    got, pre = kernels.extract_ub(x, backend, scale_axis)
    ref, ref_pre = kernels.extract_ub_plain(x, backend, scale_axis)
    assert got.dtype == (torch.int8 if backend == "INT8" else torch.bfloat16)
    assert torch.equal(got.view(torch.int8 if backend == "INT8"
                                else torch.int16),
                       ref.view(torch.int8 if backend == "INT8"
                                else torch.int16))
    assert torch.equal(pre, ref_pre) and pre.dtype == torch.int32
    q_ub, q_pre = quantize.extract_ub_plane(x, backend, scale_axis)
    assert torch.equal(q_ub, ref) and torch.equal(q_pre, ref_pre)
    assert kernels.LAUNCHES["extract_ub"] == 0          # the plain version


def _meta(shape, dtype=torch.float64):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("args, match", [
    ((_meta((4, 8), torch.float16), "INT8", 0), "2-D f32 or f64"),
    ((_meta((4, 8), torch.int32), "INT8", 0), "2-D f32 or f64"),
    ((_meta((2, 4, 8)), "INT8", 0), "2-D f32 or f64"),
    ((_meta((8,)), "INT8", 1), "2-D f32 or f64"),
    ((_meta((4, 8)), "FP16", 0), "backend must be INT8 or FP8"),
    ((_meta((4, 8)), "INT8", 2), "scale_axis"),
    ((_meta((4, 0)), "INT8", 0), "reduce axis is empty"),
    ((_meta((0, 8)), "FP8", 1), "reduce axis is empty"),
    ((_meta((4, 8)), "INT8", 0), "unsupported device"),
    ((_meta((4, 8), torch.float32), "FP8", 1), "unsupported device"),
])
def test_wrapper_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        kernels.extract_ub(*args)


@pytest.fixture
def fake_card(monkeypatch):
    """kernels.extract_ub on meta tensors as on the card: the device check
    passes meta tensors (after every other check), the launches are
    recorded, not made."""
    calls = []
    check = kernels._check_extract

    def check_meta(x, backend, reduce_axis):
        with pytest.raises(ValueError, match="unsupported device meta"):
            check(x, backend, reduce_axis)

    def launch(name, *args, count=None):
        calls.append((name, args))
        kernels.LAUNCHES[count or name] += 1

    monkeypatch.setattr(kernels, "_check_extract", check_meta)
    monkeypatch.setattr(kernels, "_launch", launch)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    kernels.reset_launches()
    return calls


@pytest.mark.parametrize("backend", BACKENDS)
def test_b_plane_is_a_k_contiguous_view(fake_card, backend):
    """B (k, n) row-major: two launches (K10's column maxima, K11's plane),
    and the plane a (k, n) view with stride(0) == 1, as the estimation
    product reads it; A (m, k): one launch, a row-major plane."""
    b = _meta((512, 192))
    ub_b, pre_b = kernels.extract_ub(b, backend, 1)
    assert [c[0] for c in fake_card] == ["shift_cols_max", "extract_cols"]
    assert ub_b.shape == (512, 192) and ub_b.stride() == (1, 512)
    assert ub_b.dtype == (torch.int8 if backend == "INT8" else torch.bfloat16)
    assert pre_b.shape == (192,) and pre_b.dtype == torch.int32
    assert quantize._k_contiguous(ub_b) is ub_b      # no copy follows
    a = _meta((256, 512))
    ub_a, pre_a = kernels.extract_ub(a, backend, 0)
    assert fake_card[-1][0] == "extract_rows"
    assert ub_a.stride() == (512, 1) and pre_a.shape == (256,)
    assert ub_a.T.stride(0) == 1                 # syrk's transposed view
    assert kernels.LAUNCHES["extract_ub"] == 3


def test_launch_arguments(fake_card):
    """The row route's block size and the column route's slices are K10's,
    the scratch is K10's, the pitch of a stripe is its parent's row."""
    b = _meta((8192, 8192))
    kernels.extract_ub(b[:, 4096:], "INT8", 1)
    (_, mx), (_, cl) = fake_card
    slice_len, slices = kernels.shift_col_slices(8192, 4096, 2)
    # x0, x1, scratch, is_f64, rows, cols, ld, lanes, slice_len, slices, vec
    assert mx[3:11] == (1, 8192, 4096, 8192, 1, slice_len, slices, 1)
    # x, scratch, plane, pre, is_f64, fp8, rows, cols, ld, slice_len,
    # slices, vec, max_ufp
    assert cl[4:13] == (1, 0, 8192, 4096, 8192, slice_len, slices, 1,
                        quantize.MAX_UFP["INT8"])
    fake_card.clear()
    kernels.extract_ub(_meta((64, 8192)), "FP8", 0)
    (_, rw), = fake_card
    # x, plane, pre, is_f64, fp8, rows, cols, ld, threads, vec, max_ufp
    assert rw[3:11] == (1, 1, 64, 8192, 8192,
                        kernels.shift_row_threads(8192, 2), 1,
                        quantize.MAX_UFP["FP8"])


@pytest.mark.parametrize("scale_axis", [0, 1])
def test_transposed_views_take_the_other_route(fake_card, scale_axis):
    """A transposed view is read as its transpose along the other axis
    (syrk's A.T, trans ops), and its plane is transposed back: still
    contiguous along the reduce axis."""
    x = _meta((300, 128)).T                      # (128, 300), columns dense
    ub, pre = kernels.extract_ub(x, "INT8", scale_axis)
    route = [c[0] for c in fake_card]
    assert route == (["shift_cols_max", "extract_cols"] if scale_axis == 0
                     else ["extract_rows"])
    assert ub.shape == (128, 300) and pre.shape == (x.shape[scale_axis],)
    assert ub.stride(1 - scale_axis) == 1


def test_empty_scale_axis_launches_nothing(fake_card):
    ub, pre = kernels.extract_ub(_meta((0, 16)), "INT8", 0)
    assert ub.shape == (0, 16) and pre.shape == (0,) and not fake_card


def test_launch_count_is_kept_and_reset():
    assert "extract_ub" in kernels.LAUNCHES
    kernels.LAUNCHES["extract_ub"] = 5
    kernels.reset_launches()
    assert kernels.LAUNCHES["extract_ub"] == 0
