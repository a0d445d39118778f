"""The main path's int8 products on the CPU: core.residue_matmul, which on the
card takes one launch of the wgmma kernel (kernels.matmul_i8, which refuses
planes kernels.tma_addressable rejects). Here: matmul_i8's `out`, whether
TMA can address the views the main path hands the products (in-place K
slices of A and of k-contiguous B, the complex lanes' 3nu stack), the
refusal off the CPU, and residue_matmul's bits across the K_CHUNK boundary
against the plain product.
"""
import numpy as np
import pytest
import torch

from gemmul8_tpu_torch import core, kernels, tables
from gemmul8_tpu_torch.probes.timing import k_contiguous


def _planes(seed, nu, m, k, n, extreme=False):
    """int8 planes: uniform in [-127, 127], or +-127 (the largest sums)."""
    rng = np.random.default_rng(seed)
    if extreme:
        a = rng.choice(np.array([-127, 127], np.int8), (nu, m, k))
        b = rng.choice(np.array([-127, 127], np.int8), (nu, k, n))
    else:
        a = rng.integers(-127, 128, (nu, m, k)).astype(np.int8)
        b = rng.integers(-127, 128, (nu, k, n)).astype(np.int8)
    return torch.from_numpy(a), torch.from_numpy(b)


def _misaligned(t):
    """A copy of t whose storage starts one byte past an aligned address."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:]
    return flat.view(t.shape).copy_(t)


def _on_meta(t):
    """A view on the meta device with t's shape, strides and storage offset
    (its data_ptr is that offset: the CPU's allocations are 16-byte
    aligned, so the alignment is t's)."""
    storage = torch.empty(t.untyped_storage().nbytes(), dtype=torch.int8,
                          device="meta")
    return storage.as_strided(t.shape, t.stride(), t.storage_offset())


@pytest.mark.parametrize("b_layout", ["n", "k"])
@pytest.mark.parametrize("schedule", ["kloop", "astat"])
def test_matmul_i8_fills_out(b_layout, schedule):
    """`out` is written and returned, and holds the plain product."""
    kernels.reset_launches()
    a, b = _planes(1, 3, 20, 48, 24)
    bb = b if b_layout == "n" else k_contiguous(b)
    out = torch.full((3, 20, 24), 7, dtype=torch.int32)
    got = kernels.matmul_i8(a, bb, schedule, out=out)
    assert got is out
    assert torch.equal(out, kernels.matmul_i8_plain(a, b))
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("what,out", [
    ("shape", torch.empty((3, 20, 25), dtype=torch.int32)),
    ("planes", torch.empty((2, 20, 24), dtype=torch.int32)),
    ("dtype", torch.empty((3, 20, 24), dtype=torch.int64)),
    ("float", torch.empty((3, 20, 24), dtype=torch.float32)),
    ("layout", torch.empty((3, 24, 20), dtype=torch.int32).transpose(1, 2)),
    ("strided", torch.empty((3, 20, 48), dtype=torch.int32)[:, :, ::2]),
    ("device", torch.empty((3, 20, 24), dtype=torch.int32, device="meta")),
])
def test_matmul_i8_refuses_a_wrong_out(what, out):
    a, b = _planes(2, 3, 20, 48, 24)
    with pytest.raises(ValueError, match="out must be a contiguous int32"):
        kernels.matmul_i8(a, k_contiguous(b), out=out)


def _k_slices(a, b_kc, lo, hi):
    return a[:, :, lo:hi], b_kc[:, lo:hi, :]


@pytest.mark.parametrize("lo,hi", [(0, 64), (64, 192), (128, 256), (16, 48),
                                   (240, 256)])
def test_product_route_takes_k_slices_in_place(lo, hi):
    """K slices of A (nu, m, K) and of k-contiguous B, as _chunked_residue_acc
    and SUMMA's panels pass them: no copy, row pitch K bytes, base lo bytes
    in; TMA can address them where lo, hi - lo and K are multiples of 16,
    and the plain product of the views is that of contiguous copies."""
    a, b = _planes(3, 2, 24, 256, 40)
    b_kc = k_contiguous(b)
    sa, sb = _k_slices(a, b_kc, lo, hi)
    assert not sa.is_contiguous() or lo == 0 and hi == 256
    assert kernels._b_layout(sb) is True
    assert kernels._tma_pitches(sa) == (256, 24 * 256)
    assert kernels._tma_pitches(sb.transpose(-1, -2)) == (256, 40 * 256)
    assert kernels.tma_addressable(sa, sb) is True
    got = kernels.matmul_i8(sa, sb)
    assert torch.equal(got, kernels.matmul_i8_plain(sa.contiguous(),
                                                    sb.contiguous()))


@pytest.mark.parametrize("case", ["base8", "base1", "pitch_a", "pitch_b",
                                  "k_odd", "b_n_slice"])
def test_product_route_refuses_what_tma_cannot_address(case):
    """A slice whose base is off 16 bytes, a row pitch off 16 bytes (A or
    B), k off 16, and a K slice of n-contiguous B (which transpose_i8 cannot
    read) are not TMA-addressable: the CPU takes the plain product of the
    views, and off the CPU (the same views on the meta device) matmul_i8
    refuses them."""
    a, b = _planes(4, 2, 24, 264, 40)
    b_kc = k_contiguous(b)
    if case == "base8":
        sa, sb = _k_slices(a, b_kc, 8, 136)
    elif case == "base1":
        sa, sb = _k_slices(a, b_kc, 1, 129)
    elif case == "pitch_a":             # row pitch 264 bytes: not 16 x
        sa, sb = a[:, :, :128], k_contiguous(b[:, :128])
    elif case == "pitch_b":
        sa, sb = a[:, :, :128].contiguous(), b_kc[:, :128, :]
    elif case == "k_odd":
        sa, sb = a[:, :, :40].contiguous(), b_kc[:, :40, :].contiguous()
        sa, sb = sa[:, :, :36], sb[:, :36, :]
    else:
        sa, sb = a[:, :, :128].contiguous(), b[:, :128, :]
    assert kernels.tma_addressable(sa, sb) is False
    assert torch.equal(kernels.matmul_i8(sa, sb),
                       kernels.matmul_i8_plain(sa.contiguous(),
                                               sb.contiguous()))
    with pytest.raises(ValueError, match="TMA-addressable"):
        kernels.matmul_i8(_on_meta(sa), _on_meta(sb))


def test_product_route_takes_the_complex_lanes_stack():
    """_complex_product's pa.reshape(3 nu, ...) and pb.reshape(3 nu, ...) of
    the lanes' plane buffers are views that take one wgmma launch of 3nu
    planes."""
    nu, m, k, n = 4, 24, 128, 40
    pa = kernels.plane_buffer((3, nu), m, k, 0, "cpu")
    pb = kernels.plane_buffer((3, nu), k, n, 1, "cpu")
    a, b = _planes(5, 3 * nu, m, k, n)
    pa.copy_(a.view(3, nu, m, k))
    pb.copy_(b.view(3, nu, k, n))
    ra, rb = pa.reshape(3 * nu, m, k), pb.reshape(3 * nu, k, n)
    assert ra.data_ptr() == pa.data_ptr() and rb.data_ptr() == pb.data_ptr()
    assert kernels._b_layout(rb) is True
    assert kernels.tma_addressable(ra, rb) is True
    assert torch.equal(core.residue_matmul(ra, rb),
                       kernels.matmul_i8_plain(a, b))


@pytest.mark.parametrize("m,k,n", [(64, 128, 96), (128, 8192, 256),
                                   (1, 16, 1)])
def test_product_route_takes_the_main_path_planes(m, k, n):
    """The planes plane_buffer lays out for A (row-major) and B
    (k-contiguous) at k a multiple of 16 are TMA-addressable, and their
    misaligned copies are not."""
    a = kernels.plane_buffer((16,), m, k, 0, "cpu")
    b = kernels.plane_buffer((16,), k, n, 1, "cpu")
    assert kernels.tma_addressable(a, b) is True
    assert kernels.tma_addressable(_misaligned(a), b) is False


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("b_layout", ["n", "k"])
def test_residue_matmul_bit_equal_across_k_chunk(extreme, b_layout):
    """residue_matmul on the CPU at k = K_CHUNK + 128, on the whole K (int32
    sums that wrap, as the kernels' do) and on each K_CHUNK slice that
    _chunked_residue_acc hands it, bit-equal to matmul_i8_plain; the
    accumulator equals the sum of the slices' residues; nothing is counted
    in LAUNCHES on the CPU."""
    kernels.reset_launches()
    nu, m, n = 2, 3, 5
    k = core.K_CHUNK + 128
    a, b = _planes(6, nu, m, k, n, extreme)
    bb = b if b_layout == "n" else k_contiguous(b)
    assert torch.equal(core.residue_matmul(a, bb),
                       kernels.matmul_i8_plain(a, b))
    mods = tables.moduli("INT8")[:nu]
    want = 0
    for lo in (0, core.K_CHUNK):
        sl = slice(lo, min(lo + core.K_CHUNK, k))
        got = core.residue_matmul(a[:, :, sl], bb[:, sl, :])
        plain = kernels.matmul_i8_plain(a[:, :, sl].contiguous(),
                                        b[:, sl, :].contiguous())
        assert torch.equal(got, plain)
        want = want + torch.stack([torch.remainder(plain[i], p)
                                   for i, p in enumerate(mods)])
    assert torch.equal(core._chunked_residue_acc(a, bb, nu, "INT8"), want)
    assert not any(kernels.LAUNCHES.values())


def test_residue_matmul_fills_out_on_the_cpu():
    a, b = _planes(7, 3, 8, 32, 6)
    out = torch.zeros((3, 8, 6), dtype=torch.int32)
    assert core.residue_matmul(a, k_contiguous(b), out=out) is out
    assert torch.equal(out, kernels.matmul_i8_plain(a, b))


def _meta_views(case):
    """Views on the meta device (no storage: the predicate reads only shapes
    and strides) that TMA cannot address: k off 16, A's row pitch off 16
    bytes, and a K slice of n-contiguous B."""
    a = torch.empty((2, 24, 264), dtype=torch.int8, device="meta")
    b_kc = torch.empty((2, 40, 264), dtype=torch.int8,
                       device="meta").transpose(1, 2)
    if case == "k_odd":
        return a[:, :, :36], b_kc[:, :36, :]
    if case == "pitch_a":
        return a[:, :, :128], b_kc[:, :128, :]
    b_n = torch.empty((2, 264, 40), dtype=torch.int8, device="meta")
    return a[:, :, :128].contiguous(), b_n[:, :128, :]


@pytest.mark.parametrize("case", ["k_odd", "pitch_a", "b_n_slice"])
def test_residue_matmul_refuses_what_tma_cannot_address_off_the_cpu(case):
    """Off the CPU residue_matmul has one product, the wgmma kernel: planes
    it cannot read raise (the entries pad theirs to 128), while the same
    layout's planes at k = 128 are TMA-addressable."""
    sa, sb = _meta_views(case)
    assert kernels.tma_addressable(sa, sb) is False
    with pytest.raises(ValueError, match="TMA-addressable"):
        core.residue_matmul(sa, sb)
    a = torch.empty((2, 24, 128), dtype=torch.int8, device="meta")
    b = torch.empty((2, 40, 128), dtype=torch.int8,
                    device="meta").transpose(1, 2)
    assert kernels.tma_addressable(a, b) is True


@pytest.mark.parametrize("case", [97, 33, 8, 0, "k_odd", "pitch_a",
                                  "b_n_slice"])
def test_matmul_i8_refuses_what_tma_cannot_address_off_the_cpu(case):
    """Off the CPU matmul_i8 itself refuses planes TMA cannot address, with
    the rule in its message, before it looks at the device: contiguous
    planes at k off 16 or k = 0, and _meta_views' strided ones."""
    if isinstance(case, int):
        sa = torch.empty((2, 20, case), dtype=torch.int8, device="meta")
        sb = torch.empty((2, case, 24), dtype=torch.int8, device="meta")
    else:
        sa, sb = _meta_views(case)
    assert kernels.tma_addressable(sa, sb) is False
    with pytest.raises(ValueError, match="TMA-addressable .*k a multiple "
                                         "of 16"):
        kernels.matmul_i8(sa, sb)
