"""The redesigned FP8 encoder (K6, csrc/encode_fp8.cu) and tensor-core CRT
epilogue (K8, csrc/epilogue_mxu.cu), mirrored in numpy where the CPU cannot
run them: the conversions K6 makes without the conversion pipe, its plane
map, K8's wrap, its tiling and its mma fragments, and both wrappers' vector
rules. numpy and torch only (the JAX comparisons of both kernels' plain
versions are in tests/test_torch_fp8.py and tests/test_torch_probe_epilogue.py).
"""
import math
import os
import re

import numpy as np
import pytest
import torch

from gemmul8_tpu_torch import ff, fp8, kernels, tables

F32 = np.float32
ROUND = F32(12582912.0)             # 1.5 * 2^23 (encode_fp8.cu: kRound)
M32 = np.uint64(0xFFFFFFFF)


def _source(name):
    return open(os.path.join(kernels._CSRC, name)).read()


# ---------------------------------------------------------------------------
# K6's conversions
# ---------------------------------------------------------------------------

def int_to_f32(v):
    """encode_fp8.cu's int_to_f32: the bits 0x4B400000 + v as f32, less
    1.5 * 2^23."""
    bits = (np.int64(0x4B400000) + np.asarray(v, np.int64)).astype(np.uint32)
    return bits.view(F32) - ROUND


def rint_f32(x):
    """encode_fp8.cu's rint_f32: (x + 1.5 * 2^23) - 1.5 * 2^23 in f32, with
    x's sign."""
    x = np.asarray(x, F32)
    return np.copysign((x + ROUND) - ROUND, x)


def e4m3_byte(x):
    """The e4m3 byte of an f32 that e4m3 holds exactly (|x| <= 448, at most
    4 significant bits, normal or zero): sign, biased exponent (bias 7),
    3 mantissa bits, as cvt.rn.satfinite.e4m3x2.f32 writes it."""
    x = np.asarray(x, F32)
    sign = (np.signbit(x).astype(np.uint8)) << 7
    a = np.abs(x).astype(np.float64)
    e = np.floor(np.log2(np.where(a > 0, a, 1.0))).astype(np.int64)
    mant = np.round((a / 2.0 ** e - 1.0) * 8).astype(np.int64)
    assert np.all((a == 0) | ((mant >= 0) & (mant < 8) & (e >= -6)))
    assert np.array_equal(np.where(a > 0, (1 + mant / 8) * 2.0 ** e, 0.0), a)
    byte = np.where(a > 0, ((e + 7) << 3) | mant, 0)
    return (sign | byte).astype(np.uint8)


def _torch_bytes(x):
    return torch.from_numpy(np.asarray(x, F32)).to(torch.float8_e4m3fn) \
        .view(torch.uint8).numpy()


def test_e4m3_bytes_of_every_split_value():
    """Every value K6 converts -- the integers in [-16, 16] and -0 -- has the
    same e4m3 byte from the kernel's conversion (mirrored) as from torch's
    float8_e4m3fn cast, which the plain version takes."""
    v = np.concatenate([np.arange(-16, 17, dtype=F32), [F32(-0.0)]])
    np.testing.assert_array_equal(e4m3_byte(v), _torch_bytes(v))
    assert e4m3_byte(F32(-0.0)) == 0x80 and e4m3_byte(F32(16)) == 0x58


def test_int_to_f32_equals_the_conversion():
    """int_to_f32 gives (float)v's bits for every v in [-2^22, 2^22], 0 as
    +0 included."""
    v = np.arange(-2 ** 22, 2 ** 22 + 1, dtype=np.int64)
    np.testing.assert_array_equal(int_to_f32(v).view(np.uint32),
                                  v.astype(F32).view(np.uint32))


def test_rint_f32_equals_rintf():
    """rint_f32 gives rintf's bits (ties to even, -0 for x in [-0.5, 0)) on
    every product rf * f32(1/q) of the square split, on the ties and their
    neighbours, and on a sample up to 2^22."""
    xs = []
    for q in fp8._sqrt_moduli():
        r = np.arange(-(q * q) // 2, (q * q) - (q * q) // 2, dtype=np.int64)
        xs.append(r.astype(F32) * F32(np.float32(1.0 / q)))
    k = np.arange(-40, 41, dtype=F32)
    ties = k + F32(0.5)
    xs += [ties, np.nextafter(ties, F32(np.inf)), np.nextafter(ties, -F32(np.inf)),
           k, F32([-0.0, 0.0, -1e-30, 1e-30])]
    rng = np.random.default_rng(8)
    xs.append((rng.random(100000) * 2 ** 23 - 2 ** 22).astype(F32))
    x = np.concatenate(xs)
    np.testing.assert_array_equal(rint_f32(x).view(np.uint32),
                                  np.rint(x).view(np.uint32))


def _kernel_split(r, i):
    """K6's split of residues r of modulus i, mirrored: the planes' e4m3
    bytes (x, y, z; z is y again for a square modulus)."""
    if i < tables.NOT_KARATSUBA:
        q = fp8._sqrt_moduli()[i]
        rf = int_to_f32(r)
        bx = rint_f32(rf * F32(np.float32(1.0 / q)))
        by = rf - F32(q) * bx
        return e4m3_byte(bx), e4m3_byte(by), e4m3_byte(by)
    mag = (np.abs(r) + 15) >> 4
    x = np.where(r < 0, -mag, mag)
    y = r - 16 * x
    return e4m3_byte(int_to_f32(x)), e4m3_byte(int_to_f32(y)), \
        e4m3_byte(int_to_f32(x + y))


@pytest.mark.parametrize("i", range(20))
def test_split_bytes_equal_split_planes(i):
    """For every residue of FP8 modulus i, K6's mirrored split gives the
    bytes of fp8.split_planes (the plain version), -0 included."""
    p = tables.moduli("FP8")[i]
    r = np.arange(-(p // 2), p - p // 2, dtype=np.int64)
    res = torch.zeros((i + 1, 1, r.size), dtype=torch.int32)
    res[i, 0] = torch.from_numpy(r.astype(np.int32))
    planes = fp8.split_planes(res, i + 1)[i, :, 0].view(torch.uint8).numpy()
    x, y, z = _kernel_split(r, i)
    np.testing.assert_array_equal(x, planes[0])
    np.testing.assert_array_equal(y, planes[1])
    if i >= tables.NOT_KARATSUBA:
        np.testing.assert_array_equal(z, planes[2])


# ---------------------------------------------------------------------------
# K6's plane map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", ["lhs", "rhs"])
def test_plane_map_equals_slot_order(side):
    """For every nu from 1 to 20, each modulus' planes (x, y, and z or y
    again) are the stack's planes of its slots in fp8.slot_order, each of
    its three planes exactly once, and the plan carries them."""
    for nu in range(1, 21):
        order = fp8.slot_order(nu, side)
        pmap = kernels.fp8_plane_map(nu, side)
        plan = kernels._encode_plan_fp8(nu, side)
        for i, (x, y, z) in enumerate(pmap):
            square = i < tables.NOT_KARATSUBA
            assert order[x] == (i, 0) and order[y] == (i, 1)
            assert order[z] == (i, 1 if square else 2)
            assert sorted((x, y, z)) == [3 * i, 3 * i + 1, 3 * i + 2]
            assert tuple(plan.plane[i]) == (x, y, z)


def test_stack_from_plane_map_equals_gemm_stack():
    """Writing each modulus' split values through the plane map builds the
    stack fp8._gemm_stack builds, on both sides."""
    rng = np.random.default_rng(3)
    nu = 14
    mods = tables.moduli("FP8")[:nu]
    res = torch.from_numpy(np.stack([rng.integers(-(p // 2), p - p // 2,
                                                  (5, 7)) for p in mods])
                           .astype(np.int32))
    canon = fp8.split_planes(res, nu)
    for side in ("lhs", "rhs"):
        stack = torch.empty((3 * nu, 5, 7), dtype=torch.float8_e4m3fn)
        for i, (x, y, z) in enumerate(kernels.fp8_plane_map(nu, side)):
            stack[x], stack[y] = canon[i, 0], canon[i, 1]
            stack[z] = canon[i, 1 if i < tables.NOT_KARATSUBA else 2]
        ref = fp8._gemm_stack(canon, nu, side)
        assert torch.equal(stack.view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.parametrize("define,value", [
    ("G8_NOT_KARATSUBA", tables.NOT_KARATSUBA), ("G8_MAX_NU", 20),
    ("G8_MXU_COLS", 16), ("G8_MXU_K", 32)])
def test_common_cuh_constants_fit(define, value):
    """common.cuh's constants of the K6 and K8 plans against the Python
    side's."""
    got = re.search(r"#define %s (\d+)" % define, _source("common.cuh"))
    assert int(got.group(1)) == value
    assert value == {"G8_NOT_KARATSUBA": tables.NOT_KARATSUBA,
                     "G8_MAX_NU": kernels._MAX_NU,
                     "G8_MXU_COLS": kernels._MXU_COLS,
                     "G8_MXU_K": kernels._MXU_K}[define]


# ---------------------------------------------------------------------------
# K6's vector rule and its out argument
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 3, 4, 5, 8, 130, 132, 263])
def test_fp8_encode_vec_rule(width):
    """K6 stores words (and A reads 16-byte vectors) only where the planes'
    contiguous axis is a multiple of 4 and out (for A, x too) is 16-byte
    aligned; K6's stacks in plane_buffer's layout meet it wherever the
    width allows."""
    for axis in (0, 1):
        shape = (7, width) if axis == 0 else (width, 7)
        x = torch.zeros(shape, dtype=torch.float64)
        out = kernels.plane_buffer((6,), *shape, axis, "cpu",
                                   torch.float8_e4m3fn)
        assert kernels._encode_vec(x, out, axis) == (width % 4 == 0)
        buf = torch.empty(out.numel() + 16, dtype=torch.float8_e4m3fn)[1:]
        moved = buf[:out.numel()].view(out.transpose(-1, -2).shape
                                       if axis else out.shape)
        moved = moved.transpose(-1, -2) if axis else moved
        assert not kernels._encode_vec(x, moved, axis)
        xm = torch.zeros(x.numel() + 1, dtype=torch.float64)[1:].view(shape)
        assert kernels._encode_vec(xm, out, axis) == (
            axis == 1 and width % 4 == 0)


def test_fp8_encode_cpu_out_argument():
    """On the CPU encode_planes_fp8 writes its out argument with the plain
    version's bytes and returns it, and counts no launch."""
    from gemmul8_tpu_torch import quantize
    kernels.reset_launches()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((9, 13)))
    for axis in (0, 1):
        sft = quantize.shift_fast(x, 7, "FP8", 1 - axis)
        out = kernels.plane_buffer((21,), 9, 13, axis, "cpu",
                                   torch.float8_e4m3fn)
        got = kernels.encode_planes_fp8(x, sft, axis, 7, out)
        assert got is out
        ref = kernels.encode_planes_fp8_plain(x, sft, axis, 7)
        assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
    assert not any(kernels.LAUNCHES.values())


# ---------------------------------------------------------------------------
# K8's wrap
# ---------------------------------------------------------------------------

def wrap_mulhi(v, p):
    """crt.cuh's wrap_mulhi in uint64 arithmetic, for any p (no mask)."""
    magic, off = kernels.wrap_constants(p)
    u = (np.asarray(v, np.int64).astype(np.uint64) & M32) ^ np.uint64(2 ** 31)
    r = (u - ((u * np.uint64(magic)) >> np.uint64(32)) * np.uint64(p)) & M32
    r = np.minimum(r, (r - np.uint64(p)) & M32)
    r = (r + np.uint64(off)) & M32
    r = np.minimum(r, (r - np.uint64(p)) & M32)
    return r.astype(np.int64) - p // 2


def test_wrap_mulhi_exact_for_powers_of_two():
    """K8 wraps 256 by the multiply-high too (no mask): exact at the int32
    edges and on a sample, as for the other moduli."""
    rng = np.random.default_rng(6)
    v = np.concatenate([[-2 ** 31, 2 ** 31 - 1, 0, -1, 1, 127, 128, -128,
                         -129], rng.integers(-2 ** 31, 2 ** 31, 100000)])
    for p in (256, 1024) + tuple(tables.moduli("INT8")[:4]):
        np.testing.assert_array_equal(wrap_mulhi(v, p),
                                      (v + p // 2) % p - p // 2)


def test_probe_f32_wrap_is_exact_for_every_int32():
    """The probe's f32 wrap (K8's plain version) gives the exact wrap of
    every int32: its t = hi16 * wrap(2^16 mod p) + lo16 ranges over an
    interval (|w2| <= 2^16) that this checks whole, for every INT8
    modulus, so K8's exact wrap equals it bit for bit."""
    mods, w2, inv = kernels._mxu_constants(20, "INT8")
    for p, w, ip in zip(mods, w2, inv):
        assert abs(w) < 2 ** 16
        lo = min(-32768 * w, 32767 * w)
        hi = max(-32768 * w, 32767 * w) + 65535
        assert abs(lo) < 2 ** 24 and abs(hi) < 2 ** 24
        for s in range(lo, hi + 1, 1 << 22):
            t = np.arange(s, min(s + (1 << 22), hi + 1), dtype=np.int64)
            tf = t.astype(F32)
            pf = F32(p)
            r = tf - np.rint(tf * F32(ip)) * pf
            r = np.where(F32(2) * r >= pf, r - pf, r)
            r = np.where(F32(2) * r < -pf, r + pf, r)
            np.testing.assert_array_equal(r.astype(np.int64),
                                          (t + p // 2) % p - p // 2,
                                          err_msg=f"p={p}")


# ---------------------------------------------------------------------------
# K8's tiling, fragments and staging
# ---------------------------------------------------------------------------

STRIP, GROUP, SLOTS = 64, 4, 10        # epilogue_mxu.cu: kStrip, kGroup, kSlots


def test_mxu_constants_match_the_source():
    text = _source("epilogue_mxu.cu")
    for name, value in (("kStrip", STRIP), ("kGroup", GROUP),
                        ("kSlots", SLOTS), ("kMods", 5)):
        got = re.search(r"constexpr int %s = (\d+);" % name, text)
        assert int(got.group(1)) == value, name
    assert kernels.MXU_GROUP == GROUP


def mxu_cover(m, n, nu, vec, max_grid_y=65535):
    """epilogue_mxu.cu's grid and index map in numpy: how often each (plane,
    i, j) is loaded and each (i, j) emitted. With vec, also checks that
    every load is a whole 16-byte-aligned vector."""
    rows = kernels._TILE_ROWS
    gx = math.ceil(n / STRIP)
    gy = min(math.ceil(m / rows), max_grid_y)
    loads = np.zeros((nu, m, n), np.int64)
    emits = np.zeros((m, n), np.int64)
    for bx in range(gx):
        c0 = bx * STRIP
        for by in range(gy):
            for ty in range(rows):
                for i in range(by * rows + ty, m, gy * rows):
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        for h in range(2):
                            j0 = c0 + 32 * h + 4 * g
                            nv = max(0, min(GROUP, n - j0))
                            for u in range(5):
                                q = t + 4 * u
                                if q < nu and nv > 0:
                                    if vec:
                                        assert nv == GROUP
                                        assert ((q * m * n + i * n + j0) * 4) \
                                            % 16 == 0
                                    loads[q, i, j0:j0 + nv] += 1
                            j = c0 + 32 * h + lane
                            if j < n:
                                emits[i, j] += 1
    return loads, emits


@pytest.mark.parametrize("shape", [(129, 263), (1, 263), (129, 1), (33, 20),
                                   (31, 9), (17, 264), (64, 256), (5, 65)])
def test_mxu_tiles_cover_every_element_once(shape):
    """Every C_hi element of every plane is loaded exactly once and every
    output element emitted once, on the one-column route always and on the
    vector route where n allows it, also when the rows outnumber the grid's
    y extent."""
    m, n = shape
    for nu in (8, 16, 20):
        for vec in {False, n % GROUP == 0}:
            for max_y in (65535, 1, 3):
                loads, emits = mxu_cover(m, n, nu, vec, max_y)
                assert (loads == 1).all() and (emits == 1).all(), \
                    (nu, vec, max_y)


def _word(bytes4):
    """Four bytes (byte k from bytes4[k]) as a 32-bit register."""
    return int(np.asarray(bytes4, np.int64).astype(np.uint8)
               .view(np.uint32)[0])


def _bytes(word, dtype):
    """A 32-bit register's four bytes, byte k first, as int8 or uint8."""
    return np.frombuffer(np.uint32(word).tobytes(), dtype).astype(np.int64)


def mma_m16n8k32(a_regs, b_regs):
    """mma.sync.m16n8k32 (s8 x u8 -> s32) from the 32 lanes' fragments, in
    PTX's fragment layout: lane (g, t) holds A rows g (a0, a2) and g + 8 (a1,
    a3) at depths 4t.. (a0, a1) and 16+4t.. (a2, a3); B column g at depths
    4t.. (b0) and 16+4t.. (b1); it gets D rows g (d0, d1) and g + 8 (d2, d3)
    at columns 2t, 2t + 1."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        a0, a1, a2, a3 = (_bytes(a_regs[lane][r], np.int8) for r in range(4))
        A[g, 4 * t:4 * t + 4], A[g + 8, 4 * t:4 * t + 4] = a0, a1
        A[g, 16 + 4 * t:20 + 4 * t], A[g + 8, 16 + 4 * t:20 + 4 * t] = a2, a3
        b0, b1 = (_bytes(b_regs[lane][r], np.uint8) for r in range(2))
        B[4 * t:4 * t + 4, g], B[16 + 4 * t:20 + 4 * t, g] = b0, b1
    D = A @ B
    return [(D[lane >> 2, 2 * (lane & 3)], D[lane >> 2, 2 * (lane & 3) + 1],
             D[(lane >> 2) + 8, 2 * (lane & 3)],
             D[(lane >> 2) + 8, 2 * (lane & 3) + 1]) for lane in range(32)]


@pytest.mark.parametrize("nu,out_bits", [(8, 53), (16, 53), (20, 53),
                                         (16, 24), (3, 24)])
def test_mxu_fragments_give_the_crt_limbs(nu, out_bits):
    """One warp's strip of 64 elements through K8's steps in numpy: each
    lane packs its moduli t + 4u into A words, the plan's c8 in depth order
    gives the B words, two mma per 16 elements give the column sums, and
    the staging slots hand each lane the limbs of strip columns lane and
    32 + lane; they equal the plain version's limbs r . C (column pairs as
    16-bit limbs) for every element."""
    rng = np.random.default_rng(nu + out_bits)
    plan = kernels._epilogue_plan_mxu(nu, "INT8", out_bits)
    L = plan.crt.L
    _, n_cols, C, _, _ = ff._crt_matrix_plan(nu, "INT8", out_bits)
    r = rng.integers(-128, 128, (STRIP, nu))          # element x modulus
    r[0], r[1] = -128, 127
    c8 = np.array([[plan.c8[j][k] for k in range(32)] for j in range(16)],
                  np.uint8)
    for i in range(nu):                                # the depth order
        assert list(c8[:, kernels.mxu_depth(i)]) == \
            [int(C[i, j]) if j < n_cols else 0 for j in range(16)]
    used = {kernels.mxu_depth(i) for i in range(nu)}
    assert len(used) == nu and not c8[:, sorted(set(range(32)) - used)].any()

    def res(elem, q):
        return r[elem, q] if q < nu else 0

    staged = np.zeros(STRIP * SLOTS, np.int64)
    for e in range(GROUP):
        a_regs, b_regs = [], {0: [], 1: []}
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            regs = []
            for h in range(2):                          # rows g, g + 8
                elem = 32 * h + 4 * g + e
                regs.append(_word([res(elem, t + 4 * u) for u in range(4)]))
            for h in range(2):
                elem = 32 * h + 4 * g + e
                regs.append(_word([res(elem, 16 + t), 0, 0, 0]))
            a_regs.append(regs)                         # a0, a1, a2, a3
            for hc in range(2):
                col = 8 * hc + g
                b_regs[hc].append((_word(c8[col, 4 * t:4 * t + 4]),
                                   _word(c8[col, 16 + 4 * t:20 + 4 * t])))
        d = {hc: mma_m16n8k32(a_regs, b_regs[hc]) for hc in range(2)}
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for h in range(2):
                elem = 32 * h + 4 * g + e
                for hc in range(2):
                    d0, d1, d2, d3 = d[hc][lane]
                    limb = d0 + 256 * d1 if h == 0 else d2 + 256 * d3
                    staged[elem * SLOTS + 2 * t + hc] = limb
    cols = r @ np.asarray(C, np.int64)                   # (64, n_cols)
    for lane in range(32):
        for h in range(2):
            elem = 32 * h + lane
            slots = staged[elem * SLOTS:elem * SLOTS + 8]
            got = [slots[2 * (li % 4) + li // 4] for li in range(L)]
            want = [cols[elem, 2 * li] + (cols[elem, 2 * li + 1] << 8
                                          if 2 * li + 1 < n_cols else 0)
                    for li in range(L)]
            assert got == want, (lane, h)


def test_mxu_staging_is_free_of_bank_conflicts():
    """The 8-byte staging stores (lane (g, t): element 4g + e, slot 2t) and
    loads (lane l: element l, slot 2k) of each half-warp fall in distinct
    bank pairs at kSlots = 10 words an element, both aligned to 8 bytes."""
    for e in range(GROUP):
        for half in range(2):
            words = [(4 * (lane >> 2) + e) * SLOTS + 2 * (lane & 3)
                     for lane in range(16 * half, 16 * half + 16)]
            assert all(w % 2 == 0 for w in words)
            assert len({w % 32 for w in words}) == 16
    for k in range(4):
        for half in range(2):
            words = [lane * SLOTS + 2 * k
                     for lane in range(16 * half, 16 * half + 16)]
            assert len({w % 32 for w in words}) == 16


@pytest.mark.parametrize("n", [1, 3, 4, 20, 263, 264])
def test_mxu_vec_rule(n):
    """K8 loads 16-byte vectors only where n is a multiple of 4 and C_hi is
    16-byte aligned."""
    chi = torch.zeros((3, 5, n), dtype=torch.int32)
    aligned = chi.data_ptr() % 16 == 0
    assert kernels._epilogue_vec(n, kernels.MXU_GROUP, chi) == (
        n % 4 == 0 and aligned)
    moved = torch.zeros(chi.numel() + 1, dtype=torch.int32)[1:].view(chi.shape)
    assert not kernels._epilogue_vec(n, kernels.MXU_GROUP, moved)
