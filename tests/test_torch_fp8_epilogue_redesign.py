"""The redesigned FP8 fused epilogue (K3, csrc/epilogue_fp8.cu), mirrored in
numpy where the CPU cannot run it: its reassembly of each modulus' residue
in exact f32 steps, held against fp8._reassemble on every FP8 modulus; the
limbs' start that takes the residues' offsets out; its plan; its tiling,
its loops over the moduli and its vector rule; the names of the kernels the
ablation probe times. numpy and torch only (K3's plain version is held
against the JAX package's fused_epilogue_fp8 in tests/test_torch_fp8.py).

Every f32 step of the reassembly is one of two kinds, and the mirror checks
the condition that makes each exact:
  - fma(x, 1/p, M) - M with M = 1.5 * 2^23: x * (1/p) is exact in f64 (two
    24-bit significands), and while |x * (1/p)| < 2^22 the fma's sum lies in
    [2^23, 2^24), where f32's spacing is 1: it is M + rint(x * (1/p)), ties
    to even (M is even), and subtracting M is exact;
  - an add, multiply or fma of f32 integers whose exact result is an
    integer of magnitude <= 2^24: f32 holds it, so the step returns it.
"""
import functools
import math
import os
import re

import numpy as np
import pytest
import torch

from gemmul8_tpu_torch import fp8, kernels, tables
from gemmul8_tpu_torch.probes import epilogue_tiles, fp8_calls

F32 = np.float32
MAGIC = 12582912                    # 1.5 * 2^23 (epilogue_fp8.cu: kMagic)
MODULI = tables.moduli("FP8")
M32 = (1 << 32) - 1


def _source(name):
    return open(os.path.join(kernels._CSRC, name)).read()


# ---------------------------------------------------------------------------
# the reassembly's f32 steps
# ---------------------------------------------------------------------------

def f32_int(v):
    """v (integers) as the f32 integers a step yields: |v| <= 2^24."""
    v = np.asarray(v, np.int64)
    assert np.abs(v).max(initial=0) <= 1 << 24
    return v


def magic_rint(x, inv_p):
    """fma(x, inv_p, M) - M for f32 integers x: rint(x * inv_p), ties to
    even."""
    prod = np.asarray(x, np.int64).astype(np.float64) * np.float64(inv_p)
    assert np.abs(prod).max(initial=0) < 1 << 22
    return np.rint(prod).astype(np.int64)


def fma_int(a, b, c):
    """fma(a, b, c) of f32 integers with an integer result f32 holds."""
    return f32_int(np.asarray(a, np.int64) * b + np.asarray(c, np.int64))


def near_wrap(c, p):
    """near_wrap: k = fma(c, 1/p, M) - M, r = fma(k, -p, c)."""
    return fma_int(magic_rint(f32_int(c), F32(1.0 / p)), -p, c)


def reassemble_bits(c0, c1, c2, i):
    """The unsigned value epilogue_fp8.cu's reassemble gives modulus i's
    lane products: 0x4B400000 + r, or r + 512 for p = 1024."""
    p = MODULI[i]
    r0, r1, r2 = (near_wrap(c, p) for c in (c0, c1, c2))
    for r in (r0, r1, r2):
        assert np.abs(r).max() <= p // 2 + 1
    if i < tables.NOT_KARATSUBA:
        t = fma_int(f32_int(r0 + r1), fp8._sqrt_moduli()[i], r2)
    else:
        t = fma_int(r0, 240, fma_int(r2, 16, f32_int(r1 * -15)))
    assert np.abs(t).max() < 1 << 17
    tm = f32_int(t + MAGIC)
    bits = F32(tm).view(np.uint32).astype(np.int64)  # t + M, exact
    np.testing.assert_array_equal(bits, kernels.FP8_MAGIC_BITS + t)
    if p == 1024:
        return (bits + 512) & 1023
    k = magic_rint(t, F32(1.0 / p))
    value = fma_int(k, -p, tm)                       # M + r
    assert value.min() >= 1 << 23 and value.max() < 1 << 24
    return F32(value).view(np.uint32).astype(np.int64)


def mirror_residues(c3, nu):
    """(3nu, N) integer lane products -> (nu, N) residues r by the mirror."""
    return np.stack([reassemble_bits(c3[3 * i], c3[3 * i + 1], c3[3 * i + 2],
                                     i) - kernels.fp8_residue_offset(p)
                     for i, p in enumerate(MODULI[:nu])])


def _edges(p):
    """The lane values the reassembly is tried on for modulus p: 0, +-1,
    +-(2^24 - 1), +-2^24, and around multiples of p (near the ends of the
    range too) the values that wrap to 0, +-1 and the two ends of the
    balanced range."""
    top = (1 << 24) // p
    vals = {0, 1, -1, (1 << 24) - 1, 1 - (1 << 24), 1 << 24, -(1 << 24)}
    for j in (1, 2, 7, top - 1, top):
        for d in (-1, 0, 1, p // 2, p // 2 + 1, -(p // 2), -(p // 2) - 1):
            vals.update({j * p + d, -j * p + d})
    return np.array(sorted(v for v in vals if abs(v) <= 1 << 24), np.int64)


@functools.lru_cache(maxsize=None)
def _lanes(i):
    """Modulus i's (3, N) lane products: every triple of its edge values
    and a seeded sample over [-2^24, 2^24]."""
    e = _edges(MODULI[i])
    grid = np.stack(np.meshgrid(e, e, e, indexing="ij")).reshape(3, -1)
    rng = np.random.default_rng(900 + i)
    sample = rng.integers(-(1 << 24), (1 << 24) + 1, (3, 20000))
    return np.concatenate([grid, sample], axis=1)


@pytest.mark.parametrize("i", range(len(MODULI)))
def test_reassembly_mirror_equals_reassemble(i):
    """The f32 reassembly of modulus i, every step exact, equals
    fp8._reassemble's wrapped residue on the edge triples (c0 + c1 at
    +-2^25 among them) and a seeded sample."""
    nu = i + 1
    lanes = _lanes(i)
    c3 = np.zeros((3 * nu, lanes.shape[1]), np.int64)
    c3[3 * i:3 * i + 3] = lanes
    assert np.abs(lanes[0] + lanes[1]).max() == 1 << 25
    got = mirror_residues(c3, nu)[i]
    ref = fp8._reassemble(torch.from_numpy(c3.astype(np.int32))[:, None, :],
                          nu)[i, 0].numpy()
    np.testing.assert_array_equal(got, ref)
    p = MODULI[i]
    assert got.min() >= -(p // 2) and got.max() < p - p // 2


@pytest.mark.parametrize("i", range(len(MODULI)))
def test_near_wrap_is_congruent_and_near(i):
    """near_wrap(c) = c mod p within p/2 + 1 of 0, for every edge value
    and every c in a window around each end of [-2^24, 2^24]."""
    p = MODULI[i]
    c = np.concatenate([_edges(p), np.arange(-(1 << 24), 4000 - (1 << 24)),
                        np.arange((1 << 24) - 4000, (1 << 24) + 1)])
    r = near_wrap(c, p)
    assert ((c - r) % p == 0).all()
    assert np.abs(r).max() <= p // 2 + 1


def test_wrapped_values_carry_their_offsets():
    """For every residue r of every FP8 modulus, the f32 M + r has the bits
    0x4B400000 + r, and the 1024 mask of those bits plus 512 gives r + 512."""
    for p in MODULI:
        r = np.arange(-(p // 2), p - p // 2)
        bits = F32(MAGIC + r).view(np.uint32).astype(np.int64)
        np.testing.assert_array_equal(bits, kernels.FP8_MAGIC_BITS + r)
        if p == 1024:
            np.testing.assert_array_equal((bits + 512) & 1023, r + 512)
    assert kernels.FP8_MAGIC_BITS % 1024 == 0


def test_fp8_moduli_fit_the_kernel():
    """The kernel's fixed facts about the FP8 moduli: the first
    NOT_KARATSUBA are squares, modulus 1 is 1024 (masked), every other is
    odd (so the final f32 wrap is the balanced one), and the Karatsuba
    moduli keep |240 r0 + 16 r2 - 15 r1| below 2^17."""
    sq = fp8._sqrt_moduli()
    assert len(sq) == tables.NOT_KARATSUBA
    assert all(q * q == p for q, p in zip(sq, MODULI))
    assert MODULI[1] == 1024
    assert all(p % 2 for i, p in enumerate(MODULI) if i != 1)
    kar = MODULI[tables.NOT_KARATSUBA:]
    assert 271 * (max(kar) // 2 + 1) < 1 << 17
    assert 33 * 2 * (max(MODULI) // 2 + 1) + max(MODULI) // 2 + 1 < 1 << 17
    nk = re.search(r"#define G8_NOT_KARATSUBA (\d+)", _source("common.cuh"))
    assert int(nk.group(1)) == tables.NOT_KARATSUBA


def test_source_constants_match_the_plan():
    """epilogue_fp8.cu's magic number, its bits, the mask's offset and the
    columns a thread against kernels'."""
    text = _source("epilogue_fp8.cu")
    magic = re.search(r"kMagic = ([\d.]+)f;", text).group(1)
    assert float(magic) == MAGIC == 1.5 * 2 ** 23
    bits = re.search(r"kMagicBits = (0x[0-9A-F]+)u;", text).group(1)
    assert int(bits, 16) == kernels.FP8_MAGIC_BITS
    assert int(F32(MAGIC).view(np.uint32)) == kernels.FP8_MAGIC_BITS
    mask = re.search(r"kMaskOffset = (\d+)u;", text).group(1)
    assert int(mask) == kernels.FP8_MASK_OFFSET == 1024 // 2
    cols = re.search(r"constexpr int kCols = (\d+);", text).group(1)
    assert int(cols) == kernels.EPILOGUE_COLS["fused_epilogue_fp8"]


# ---------------------------------------------------------------------------
# the plan and the limbs' start
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nu", [1, 2, 6, 7, 14, 20])
@pytest.mark.parametrize("out_bits", [24, 53])
def test_plan_fields(nu, out_bits):
    """_epilogue_plan_fp8: the CRT plan of the FP8 moduli, q and p in f32,
    1/p rounded to f32, and lim0 = -sum offset_i * w16[i] mod 2^32."""
    plan = kernels._epilogue_plan_fp8(nu, out_bits)
    crt = kernels._epilogue_plan(nu, "FP8", out_bits)
    assert bytes(plan.crt) == bytes(crt)
    sq = fp8._sqrt_moduli()
    for i, p in enumerate(MODULI[:nu]):
        q = sq[i] if i < tables.NOT_KARATSUBA else 0
        assert plan.sq[i] == q and plan.sq_f[i] == q
        assert plan.p_f[i] == p and plan.inv_p[i] == F32(1.0 / p)
    for li in range(crt.L):
        want = -sum(kernels.fp8_residue_offset(p) * crt.w16[i][li]
                    for i, p in enumerate(MODULI[:nu])) & M32
        assert plan.lim0[li] == want
    assert all(plan.lim0[li] == 0 for li in range(crt.L, kernels._MAX_L))


@pytest.mark.parametrize("nu", [2, 7, 14, 20])
@pytest.mark.parametrize("out_bits", [24, 53])
def test_limbs_start_takes_the_offsets_out(nu, out_bits):
    """lim0 + sum (r_i + offset_i) * w16[i], in the kernel's unsigned 32-bit
    arithmetic, ends at the exact sums sum r_i * w16[i] that the plain
    version's limbs hold, for extreme and random residues."""
    plan = kernels._epilogue_plan_fp8(nu, out_bits)
    L = plan.crt.L
    rng = np.random.default_rng(nu * 100 + out_bits)
    mods = np.array(MODULI[:nu], np.int64)[:, None]
    r = np.concatenate([-(mods // 2) * np.ones((1, 4), np.int64),
                        (mods - mods // 2 - 1) * np.ones((1, 4), np.int64),
                        rng.integers(-(mods // 2), mods - mods // 2,
                                     (nu, 500))], axis=1)
    w16 = np.array([[plan.crt.w16[i][li] for li in range(L)]
                    for i in range(nu)], np.int64)
    off = np.array([kernels.fp8_residue_offset(p) for p in MODULI[:nu]],
                   np.int64)
    lim = np.array(list(plan.lim0)[:L], np.int64)[:, None]
    for i in range(nu):
        u = (r[i] + off[i]) & M32                    # the unsigned residue
        lim = (lim + u[None, :] * (w16[i][:, None] & M32)) & M32
    got = np.where(lim >= 1 << 31, lim - (1 << 32), lim)
    exact = np.einsum("in,il->ln", r, w16)
    assert np.abs(exact).max() < 1 << 31
    np.testing.assert_array_equal(got, exact)


# ---------------------------------------------------------------------------
# K3's tiling, its loops over the moduli and its vector rule
# ---------------------------------------------------------------------------

def k3_tile_cover(m, n, nu, vec, max_grid_y=65535):
    """crt.cuh's tile_grid and Tile::make with K3's columns, and K3's row
    loop, in numpy (tile_cover's pattern): how often each (i, j) is taken.
    With vec, also checks that each of the 3nu planes' loads of a thread's
    columns is whole and aligned to its 16 bytes."""
    cols, rows = kernels.EPILOGUE_COLS["fused_epilogue_fp8"], \
        kernels._TILE_ROWS
    gx = math.ceil(n / (32 * cols))
    gy = min(math.ceil(m / rows), max_grid_y)
    count = np.zeros((m, n), np.int64)
    for bx in range(gx):
        for tx in range(32):
            j0 = (bx * 32 + tx) * cols
            nv = max(0, min(cols, n - j0))
            if nv == 0:
                continue
            for by in range(gy):
                for ty in range(rows):
                    for i in range(by * rows + ty, m, gy * rows):
                        count[i, j0:j0 + nv] += 1
                        if vec:
                            assert nv == cols
                            for plane in range(3 * nu):
                                off = (plane * m * n + i * n + j0) * 4
                                assert off % (cols * 4) == 0
    return count


@pytest.mark.parametrize("shape", [(129, 263), (1, 263), (129, 1), (33, 20),
                                   (31, 9), (17, 264), (1, 1), (3, 1000)])
def test_k3_tiles_cover_every_element_once(shape):
    """Every (i, j) is taken exactly once by K3, on the vector route where
    the shape allows it and on the column route always, also when the rows
    outnumber the grid's y extent."""
    m, n = shape
    cols = kernels.EPILOGUE_COLS["fused_epilogue_fp8"]
    for vec in {False, n % cols == 0}:
        for max_y in (65535, 1, 2):
            count = k3_tile_cover(m, n, 2, vec, max_grid_y=max_y)
            assert (count == 1).all(), (vec, max_y)


def k3_moduli_order(nu, kmods, two_loops):
    """The kernel's loops over the moduli in numpy: [(kind, q)] in the
    order taken, batch by batch of kmods (mac_moduli)."""
    taken = []
    if two_loops:
        nsq = min(nu, tables.NOT_KARATSUBA)
        for q0 in range(0, tables.NOT_KARATSUBA, kmods):
            if q0 >= nsq:
                break
            taken += [("square", q) for q in range(q0, min(q0 + kmods, nsq))]
        for q0 in range(tables.NOT_KARATSUBA, nu, kmods):
            taken += [("karatsuba", q) for q in range(q0, min(q0 + kmods, nu))]
    else:
        for q0 in range(0, nu, kmods):
            taken += [("any", q) for q in range(q0, min(q0 + kmods, nu))]
    return taken


@pytest.mark.parametrize("nu", range(1, 21))
def test_k3_loops_take_each_modulus_once(nu):
    """The two loops (and the probe's one-loop variant) take every modulus
    below nu once, in order, the square ones as squares and the rest as
    Karatsuba ones, for the source's batch size and the probe's."""
    kmods = int(re.search(r"constexpr int kMods = (\d+);",
                          _source("epilogue_fp8.cu")).group(1))
    for k in {kmods, 1}:
        taken = k3_moduli_order(nu, k, True)
        assert [q for _, q in taken] == list(range(nu))
        assert all((kind == "square") == (q < tables.NOT_KARATSUBA)
                   for kind, q in taken)
        assert [q for _, q in k3_moduli_order(nu, k, False)] == \
            list(range(nu))


@pytest.mark.parametrize("n", [1, 3, 4, 6, 8, 20, 263, 264])
def test_k3_vec_rule(n):
    """K3 loads and stores whole vectors only where n is a multiple of its
    columns and the stack and the output are 16-byte aligned."""
    cols = kernels.EPILOGUE_COLS["fused_epilogue_fp8"]
    c3 = torch.zeros((6, 5, n), dtype=torch.float32)
    for dt in (torch.float32, torch.float64):
        out = torch.zeros((5, n), dtype=dt)
        aligned = c3.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        assert kernels._epilogue_vec(n, cols, c3, out) == (
            n % cols == 0 and aligned)
        moved = torch.zeros(c3.numel() + 1, dtype=torch.float32)[1:]
        assert not kernels._epilogue_vec(n, cols, moved.view(c3.shape), out)


def test_k3_entry_point_signature():
    """The C entry point takes the arguments kernels._ARGTYPES passes, vec
    among them, in that order."""
    text = _source("epilogue_fp8.cu")
    params = re.search(r'extern "C" int g8_fused_epilogue_fp8\((.*?)\)',
                       text, re.S).group(1)
    names = [re.search(r"(\w+)$", a.strip()).group(1)
             for a in params.split(",")]
    assert names == ["c3", "sfta", "sftb", "out", "out_f64", "m", "n", "vec",
                     "plan_ptr", "stream"]
    types = kernels._ARGTYPES["fused_epilogue_fp8"]
    assert len(types) == len(names)
    assert types[7] is kernels._I and types[8] is kernels._P


def test_k3_cpu_wrapper_takes_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's bits and
    counts no launch."""
    kernels.reset_launches()
    rng = np.random.default_rng(5)
    nu, m, n = 7, 5, 9
    c3 = torch.from_numpy(rng.integers(-(1 << 24), (1 << 24) + 1,
                                       (3 * nu, m, n)).astype(np.float32))
    sa = torch.from_numpy(rng.integers(-40, 90, m).astype(np.int32))
    sb = torch.from_numpy(rng.integers(-40, 90, n).astype(np.int32))
    for out in (torch.float32, torch.float64):
        got = kernels.fused_epilogue_fp8(c3, sa, sb, nu, out)
        ref = kernels.fused_epilogue_fp8_plain(c3, sa, sb, nu, out)
        assert got.dtype == out and torch.equal(got, ref)
    assert not any(kernels.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the ablation probe's K3 cases
# ---------------------------------------------------------------------------

def test_k3_probe_cases_name_source_kernels():
    """The probe's K3 cases name epilogue_fp8_kernel<F64, VEC, L> with the
    output, the vector route and the limb count of their plans, and the
    source declares that template and instantiates it per limb count."""
    text = _source("epilogue_fp8.cu")
    assert re.search(r"template <bool F64, bool VEC, int L>\n__global__ void "
                     r"__launch_bounds__\([^)]*\)\nepilogue_fp8_kernel\(",
                     text)
    assert "epilogue_fp8_kernel<true, VEC, L>" in text
    assert "epilogue_fp8_kernel<false, VEC, L>" in text
    assert "dispatch_l(plan.crt.L" in text
    k3 = {c: case for c, case in epilogue_tiles.CASES.items()
          if case.kernel == "fused_epilogue_fp8"}
    assert {(case.nu, case.arg) for case in k3.values()} == {
        (14, torch.float64), (7, torch.float32)}
    for case in k3.values():
        f64 = case.arg == torch.float64
        L = kernels._epilogue_plan_fp8(case.nu, 53 if f64 else 24).crt.L
        assert case.part == f"epilogue_fp8_kernelILb{int(f64)}ELb1ELi{L}E"
        assert case.dtype == torch.float32
    assert epilogue_tiles.SOURCE_OF["fused_epilogue_fp8"] == "epilogue_fp8.cu"


def test_probe_fp8_calls_needs_the_card():
    """probes.fp8_calls times on the card only, at chip_smoke.py's FP8
    paths."""
    assert fp8_calls.PATHS == ((torch.float64, 14), (torch.float32, 7))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe runs on it")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        fp8_calls.main()
