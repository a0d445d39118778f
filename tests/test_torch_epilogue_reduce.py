"""The epilogues' division-free wrap (csrc/crt.cuh: wrap_any, wrap_small, the
3M lane recombine), their plans' layout (csrc/common.cuh) and K2's and K4's
2-D tiling (crt.cuh: Tile, tile_grid, load_cols; the wrapper's vec flag,
kernels._epilogue_vec) mirrored in numpy with the constants of
kernels._epilogue_plan, held against exact modular arithmetic, against
core.mod_reduce and against the JAX package's mod_reduce, for every INT8 and
FP8 modulus the plans of nu = 2 .. 20 carry.

The device wrap of any int32 v by a modulus p that is not a power of two:
    u = v xor 2^31                       (= v + 2^31, in [0, 2^32))
    r = u - umulhi(u, magic) * p         (in [0, 2p))
    r = min(r, (r - p) mod 2^32)         (in [0, p))
    r = r + wrap_off                     (in [0, 2p))
    r = min(r, (r - p) mod 2^32)         (= (v + floor(p/2)) mod p)
    wrap = r - floor(p / 2)
and of a power-of-two p: ((v + p/2) mod 2^32) & (p - 1), less p/2.
"""
import ctypes
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu import core as jcore, tables as jt
from gemmul8_tpu_torch import core, kernels, tables
from gemmul8_tpu_torch.probes import epilogue_tiles

BACKENDS = ("INT8", "FP8")
M32 = np.uint64(0xFFFFFFFF)
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def device_wrap(v, p, magic, off):
    """wrap_any in uint64 arithmetic, the 32-bit wraps made explicit."""
    v = np.asarray(v, np.int64)
    assert v.min() >= I32_MIN and v.max() <= I32_MAX
    h = p // 2
    if p & (p - 1) == 0:                      # the mask of a power-of-two p
        u = (v.astype(np.uint64) + np.uint64(h)) & M32
        return (u & np.uint64(p - 1)).astype(np.int64) - h
    u = (v.astype(np.uint64) & M32) ^ np.uint64(0x80000000)
    np.testing.assert_array_equal(u.astype(np.int64), v + 2 ** 31)
    q = (u * np.uint64(magic)) >> np.uint64(32)
    r = (u - q * np.uint64(p)) & M32
    assert r.max() < 2 * p
    r = np.minimum(r, (r - np.uint64(p)) & M32)
    r = (r + np.uint64(off)) & M32
    assert r.max() < 2 * p
    r = np.minimum(r, (r - np.uint64(p)) & M32)
    return r.astype(np.int64) - h


def wrap_small(v, p):
    """wrap_small: one balanced correction each way."""
    v = np.asarray(v, np.int64)
    v = np.where(2 * v >= p, v - p, v)
    return np.where(2 * v < -p, v + p, v)


def exact_wrap(v, p):
    return ((np.asarray(v, np.int64) + p // 2) % p) - p // 2


def _plan_moduli(backend):
    """{p: (magic, wrap_off)} over the plans of nu = 2 .. 20, checking that
    every plan carries the same constants for a modulus."""
    seen = {}
    for nu in range(2, 21):
        for out_bits in (24, 53):
            plan = kernels._epilogue_plan(nu, backend, out_bits)
            for i in range(nu):
                p = plan.p[i]
                assert p == tables.moduli(backend)[i] == jt.moduli(backend)[i]
                consts = (plan.magic[i], plan.wrap_off[i])
                assert seen.setdefault(p, consts) == consts
    return seen


def _edge_values(p):
    """The int32 extremes, 0 and +-1; each multiple of p and its neighbours
    near both ends and near 0; the extremes' neighbourhoods."""
    vals = [I32_MIN, I32_MIN + 1, I32_MAX - 1, I32_MAX, 0, 1, -1]
    vals += list(range(I32_MIN, I32_MIN + 3 * p))
    vals += list(range(I32_MAX - 3 * p, I32_MAX + 1))
    k_lo, k_hi = -(-I32_MIN // p), I32_MAX // p
    for ks in (range(k_lo, k_lo + 64), range(k_hi - 63, k_hi + 1),
               range(-64, 65)):
        for k in ks:
            vals += [k * p - 1, k * p, k * p + 1]
    v = np.asarray(vals, np.int64)
    return v[(v >= I32_MIN) & (v <= I32_MAX)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_wrap_edges_every_plan_modulus(backend):
    consts = _plan_moduli(backend)
    assert set(consts) == set(tables.moduli(backend))
    for p, (magic, off) in consts.items():
        v = _edge_values(p)
        got = device_wrap(v, p, magic, off)
        np.testing.assert_array_equal(got, exact_wrap(v, p), err_msg=f"p={p}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_wrap_random_sample_against_mod_reduce(backend):
    """A seeded sample over all of int32: the mirror equals exact arithmetic,
    the port's core.mod_reduce and, for the INT8 moduli, the JAX package's
    mod_reduce (which returns int8 for the FP8 moduli too, and so wraps
    their residues past +-127: the cast trap core.mod_reduce avoids)."""
    rng = np.random.default_rng(20261017)
    mods = tables.moduli(backend)
    v = rng.integers(I32_MIN, I32_MAX + 1, (len(mods), 20000))
    v[:, :4] = [I32_MIN, I32_MAX, 0, -1]
    consts = _plan_moduli(backend)
    got = np.stack([device_wrap(v[i], p, *consts[p])
                    for i, p in enumerate(mods)])
    np.testing.assert_array_equal(got, np.stack([exact_wrap(v[i], p)
                                                 for i, p in enumerate(mods)]))
    c_hi = v.astype(np.int32).reshape(len(mods), 100, 200)
    ported = core.mod_reduce(torch.from_numpy(c_hi), len(mods), backend)
    np.testing.assert_array_equal(got, ported.numpy().astype(np.int64)
                                  .reshape(len(mods), -1))
    ref = np.asarray(jcore.mod_reduce(jnp.asarray(c_hi), len(mods), backend))
    if backend == "INT8":
        np.testing.assert_array_equal(got, ref.astype(np.int64)
                                      .reshape(len(mods), -1))
    else:
        np.testing.assert_array_equal(got.astype(np.int8),
                                      ref.reshape(len(mods), -1))


def test_wrap_constants_of_every_modulus():
    for backend in BACKENDS:
        for p, (magic, off) in _plan_moduli(backend).items():
            assert (magic, off) == kernels.wrap_constants(p)
            assert magic == 2 ** 32 // p and 0 <= off < p
            assert (off + 2 ** 31 - p // 2) % p == 0
            if p & (p - 1) == 0:                # exact: no remainder at all
                assert magic * p == 2 ** 32


def test_wrap_small_on_int8_input():
    """K2 on int8 input wraps each value with one correction each way: exact
    for every int8 value and INT8 modulus, all of which exceed 128."""
    v = np.arange(-128, 128)
    for p in tables.moduli("INT8"):
        assert p > 128
        np.testing.assert_array_equal(wrap_small(v, p), exact_wrap(v, p),
                                      err_msg=f"p={p}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_wrap_small_domain_covers_the_recombine(backend):
    """wrap_small is exact on -3p <= 2v < 3p, which holds the 3M recombine's
    re = a - b and im = c - a - b of wrapped lanes."""
    for p in tables.moduli(backend):
        v = np.arange(-2 * p, 2 * p + 1)
        ok = wrap_small(v, p) == exact_wrap(v, p)
        dom = (2 * v >= -3 * p) & (2 * v < 3 * p)
        assert ok[dom].all(), p
        lo, hi = -(p // 2), p - p // 2 - 1       # the wrap's range
        for x in (lo - hi, hi - lo, lo - 2 * hi, hi - 2 * lo):
            assert -3 * p <= 2 * x < 3 * p, (p, x)


def test_recombine_mirror_equals_plain():
    """lane_recombine_3m mirrored on random int32 lanes equals K5's plain
    version (mod_reduce per lane -> complex_gemm._recombine_3m)."""
    rng = np.random.default_rng(7)
    nu = 20
    mods = tables.moduli("INT8")[:nu]
    consts = _plan_moduli("INT8")
    chi = rng.integers(I32_MIN, I32_MAX + 1, (3 * nu, 30, 40))
    chi[:, 0, :3] = [I32_MIN, I32_MAX, 0]
    res, ims = [], []
    for q, p in enumerate(mods):
        crr, cii, cri = (device_wrap(chi[lane * nu + q], p, *consts[p])
                         for lane in range(3))
        res.append(wrap_small(crr - cii, p))
        ims.append(wrap_small(cri - crr - cii, p))
    re, im = kernels.fused_recombine_3m_plain(
        torch.from_numpy(chi.astype(np.int32)), nu, "INT8")
    np.testing.assert_array_equal(np.stack(res), re.numpy())
    np.testing.assert_array_equal(np.stack(ims), im.numpy())


# ---------------------------------------------------------------------------
# the plans' layout against csrc/common.cuh
# ---------------------------------------------------------------------------

_COMMON = os.path.join(kernels._CSRC, "common.cuh")
_CTYPE = {"int": ctypes.c_int, "unsigned": ctypes.c_uint,
          "float": ctypes.c_float, "unsigned char": ctypes.c_ubyte}
_MIRROR = {"EncodePlan": kernels._EncodePlan,
           "EncodePlanFp8": kernels._EncodePlanFp8,
           "EpiloguePlan": kernels._EpiloguePlan,
           "EpiloguePlanFp8": kernels._EpiloguePlanFp8,
           "EpiloguePlanMxu": kernels._EpiloguePlanMxu}


def _c_fields(text, struct):
    """[(name, C type, dims)] of a struct in common.cuh, in order."""
    defines = {k: int(v) for k, v in
               re.findall(r"#define (G8_\w+) (\d+)", text)}
    body = re.search(r"struct %s \{(.*?)\};" % struct, text, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        ctype, decls = re.fullmatch(
            r"(unsigned char|unsigned|int|float|\w+) (.+);", line).groups()
        for decl in decls.split(","):
            name = re.match(r"\s*(\w+)", decl).group(1)
            dims = [eval(d, {"__builtins__": {}}, defines)
                    for d in re.findall(r"\[([^\]]+)\]", decl)]
            fields.append((name, ctype, dims))
    return fields


def _ctypes_dims(t):
    dims = []
    while hasattr(t, "_length_"):
        dims.append(t._length_)
        t = t._type_
    return t, dims


@pytest.mark.parametrize("struct", sorted(_MIRROR))
def test_plan_structures_fit_common_cuh(struct):
    """Each ctypes plan has common.cuh's fields in its order, with the same
    element types and dimensions (so ctypes lays them out as the compiler
    does)."""
    text = open(_COMMON).read()
    mirror = _MIRROR[struct]
    c_fields = _c_fields(text, struct)
    assert [f[0] for f in mirror._fields_] == [f[0] for f in c_fields]
    for (name, t), (_, ctype, dims) in zip(mirror._fields_, c_fields):
        base, got_dims = _ctypes_dims(t)
        want = _CTYPE.get(ctype) or _MIRROR[ctype]
        assert (base, got_dims) == (want, dims), name


def test_epilogue_plan_size_and_offsets():
    """EpiloguePlan: 4 scalars, p[20], w16[20][7], p16[7], s1[7], s2[7],
    magic[20], wrap_off[20], all 4 bytes; the FP8 and tensor-core plans
    embed it first."""
    P = kernels._EpiloguePlan
    assert ctypes.sizeof(P) == 4 * (4 + 20 + 140 + 7 + 7 + 7 + 20 + 20)
    assert P.magic.offset == 4 * (4 + 20 + 140 + 21)
    assert P.wrap_off.offset == P.magic.offset + 4 * 20
    assert kernels._EpiloguePlanFp8.crt.offset == 0
    assert kernels._EpiloguePlanMxu.crt.offset == 0
    assert kernels._EpiloguePlanFp8.sq.offset == ctypes.sizeof(P)
    plan = kernels._epilogue_plan(20, "FP8", 53)
    assert all(0 <= plan.magic[i] < 2 ** 32 for i in range(20))


# ---------------------------------------------------------------------------
# K2's and K4's 2-D tiling
# ---------------------------------------------------------------------------

def _read(name):
    return open(os.path.join(kernels._CSRC, name)).read()


def test_tiling_constants_match_the_sources():
    rows = re.search(r"#define G8_TILE_ROWS (\d+)", _read("crt.cuh"))
    assert int(rows.group(1)) == kernels._TILE_ROWS
    for kernel, source in (("fused_epilogue", "epilogue.cu"),
                           ("fused_epilogue_complex", "complex.cu")):
        cols = re.search(r"constexpr int kCols = (\d+);", _read(source))
        assert int(cols.group(1)) == kernels.EPILOGUE_COLS[kernel]


def tile_cover(m, n, cols, vec, itemsize, nu=3, max_grid_y=65535):
    """crt.cuh's tile_grid, Tile::make and the kernels' row loop in numpy:
    how often each (i, j) is taken. With vec, also checks that each plane's
    load of a thread's columns is whole and aligned to its width."""
    rows = kernels._TILE_ROWS
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
                            for q in range(nu):
                                off = (q * m * n + i * n + j0) * itemsize
                                assert off % (cols * itemsize) == 0
    return count


SHAPES = [(129, 263), (1, 263), (129, 1), (33, 20), (7, 16), (1, 1), (5, 8),
          (17, 264), (3, 1000)]


@pytest.mark.parametrize("shape", SHAPES)
def test_tiles_cover_every_element_once(shape):
    """Every (i, j) is taken exactly once by K2 (int32 and int8 input) and K4,
    on the vector route where the shape allows it and on the scalar route
    always, also when the rows outnumber the grid's y extent."""
    m, n = shape
    for cols, itemsize in ((kernels.EPILOGUE_COLS["fused_epilogue"], 4),
                           (kernels.EPILOGUE_COLS["fused_epilogue"], 1),
                           (kernels.EPILOGUE_COLS["fused_epilogue_complex"], 4)):
        for vec in {False, n % cols == 0}:
            for max_y in (65535, 1, 2):
                count = tile_cover(m, n, cols, vec, itemsize,
                                   max_grid_y=max_y)
                assert (count == 1).all(), (cols, vec, max_y)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 20, 263, 264])
def test_epilogue_vec_needs_whole_aligned_vectors(n):
    """The vector route is taken only where n is a multiple of the columns a
    thread takes and every tensor is 16-byte aligned."""
    x = torch.zeros((3, 5, n), dtype=torch.int32)
    out = torch.zeros((5, n), dtype=torch.float64)
    for cols in sorted(set(kernels.EPILOGUE_COLS.values())):
        aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        assert kernels._epilogue_vec(n, cols, x, out) == (
            n % cols == 0 and aligned)
        shifted = torch.zeros(x.numel() + 1, dtype=torch.int32)[1:]
        assert not kernels._epilogue_vec(n, cols, shifted.view(x.shape), out)


def test_ptxas_report_reads_registers_and_spills():
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPi' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPi
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers, 1296 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
"""
    assert kernels.ptxas_report(text) == [("_Z3fooPi", 72, 8, 12),
                                          ("_Z3barv", 168, 0, 0)]


# ---------------------------------------------------------------------------
# K2's and K4's one-multiply f64 descale (crt.cuh: emit_f64_direct)
# ---------------------------------------------------------------------------

def _direct_range():
    text = _read("crt.cuh")
    lo = int(re.search(r"#define G8_DIRECT_LO \((-?\d+)\)", text).group(1))
    hi = int(re.search(r"#define G8_DIRECT_HI (\d+)", text).group(1))
    return lo, hi


def test_direct_range_is_where_the_split_stays_normal():
    """For every s in [G8_DIRECT_LO, G8_DIRECT_HI] the floor split's partial
    exponents h1 and h1 + h2 lie between 0 and s, and x * 2^e is a normal
    f64 for every int32 x != 0 and every such e: so each of pow2_scale's
    three multiplies is exact."""
    lo, hi = _direct_range()
    assert (lo, hi) == (-1022, 1023 - 31)
    s = np.arange(lo, hi + 1)
    h1 = np.floor_divide(s, 3)
    h2 = np.floor_divide(s - h1, 2)
    for part in (h1, h1 + h2, s):
        assert (part >= np.minimum(s, 0)).all()
        assert (part <= np.maximum(s, 0)).all()


def test_direct_descale_equals_pow2_scale():
    """x * 2^s in one multiply equals the plain version's three-factor
    pow2_scale bit for bit for int32 limbs and every s of the direct range,
    and differs from it outside the range (where emit_f64_direct takes the
    three factors)."""
    from gemmul8_tpu_torch import quantize
    lo, hi = _direct_range()
    rng = np.random.default_rng(3)
    x = np.concatenate([[0, 1, -1, 3, 2 ** 15, -2 ** 15 - 1, I32_MAX, I32_MIN],
                        rng.integers(I32_MIN, I32_MAX + 1, 24)])
    s = np.arange(lo, hi + 1)
    xs = torch.from_numpy(np.repeat(x, len(s)).astype(np.float64))
    ss = torch.from_numpy(np.tile(s, len(x)).astype(np.int32))
    three = quantize.pow2_scale(xs, ss)
    one = xs * quantize.pow2(ss, torch.float64)
    assert torch.equal(three.view(torch.int64), one.view(torch.int64))
    big = torch.tensor([float(I32_MAX)], dtype=torch.float64)
    for s_out in (hi + 40, lo - 60):
        s_t = torch.tensor([s_out], dtype=torch.int32)
        assert not torch.equal(quantize.pow2_scale(big, s_t),
                               big * quantize.pow2(s_t, torch.float64))


# ---------------------------------------------------------------------------
# probes.epilogue_tiles: each design choice undone in a copy of the sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(epilogue_tiles.VARIANTS))
def test_tile_variants_edit_the_shipped_sources(variant, tmp_path):
    """Each variant's edits find their text exactly once in the shipped
    sources, and change them (the shipped variant changes nothing)."""
    edits = epilogue_tiles.VARIANTS[variant]
    epilogue_tiles.variant_sources(edits, str(tmp_path / "src"))
    for name, old, new in edits:
        text = (tmp_path / "src" / name).read_text()
        assert new in text and old != new
    assert bool(edits) == (variant != "shipped")


def test_tile_cases_name_shipped_kernels():
    """Each case's kernel is one the shipped sources instantiate: its input
    type, output and limb count are those of its plan."""
    from gemmul8_tpu_torch import quantize
    for kernel, nu, in_dtype, arg, part in epilogue_tiles.CASES.values():
        if kernel == "encode_planes_fp8":
            frame = "rows" if arg == 0 else "cols"
            t = "d" if in_dtype == torch.float64 else "f"
            assert part == (f"encode_{frame}_kernel.*Fp8PlanesE{t}Li"
                            f"{quantize.n_limbs(nu, 'FP8')}E")
            continue
        if kernel == "encode_lanes":
            frame = "rows" if arg == 0 else "cols"
            t = "d" if in_dtype == torch.float64 else "f"
            assert part == (f"encode_{frame}_kernel.*Int8LanesE{t}Li"
                            f"{quantize.n_limbs(nu, 'INT8')}E")
            continue
        if kernel == "fused_epilogue_mxu":
            L = kernels._epilogue_plan_mxu(nu, "INT8", arg).crt.L
            assert part == f"epilogue_mxu_kernelILb1ELi{L}E"
            continue
        if kernel == "fused_epilogue_fp8":
            f64 = int(arg == torch.float64)
            L = kernels._epilogue_plan_fp8(nu, 53 if f64 else 24).crt.L
            assert part == f"epilogue_fp8_kernelILb{f64}ELb1ELi{L}E"
            continue
        real = kernels.REAL_DTYPE[arg]
        L = kernels._epilogue_plan(nu, "INT8",
                                   53 if real == torch.float64 else 24).L
        f64 = int(real == torch.float64)
        if kernel == "fused_epilogue":
            t = "a" if in_dtype == torch.int8 else "i"
            assert part == f"epilogue_kernelI{t}Lb{f64}ELb1ELi{L}E"
        else:
            assert part == f"complex_kernelILb{f64}ELb1ELi2ELi{L}E"


@pytest.mark.parametrize("variant", sorted(epilogue_tiles.VARIANTS))
def test_tile_variants_rebuild_what_they_edit(variant):
    """The shipped build takes every timed source; a variant rebuilds at
    least one, and exactly those that include a file it edits."""
    edits = epilogue_tiles.VARIANTS[variant]
    built = epilogue_tiles.variant_builds(edits)
    if not edits:
        assert built == epilogue_tiles.SOURCES
        return
    assert built
    for src in epilogue_tiles.SOURCES:
        text = _read(src)
        reached = any(name == src or f'#include "{name}"' in text
                      for name, _, _ in edits)
        assert (src in built) == reached, src


def test_probe_epilogue_tiles_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe runs on it")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        epilogue_tiles.main()
