"""Power-of-two scaling + exact modular residue encoding (Ozaki scheme II).

The PyTorch counterpart of gemmul8_tpu/quantize.py: the fast (and robust)
shifts, accurate mode's upper-bound extraction, estimation product and
shifts, and the residue encoder. Every function
keeps the order of operations of its JAX twin so that, fed the same inputs,
the results are bit-equal on the CPU:

  * integer `%` and `//` floor (torch.remainder, rounding_mode="floor");
  * `>>` on int32 is arithmetic (as in jnp);
  * powers of two are assembled from exponent bits, never from exp2;
  * f64 is true IEEE f64 on both the CPU and the card, so an f64 input splits
    into three exact f32 components (the JAX package's CPU path).

The quantized integer is v = floor(sum_j w_j) where w_j are the exact f32
components of y = x * 2^sft; every residue plane is derived from the same v.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tables
from .spans import span

# round-up-biased half used by the reference for log2 terms (0x1.000006p-1)
LOG2_HALF_RU = float.fromhex("0x1.000006p-1")
# deterministic safety margin replacing CUDA directed roundings in shift formulas
SFT_MARGIN = 2.0 ** -14
# upper-bound extraction bit budget for accurate mode (reference
# template_type.hpp:147)
MAX_UFP = {"INT8": 5, "FP8": 7}
# the INT8 estimation product is exact in int32 while 65^2 * k < 2^31, and is
# summed in f64 over chunks of 2^18 past that
K_SAFE_INT8 = (2 ** 31 - 1) // (65 * 65)
K_CHUNK_EST = 1 << 18
# the FP8 bound's split ub = 128*h + l (l <= 127): each int8 product is exact
# in int32 while 127^2 * k < 2^31
K_CHUNK_EST_FP8 = 1 << 17


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 scalar constant on like's device (rounded as np.float32 does)."""
    return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                        device=like.device)


# ---------------------------------------------------------------------------
# exact float helpers
# ---------------------------------------------------------------------------

def pow2(e: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Exact 2^e by exponent-field bit assembly; e within dtype's normal range.
    (Out of range, the exponent field wraps exactly as in the JAX twin.)"""
    if dtype == torch.float32:
        return ((e.to(torch.int32) + 127) << 23).view(torch.float32)
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)


def pow2_scale(x: torch.Tensor, sft: torch.Tensor) -> torch.Tensor:
    """x * 2^sft exactly (sft: int32, broadcastable), as three power-of-two
    multiplies so each factor stays normal for |sft| far beyond the range."""
    h1 = torch.div(sft, 3, rounding_mode="floor")
    h2 = torch.div(sft - h1, 2, rounding_mode="floor")
    h3 = sft - h1 - h2
    return ((x * pow2(h1, x.dtype)) * pow2(h2, x.dtype)) * pow2(h3, x.dtype)


def f32_components(y: torch.Tensor, n_comp: int) -> list[torch.Tensor]:
    """Peel y into exact f32 components c_0 >> c_1 >> ...; their sum equals y
    exactly for IEEE f64 when n_comp >= 3 (24*3 > 53)."""
    if y.dtype == torch.float32:
        return [y]
    comps = []
    r = y
    for j in range(n_comp):
        c = r.to(torch.float32)
        comps.append(c)
        if j + 1 < n_comp:
            r = r - c.to(y.dtype)
    return comps


def f32_decompose(c: torch.Tensor):
    """(sign ±1, mantissa int32 in [0, 2^24), unbiased exp) with value
    sign * mant * 2^(exp-23). Subnormals: no implicit bit, exp = -126."""
    bits = c.view(torch.int32)
    one = torch.ones((), dtype=torch.int32, device=c.device)
    sign = torch.where(bits < 0, -one, one)
    expf = (bits >> 23) & 0xFF
    frac = bits & 0x7FFFFF
    is_norm = expf > 0
    mant = torch.where(is_norm, frac | (1 << 23), frac)
    e = torch.where(is_norm, expf - 127, torch.full_like(expf, -126))
    return sign, mant, e


def ilogb(a: torch.Tensor) -> torch.Tensor:
    """floor(log2(a)) for a > 0, exact via the f32 bit pattern when a is
    f32-normal; f64 log2 (with a conservative nudge) outside f32's range."""
    a32 = a.to(torch.float32)
    e32 = ((a32.view(torch.int32) >> 23) & 0xFF) - 127
    if a.dtype == torch.float32:
        return e32
    in_range = (a32 >= float(2.0 ** -126)) & torch.isfinite(a32) & (a32 > 0)
    tiny = torch.tensor(np.finfo(np.float64).tiny, dtype=a.dtype, device=a.device)
    ef = torch.floor(torch.log2(torch.maximum(a, tiny)) + 2.0 ** -32)
    return torch.where(in_range, e32, ef.to(torch.int32))


# ---------------------------------------------------------------------------
# shift computation (fast mode)  [reference: scaling_fast_real.hpp:6-22]
# ---------------------------------------------------------------------------

@span("shifts")
def shift_fast(x: torch.Tensor, num_moduli: int, backend: str, reduce_axis: int,
               variant: str = "reference",
               im: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row (reduce_axis=1) or per-column (reduce_axis=0) quantization shift.

    variant="reference": sft = floor(log2P - 1.5 - max(1, ~0.5*log2(sum x^2)))
    - ilogb(amax). variant="invariant" (fastmode="robust"): the amax term is
    dropped, sft = floor(log2P' - 1.5 - ~0.5*log2(sum x^2)), which bounds the
    quantized norm at every input scale. Zero rows get sft=0. See the JAX
    twin for the derivation. With `im`, x and im are the real and imaginary
    parts: one shift per row (column) of both, that of
    torch.cat([x, im], dim=reduce_axis).

    On the CPU this is kernels.shift_fast_plain, the JAX twin's order of
    operations; on the card, kernel K10 (kernels.shift_fast).

    The f32 log2 and the f32 row sum may differ from XLA's in the last bit,
    so a row whose value falls within about an ulp of an integer can floor
    the other way; everything downstream is exact given the shifts.
    """
    from . import kernels
    return kernels.shift_fast(x, num_moduli, backend, reduce_axis, variant, im)


# ---------------------------------------------------------------------------
# accurate mode: upper-bound extraction + estimation product + shifts
# [reference: scaling_accu_real.hpp]
# ---------------------------------------------------------------------------

def extract_ub_with_pre(ax: torch.Tensor, sft_pre: torch.Tensor,
                        reduce_axis: int, backend: str) -> torch.Tensor:
    """ceil(ax * 2^sft_pre) plus one where the f64 tail is positive: an
    upper-bound plane with a given pre-shift (shared across complex lanes).
    INT8: int8 (values <= 65). FP8: bf16 rounded up past bf16's integer grid
    (values <= 258): the RNE cast, then one ulp more where it rounded down."""
    y = pow2_scale(ax, sft_pre.unsqueeze(reduce_axis))
    c1 = y.to(torch.float32)
    ub = torch.ceil(c1)
    if y.dtype != torch.float32:
        ub = ub + ((y - c1.to(y.dtype)).to(torch.float32) > 0)
    ub = torch.where(ax > 0, torch.clamp(ub, min=1.0), 0.0)
    if backend == tables.Backend.INT8:
        return ub.to(torch.int8)
    b = ub.to(torch.bfloat16)
    # values are >= 0, so one more on the int16 view is the next bf16 up
    bumped = (b.view(torch.int16) + 1).view(torch.bfloat16)
    return torch.where(b.to(torch.float32) < ub, bumped, b)


@span("extract")
def extract_ub_plane(x: torch.Tensor, backend: str, scale_axis: int):
    """(upper-bound plane of |x|, int32 pre-shift MAX_UFP - ilogb(amax)) per
    row (scale_axis=0) or column (scale_axis=1): amax scales into
    [2^MAX_UFP, 2^(MAX_UFP+1)) (reference: scaling_accu_real.hpp:46-74).

    On the CPU this is kernels.extract_ub_plain, the JAX twin's order of
    operations; on the card, kernel K11 (kernels.extract_ub), bit-equal to
    it, whose planes are contiguous along the reduce axis (B's a (k, n)
    view of (n, k) storage, as estimate_gemm reads it)."""
    from . import kernels
    return kernels.extract_ub(x, backend, scale_axis)


def _k_contiguous(b: torch.Tensor) -> torch.Tensor:
    """b (k, n) with k the contiguous axis, the layout torch._int_mm reads
    fastest on the card (a transposed view of row-major storage already is)."""
    if b.device.type == "cpu" or b.stride(0) == 1:
        return b
    return b.T.contiguous().T


def int_mm(a: torch.Tensor, b: torch.Tensor,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """torch._int_mm (int8 x int8 -> int32, exact). An operand of one row
    whose row stride is below its row's length (a k = 1 plane in B's
    k-contiguous layout, or its transpose) is copied to row-major first:
    torch's CPU kernel takes that stride for the leading dimension and reads
    garbage."""
    a, b = (torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x)
            if x.shape[0] == 1 and x.stride(0) < x.shape[1] else x
            for x in (a, b))
    return torch._int_mm(a, b, out=out)


def _int_mm_f64(a: torch.Tensor, b: torch.Tensor, chunk: int) -> torch.Tensor:
    """Exact a @ b of int8 planes as f64: int32 products over K chunks
    (each exact), summed in f64 (exact: every sum stays far below 2^53)."""
    k = a.shape[1]
    tot = None
    for lo in range(0, k, chunk):
        part = int_mm(a[:, lo:lo + chunk], b[lo:lo + chunk])
        tot = part.double() if tot is None else tot + part
    return tot


@span("estimate")
def estimate_gemm(ub_a: torch.Tensor, ub_b: torch.Tensor,
                  backend: str) -> torch.Tensor:
    """Upper-bound magnitude estimation product for accurate mode
    (reference: scaling_accu_real.hpp:415-432).

    INT8: the exact product of the int8 planes, int32 while k <= K_SAFE_INT8,
    past that f64 sums of int32 chunk products, as the JAX twin chunks it.
    FP8: the exact integer product rounded once to f32, inflated by
    (1 + (k+1)*2^-24) as the twin inflates its f32-accumulated dot. The twin's
    dot is exact while k*258^2 < 2^24 (k <= 252), where the two agree bit for
    bit; past that its last bits follow XLA's summation order, and this one
    stays an upper bound that is the same on the CPU and the card. The exact
    sum comes from four int8 products of the split ub = 128*h + l.

    Shapes follow torch._int_mm's rules on the card (the callers pad to 128).
    """
    k = ub_a.shape[1]
    ub_b = _k_contiguous(ub_b)
    if backend == tables.Backend.INT8:
        if k <= K_SAFE_INT8:
            return int_mm(ub_a, ub_b)
        return _int_mm_f64(ub_a, ub_b, K_CHUNK_EST)

    def split(x):   # ub = 128*h + l, h in {0, 1, 2}, l in [0, 127]
        x = x.to(torch.int16)
        return (x >> 7).to(torch.int8), (x & 127).to(torch.int8)

    (ha, la), (hb, lb) = split(ub_a), split(ub_b)
    tot = _int_mm_f64(ha, hb, K_CHUNK_EST_FP8) * 16384.0
    tot += (_int_mm_f64(ha, lb, K_CHUNK_EST_FP8)
            + _int_mm_f64(la, hb, K_CHUNK_EST_FP8)) * 128.0
    tot += _int_mm_f64(la, lb, K_CHUNK_EST_FP8)
    return tot.to(torch.float32) * _f32(1.0 + (k + 1) * 2.0 ** -24, ub_a)


def shift_accu_from_chi(c_hi_max: torch.Tensor, sft_pre: torch.Tensor,
                        num_moduli: int, backend: str) -> torch.Tensor:
    """sft = sft_pre + floor(log2P - ~0.5*log2(max C_hi) - margin) from the
    row or column maximum of the estimation product (reference:
    scaling_accu_real.hpp:6-11, 142-226; the sign is the quantization
    shift's). As in shift_fast, the f32 log2 may differ from XLA's in the
    last bit (under jit XLA takes log(x)/log(2) with its own log), so a value
    within about an ulp of an integer can floor the other way."""
    safe = torch.clamp(c_hi_max, min=1).to(torch.float32)
    log2p = _f32(tables.log2P(num_moduli, backend), safe)
    add = torch.floor((log2p - _f32(LOG2_HALF_RU, safe) * torch.log2(safe))
                      - _f32(SFT_MARGIN, safe)).to(torch.int32)
    return sft_pre + add


# ---------------------------------------------------------------------------
# residue-plane encoding
# ---------------------------------------------------------------------------

def _n_comp(dtype) -> int:
    # f64 is IEEE on the CPU and the card: three components hold it exactly
    return 1 if dtype == torch.float32 else 3


def n_limbs(num_moduli: int, backend: str) -> int:
    """20-bit limb count of the quantized integer (|v| < 2^(log2P + 3))."""
    dpos_max = int(tables.log2P(num_moduli, backend)) + 3
    return dpos_max // 20 + 2


def limb_weights(num_moduli: int, backend: str) -> list[list[int]]:
    """Per modulus: wrap(2^(20*lv) mod p) for lv = 0 .. n_limbs-1."""
    out = []
    for p in tables.moduli(backend)[:num_moduli]:
        ws = []
        for lv in range(n_limbs(num_moduli, backend)):
            w = pow(2, 20 * lv, p)
            ws.append(w - p if 2 * w >= p else w)
        out.append(ws)
    return out


def _wrap(v: torch.Tensor, p: int) -> torch.Tensor:
    """v mod p, wrapped to [-p/2, p/2)."""
    r = torch.remainder(v, p)
    return torch.where(2 * r >= p, r - p, r)


def residues_wrapped(x: torch.Tensor, sft: torch.Tensor, scale_axis: int,
                     num_moduli: int, backend: str) -> torch.Tensor:
    """Quantize x with per-row/col shifts and emit all wrapped residues.

    x: (m, k) [scale_axis=0: shift per row] or (k, n) [scale_axis=1: per col];
    sft: int32 shifts of shape x.shape[scale_axis]. Returns int32 residues
    (num_moduli, *x.shape): plane i = wrap(v mod p_i) in [-p_i/2, p_i/2).
    """
    mods = tables.moduli(backend)[:num_moduli]
    reduce_axis = 1 - scale_axis
    y = pow2_scale(x, sft.unsqueeze(reduce_axis))
    comps = f32_components(y, _n_comp(x.dtype))

    # per-component integer/fraction split (shared across all moduli)
    parts = []
    G = torch.zeros(y.shape, dtype=torch.float32, device=x.device)
    for c in comps:
        s, m, e = f32_decompose(c)
        d = e - 23                      # value = s * m * 2^d
        sig = torch.clamp(-d, 0, 31)
        m_int = m >> sig                # integer magnitude contribution
        dpos = torch.clamp(d, 0, tables.MAX_EXP)
        mfrac = m - (m_int << sig)
        frac = mfrac.to(torch.float32) * pow2(torch.clamp(d, min=-30),
                                              torch.float32)
        frac = torch.where(-d > 30, torch.abs(c), frac)  # component below 2^-6
        G = G + s.to(torch.float32) * frac
        parts.append((s, m_int, dpos))
    g = torch.floor(G).to(torch.int32)  # joint carry of the fractional parts

    # v = g + sum_c s*m_int*2^dpos in balanced 20-bit int32 limbs
    nl = n_limbs(num_moduli, backend)
    limbs = [g] + [torch.zeros_like(g) for _ in range(nl - 1)]
    for s, m_int, dpos in parts:
        off = dpos % 20
        li = dpos // 20
        sh = 20 - off
        mhi = m_int >> sh
        mlo = m_int - (mhi << sh)
        c_lo = s * (mlo << off)                           # < 2^20
        c_hi = s * mhi                                    # < 2^23
        for lv in range(nl):
            limbs[lv] = (limbs[lv] + torch.where(li == lv, c_lo, 0)
                         + torch.where(li == lv - 1, c_hi, 0))
    half = 1 << 19
    for lv in range(nl - 1):
        c = (limbs[lv] + half) >> 20
        limbs[lv] = limbs[lv] - (c << 20)
        limbs[lv + 1] = limbs[lv + 1] + c

    # residues of v: a per-modulus dot with the static wrap(2^(20*lv) mod p)
    planes = []
    for p, ws in zip(mods, limb_weights(num_moduli, backend)):
        acc = limbs[0]
        for lv in range(1, nl):
            acc = acc + limbs[lv] * ws[lv]
        planes.append(_wrap(acc, p))                   # [-p/2, p/2)
    return torch.stack(planes)


def mod_reduce(c_hi: torch.Tensor, num_moduli: int, backend: str) -> torch.Tensor:
    """C_mid[i] = wrap(C_hi[i] mod p_i) (reference: conv_hi2mid_real.hpp):
    int8 for the INT8 moduli, int16 for the FP8 ones (up to 1089; an int8
    cast would wrap them silently). C_hi may be int32 or already-wrapped
    residues (on which this is the identity)."""
    mods = tables.moduli(backend)[:num_moduli]
    out = torch.int8 if backend == tables.Backend.INT8 else torch.int16
    return torch.stack([_wrap(c_hi[i].to(torch.int32), p).to(out)
                        for i, p in enumerate(mods)])


def _recombine_3m(mids, num_moduli, backend):
    """(3, nu, m, n) wrapped lane-product residues -> (re, im), each
    (nu, m, n) wrapped residues, int8 for the INT8 moduli and int16 for the
    FP8 ones: Re = Crr - Cii, Im = Crii - Crr - Cii, mod p (reference:
    conv_hi2mid_complex.hpp:9-40)."""
    mid_t = torch.int8 if backend == tables.Backend.INT8 else torch.int16
    out_r, out_i = [], []
    for i, p in enumerate(tables.moduli(backend)[:num_moduli]):
        crr, cii, cri = (mids[lane, i].to(torch.int32) for lane in range(3))
        out_r.append(_wrap(crr - cii, p).to(mid_t))
        out_i.append(_wrap(cri - crr - cii, p).to(mid_t))
    return torch.stack(out_r), torch.stack(out_i)
