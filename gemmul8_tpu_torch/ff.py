"""CRT epilogue in exact int32 fixed-point limbs.

The PyTorch counterpart of gemmul8_tpu/ff.py. On the production path, the
matrix plan (crt_limbs_matrix), the CRT sum t = sum_i qPi * r_i is
accumulated in 16-bit int32 limbs on a static power-of-two grid, the wrap
quotient rint(t / P) is estimated from the top limbs after a balanced
carry, P * quot is folded back in and the limbs are carried again. Each
limb is then scaled by its exact power of two and the limbs are summed in
the output dtype. The only approximations are the static sub-base cutoff
and the final roundings into the output dtype.

The JAX twin forms the limb sums as an f32 product against 8-bit columns of
qPi; here they are int32 multiply-adds against the 16-bit limb weights (the
fused kernel's form). Both give the same exact integers.

crt_limbs (20-bit limbs built from 12-bit pieces of the qPi tables' f32
expansions) is kept, as in JAX, as an independent cross-check of
crt_limbs_matrix and is on no production route; two_prod_const, like
JAX's, serves the tests.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import quantize, tables


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth; 6 flops, branch-free)."""
    s = a + b
    t = s - a
    e = (a - (s - t)) + (b - t)
    return s, e


_SPLIT = np.float32((1 << 12) + 1)
LIMB_BITS = 20
_LIMB = 1 << LIMB_BITS


def two_prod_const(c_np, x):
    """Error-free c * x = p + e for an f32 CONSTANT c (host-side Veltkamp
    split) times an f32 tensor x (runtime Dekker split). Each step is its
    own rounded f32 operation, as in eager JAX (no fused multiply-add)."""
    c_np = np.float32(c_np)
    ch, cl = (float(v) for v in _split12_const(c_np))
    cx = x * float(_SPLIT)
    xh = cx - (cx - x)
    xl = x - xh
    p = x * float(c_np)
    e = ((xh * ch - p) + xl * ch + xh * cl) + xl * cl
    return p, e


def _split12_const(v):
    """Veltkamp split of an f32 constant into (hi, lo), each with <= 12
    significant bits, computed in exact f32 host arithmetic."""
    v = np.float32(v)
    c = np.float32(_SPLIT * v)
    hi = np.float32(c - np.float32(c - v))
    lo = np.float32(v - hi)
    return hi, lo


def _int_pieces(value_f64: float, max_bits: int = 12):
    """Decompose an exact f64 (24-bit-mantissa component) into signed integer
    pieces m * 2^g with |m| < 2^max_bits. Exact (host numpy, as in JAX)."""
    pieces = []
    v = np.float64(value_f64)
    while v != 0.0:
        g = int(np.floor(np.log2(abs(v)))) - (max_bits - 1)
        m = v * (2.0 ** -g)
        m_int = int(np.floor(m))  # may leave a remainder piece
        pieces.append((m_int, g))
        v = v - m_int * (2.0 ** g)
    return pieces


@functools.lru_cache(maxsize=None)
def _crt_matrix_plan(num_moduli: int, backend: str, out_bits: int):
    """Matrix-form CRT plan from exact python integers (no table truncation).

    Returns (base, n_cols, C, pcols, invp_top):
      base    -- bit position of column 0 (column j has unit 2^(base+8j))
      C       -- (nu, n_cols) f32 of 8-bit slices of qPi (>> base)
      pcols   -- (n_cols,) f32 of 8-bit slices of P (positive)
      invp_top-- f32 of 1/P * 2^(base + 16*(L-3)) for the quotient
    """
    mods = [int(p) for p in tables.moduli(backend)[:num_moduli]]
    P = 1
    for p in mods:
        P *= p
    qpis = []
    for p in mods:
        Pi = P // p
        q = pow(Pi % p, -1, p)
        qpis.append(q * Pi)                      # exact integer q_i * P / p_i
    ptop = P.bit_length() - 1
    lo_bits = 95 if out_bits == 53 else 56
    base = max(ptop - lo_bits, 0)
    top = ptop + 16
    n_cols = -(-(top - base) // 8)
    C = np.zeros((num_moduli, n_cols), np.float32)
    for i, v in enumerate(qpis):
        v >>= base
        for j in range(n_cols):
            C[i, j] = np.float32(v & 0xFF)
            v >>= 8
    pcols = np.zeros((n_cols,), np.float32)
    v = P >> base
    for j in range(n_cols):
        pcols[j] = np.float32(v & 0xFF)
        v >>= 8
    L = (n_cols + 1) // 2
    n_est = min(3, L)
    invp_top = np.float32(2.0 ** (base + 16 * (L - n_est)) / P)
    return base, n_cols, C, pcols, invp_top


@functools.lru_cache(maxsize=None)
def limb_plan(num_moduli: int, backend: str, out_bits: int):
    """16-bit limb form of the matrix plan: (base, L, w16, p16, invp_top).
    w16[i][li] = 16-bit slice li of qPi >> base; p16[li] likewise of P."""
    base, n_cols, C, pcols, invp_top = _crt_matrix_plan(
        num_moduli, backend, out_bits)
    L = (n_cols + 1) // 2

    def pair(col, li):
        v = int(col[2 * li])
        if 2 * li + 1 < n_cols:
            v += int(col[2 * li + 1]) << 8
        return v

    w16 = tuple(tuple(pair(C[i], li) for li in range(L))
                for i in range(num_moduli))
    p16 = tuple(pair(pcols, li) for li in range(L))
    return base, L, w16, p16, float(invp_top)


def _carry16(limbs):
    """Balanced carry pass: every limb but the top into [-2^15, 2^15)."""
    for li in range(len(limbs) - 1):
        c = (limbs[li] + (1 << 15)) >> 16
        limbs[li] = limbs[li] - (c << 16)
        limbs[li + 1] = limbs[li + 1] + c
    return limbs


def crt_limbs_matrix(c_mid: torch.Tensor, num_moduli: int, backend: str,
                     out_bits: int):
    """Exact CRT accumulate + wrap. c_mid: (nu, m, n) wrapped residues.
    Returns (limbs, base): L int32 tensors of 16-bit balanced limbs (unit
    2^(base+16*li)) summing to the reconstructed integer t, |t| < P/2."""
    base, L, w16, p16, invp_top = limb_plan(num_moduli, backend, out_bits)
    res = c_mid.to(torch.int32)
    limbs = [torch.zeros(c_mid.shape[1:], dtype=torch.int32,
                         device=c_mid.device) for _ in range(L)]
    for i in range(num_moduli):
        for li in range(L):
            if w16[i][li]:
                # |r * w16| <= (p/2) * 65535 < 2^26; nu-term sums < 2^31
                limbs[li] = limbs[li] + res[i] * w16[i][li]
    return fold_quotient(limbs, p16, invp_top), base


def fold_quotient(limbs, p16, invp_top):
    """Carry the raw limb sums, estimate rint(t / P) from the top (up to
    three) balanced limbs in f32, fold -quot * P in and carry again: the
    limbs then sum to t, |t| < P/2."""
    L = len(limbs)
    limbs = _carry16(limbs)
    t_top = limbs[L - 1].to(torch.float32)
    for i in range(2, min(3, L) + 1):
        t_top = t_top * 65536.0 + limbs[L - i].to(torch.float32)
    quot = torch.round(t_top * np.float32(invp_top)).to(torch.int32)
    for li in range(L):
        if p16[li]:
            limbs[li] = limbs[li] - quot * p16[li]
    return _carry16(limbs)


@functools.lru_cache(maxsize=None)
def _crt_plan(num_moduli: int, backend: str, out_bits: int):
    """Static 20-bit limb-accumulation plan of crt_limbs.

    Returns (base, L, terms, invp_top, p_terms):
      base     -- exponent of limb 0's unit (limb li has unit 2^(base+20*li))
      L        -- number of limbs
      terms    -- ((plane_index, m_int, limb_idx, offset), ...): for each
                  12-bit qPi piece, where its (m*r) product lands
      invp_top -- f32 constant: invP * 2^(base + 20*(L-3)) for the quotient
                  estimate from the top three limbs
      p_terms  -- ((m_int, limb_idx, offset), ...) integer pieces of P
                  (stored negative) for folding P*quot into the limbs
    """
    qp = np.asarray(tables.qPi_f32x(num_moduli, backend), np.float64)  # (nu,4)
    p_hi = abs(tables.P_dd(num_moduli, backend)[0])
    ptop = int(np.floor(np.log2(p_hi)))
    # pieces cut below `base` contribute error <= 2^(base+11) each, so base
    # sits 11 bits under the target floor; with the qPi tables' own ~96-bit
    # truncation the absolute error stays within ~P * 2^-80 (f64 outputs)
    lo_bits = 95 if out_bits == 53 else 56
    base = ptop - lo_bits
    top = ptop + 16
    L = -(-(top - base) // LIMB_BITS) + 1

    def place(m_int, g):
        d = g - base
        li, off = divmod(d, LIMB_BITS)
        return (m_int, li, off)

    terms = []
    for i in range(num_moduli):
        for j in range(qp.shape[1]):
            for m_int, g in _int_pieces(qp[i, j]):
                if g + 23 < base or m_int == 0:
                    continue
                if g < base:      # partial: fold what remains above base
                    m_int = m_int >> (base - g)
                    g = base
                if m_int:
                    terms.append((i,) + place(m_int, g))
    pexp = np.asarray(tables.P_f32x(num_moduli, backend), np.float64)
    p_terms = []
    for v in pexp:
        for m_int, g in _int_pieces(v):
            if g + 26 < base or m_int == 0:
                continue
            if g < base:
                m_int = m_int >> (base - g)
                g = base
            if m_int:
                p_terms.append(place(m_int, g))
    invp_top = np.float32(np.float64(tables.invP(num_moduli, backend))
                          * 2.0 ** (base + LIMB_BITS * (L - 3)))
    return base, L, tuple(terms), invp_top, tuple(p_terms)


def _add_to_limbs(limbs: list, prod, li: int, off: int):
    """Fold an int32 product (|prod| < 2^26) into limbs li/li+1 at bit offset
    off (static). Floor-division split keeps the low part non-negative."""
    if off == 0:
        limbs[li] = limbs[li] + prod
        return
    hi = prod >> (LIMB_BITS - off)                    # arithmetic shift: floor
    lo = prod - (hi << (LIMB_BITS - off))
    limbs[li] = limbs[li] + (lo << off)
    if li + 1 < len(limbs):
        limbs[li + 1] = limbs[li + 1] + hi


def crt_limbs(c_mid: torch.Tensor, num_moduli: int, backend: str,
              out_bits: int):
    """Exact CRT accumulate + wrap into carry-normalized int32 limbs, on
    c_mid's device.

    c_mid: (nu, m, n) wrapped residues. Returns (limbs, base): limbs is a
    list of L int32 tensors with t = sum_li limbs[li] * 2^(base + 20*li),
    |t| < P/2, every limb in [-2^19, 2^19) except the (signed) top limb.
    """
    base, L, terms, invp_top, p_terms = _crt_plan(num_moduli, backend, out_bits)
    planes = [c_mid[i].to(torch.int32) for i in range(num_moduli)]

    shape = c_mid.shape[1:]
    limbs = [torch.zeros(shape, dtype=torch.int32, device=c_mid.device)
             for _ in range(L)]
    for i, m_int, li, off in terms:
        _add_to_limbs(limbs, planes[i] * m_int, li, off)

    # wrap: quot = rint(t * invP) from the top three limbs (f32; |quot|<2^14)
    t_top = (limbs[L - 1].to(torch.float32) * float(_LIMB)
             + limbs[L - 2].to(torch.float32)) * float(_LIMB) \
        + limbs[L - 3].to(torch.float32)
    quot = torch.round(t_top * float(invp_top)).to(torch.int32)
    for m_int, li, off in p_terms:
        _add_to_limbs(limbs, quot * m_int, li, off)

    # one balanced carry pass, low -> high: limbs in [-2^19, 2^19), so a
    # small-magnitude t leaves the high limbs at zero
    half = 1 << (LIMB_BITS - 1)
    for li in range(L - 1):
        c = (limbs[li] + half) >> LIMB_BITS
        limbs[li] = limbs[li] - (c << LIMB_BITS)
        limbs[li + 1] = limbs[li + 1] + c
    return limbs, base


def pow2_f32(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e f32 by exponent-field assembly; e must be in [-126, 127]."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def reconstruct_scale_ff(c_mid: torch.Tensor, sft_a: torch.Tensor,
                         sft_b: torch.Tensor, num_moduli: int, backend: str,
                         out_dtype) -> torch.Tensor:
    """Exact limb CRT + inverse power-of-two scaling + output assembly.

    f64 out: each limb is scaled in f64 over the full exponent range and the
    limbs are summed highest first (IEEE f64 on the CPU and the card).
    f32 out: the rank-1 pow2 descale with a compensated merge (descale_accel).
    """
    out_bits = 53 if out_dtype == torch.float64 else 24
    limbs, base = crt_limbs_matrix(c_mid, num_moduli, backend, out_bits)
    lb = 16
    if out_bits == 53:
        sft_sum = sft_a[:, None] + sft_b[None, :]
        out = None
        for li in range(len(limbs) - 1, -1, -1):
            term = quantize.pow2_scale(limbs[li].to(out_dtype),
                                       base + lb * li - sft_sum)
            out = term if out is None else out + term
        return out
    return descale_accel(limbs, base, lb, sft_a, sft_b, out_bits, out_dtype)


def _descale_factors(sft: torch.Tensor):
    """Three pow2 factors of 2^-sft, split by multiply-shift so each stays
    f32-normal for |sft| up to ~378."""
    t = -sft
    h1 = (t * 21846) >> 16                              # ~t/3
    r = t - h1
    h2 = r >> 1
    return pow2_f32(h1), pow2_f32(h2), pow2_f32(r - h2)


def descale_accel(limbs, base, lb, sft_a, sft_b, out_bits, out_dtype):
    """Rank-1 descale in f32 (descale_pair), combined in the output dtype."""
    hi, lo = descale_pair(limbs, base, lb, sft_a, sft_b)
    if out_bits == 24:
        return (hi + lo).to(out_dtype)
    return hi.to(out_dtype) + lo.to(out_dtype)


def descale_pair(limbs, base, lb, sft_a, sft_b):
    """Rank-1 descale in f32: per-limb static pow2 pair times row and column
    factor triples (all exact), merged smallest-first with two_sum. Returns
    the (hi, lo) f32 pair."""
    fa1, fa2, fa3 = (f[:, None] for f in _descale_factors(sft_a))
    fb1, fb2, fb3 = (f[None, :] for f in _descale_factors(sft_b))
    hi = None
    lo = None
    for li in range(len(limbs)):          # smallest-first
        e_static = base + lb * li
        s1 = float(np.float32(2.0 ** (e_static // 2)))
        s2 = float(np.float32(2.0 ** (e_static - e_static // 2)))
        term = limbs[li].to(torch.float32) * s1
        term = ((term * fa1) * fb1) * s2
        term = (term * fa2) * fb2
        term = (term * fa3) * fb3
        if hi is None:
            hi = term
            lo = torch.zeros_like(term)
        else:
            hi, err = two_sum(hi, term)
            lo = lo + err
    return hi, lo
