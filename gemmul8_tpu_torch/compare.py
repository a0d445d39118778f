"""Alternative-emulation baselines for the benchmark comparison set.

The counterpart of gemmul8_tpu/compare.py, the reference's comparison rows
(testing/test_accuracy.hpp:84-156: "cuBLAS BF16x9" and the fixed-point FP64
"Ozaki-1" shim, testing/ozaki1.hpp:8-50), on the same library products the
emulator uses:

  * matmul_bf16x9 -- an f32 GEMM from the exact three-way bfloat16 split of
    each operand: nine bf16 products with f32 accumulation, summed smallest
    first. The split is exact and the nine sums are JAX's, in JAX's order;
    each product's own summation order is the library's (the card's bf16
    GEMM, or an f32 matmul of the bf16 values on the CPU), so it is held to
    the JAX package within a tolerance, not bit for bit.
  * matmul_os1_int8 -- an f64 GEMM by Ozaki scheme I: row and column powers
    of two, d 7-bit mantissa slices, one exact int8 product per slice pair
    with s + t < d, combined in the output dtype in a fixed order. Bit-equal
    to the JAX package on the CPU, and the card to the CPU.

Both run on the operands' device, "cuda" unless the caller asks for the CPU.
Neither is a kernel of the JAX package: the products are the library's
(torch._int_mm through quantize.int_mm; the bf16 GEMM).
"""
from __future__ import annotations

import torch

from . import core, quantize

_W = 7                       # slice width (bits) for OS1: products 2^14 * k <= 2^31


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16's grid, round-to-nearest-even, staying in f32
    (lax.reduce_precision(x, 8, 7)): the low 16 bits of the f32 pattern
    rounded off on the integer view, NaN kept. No f32 -> bf16 -> f32
    convert round trip: the JAX package's _bf16_split3 explains why."""
    bits = x.view(torch.int32)
    rounded = (bits + (0x7FFF + ((bits >> 16) & 1))) & -0x10000
    return torch.where(torch.isnan(x), x, rounded.view(torch.float32))


def _bf16_split3(x: torch.Tensor):
    """Exact three-way bfloat16 split of f32 x: x == hi + mid + lo + a
    residual below 2^-48 |x| (gemmul8_tpu/compare.py:36-54). The casts to
    bf16 are exact: the values already sit on its grid."""
    hi_f = _round_bf16(x)
    r1 = x - hi_f
    mid_f = _round_bf16(r1)
    r2 = r1 - mid_f
    lo_f = _round_bf16(r2)
    return tuple(v.to(torch.bfloat16) for v in (hi_f, mid_f, lo_f))


def _bf16_products(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(9, m, k) @ (9, k, n) bf16 -> (9, m, n) f32: the card's bf16 GEMM
    with f32 accumulation and output; on the CPU an f32 matmul of the bf16
    values (each product exact in f32)."""
    if lhs.device.type == "cpu":
        return torch.matmul(lhs.to(torch.float32), rhs.to(torch.float32))
    return torch.bmm(lhs, rhs, out_dtype=torch.float32)


def matmul_bf16x9(a, b, device="cuda") -> torch.Tensor:
    """f32 matmul from nine bf16 products with f32 accumulation (the BF16x9
    technique), the terms summed smallest-magnitude first as the JAX package
    sums them."""
    device = core._device(device)
    a = core._as_tensor(a, device).to(torch.float32)
    b = core._as_tensor(b, device).to(torch.float32)
    a3, b3 = _bf16_split3(a), _bf16_split3(b)
    lhs = torch.stack([a3[i] for i in range(3) for _ in range(3)])
    rhs = torch.stack([b3[j] for _ in range(3) for j in range(3)])
    prods = _bf16_products(lhs, rhs)                 # (9, m, n)
    order = sorted(range(9), key=lambda t: -(t // 3 + t % 3))
    out = prods[order[0]]
    for t in order[1:]:
        out = out + prods[t]
    return out


def _row_scale_exp(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-row/col exponent E with |x| * 2^-E-1 < 1 (amax-normalizing)."""
    amax = torch.amax(torch.abs(x), dim=axis)
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    return quantize.ilogb(safe) + 1


def _shift(v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=like.device)


def _slices_int8(x: torch.Tensor, E: torch.Tensor, axis: int,
                 d: int) -> torch.Tensor:
    """d exact 7-bit mantissa slices of x * 2^-E: (d, *x.shape) int8 with
    x * 2^-E == sum_s slice_s * 2^-(7(s+1)) + residual(|.| < 2^-7d)."""
    y = quantize.pow2_scale(x, -E.unsqueeze(axis))
    outs = []
    rem = y
    for s in range(d):
        v = torch.trunc(quantize.pow2_scale(rem, _shift(_W * (s + 1), x)))
        outs.append(v.to(torch.int8))
        rem = rem - quantize.pow2_scale(v, _shift(-_W * (s + 1), x))
    return torch.stack(outs)


def matmul_os1_int8(a, b, d: int = 8, device="cuda") -> torch.Tensor:
    """f64 (or f32) matmul by Ozaki scheme I on exact int8 products: d 7-bit
    slices per operand, d(d+1)/2 products over the truncated triangle
    s + t < d, each anti-diagonal summed in the output dtype, the diagonals
    combined smallest first (gemmul8_tpu/compare.py:98-134). k <= 2^17 (the
    int32 exactness of 7-bit slice products). On the card the operands are
    zero-padded to multiples of 128, as torch._int_mm's shape rules need;
    zero rows and columns change no other element."""
    device = core._device(device)
    a = core._as_tensor(a, device)
    b = core._as_tensor(b, device)
    out_dtype = a.dtype
    if a.shape[1] > (1 << 17):
        raise ValueError("matmul_os1_int8 supports k <= 2^17")
    m, n = a.shape[0], b.shape[1]
    if device.type != "cpu":
        a, b = core._pad128(a, (0, 1)), core._pad128(b, (0, 1))
    Ea = _row_scale_exp(a, 1)
    Eb = _row_scale_exp(b, 0)
    sa = _slices_int8(a, Ea, 1, d)                  # (d, m, k)
    sb = _slices_int8(b, Eb, 0, d)                  # (d, k, n)
    if device.type != "cpu":                        # k-contiguous B slices
        sb = sb.transpose(-1, -2).contiguous().transpose(-1, -2)
    out = None
    for tot in range(d - 1, -1, -1):                # smallest first
        # same total => same scale: the diagonal summed in the output dtype
        # in a fixed order (int32 would overflow for k near 2^17)
        group = None
        for s in range(tot + 1):
            g = quantize.int_mm(sa[s], sb[tot - s]).to(out_dtype)
            group = g if group is None else group + g
        term = quantize.pow2_scale(group, _shift(-_W * (tot + 2), group))
        out = term if out is None else out + term
    scale = Ea[:, None] + Eb[None, :]
    out = quantize.pow2_scale(out, scale)
    return out if out.shape == (m, n) else out[:m, :n]
