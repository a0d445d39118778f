"""FP8 backend: residue planes split into fp8-e4m3-exact pairs/triples.

The counterpart of gemmul8_tpu/fp8.py. The FP8 moduli are large (up to 1089),
so each wrapped residue r is split without error into small integers that are
exact e4m3 values, all in [-16, 16]:

  * perfect-square moduli p = q^2 (the first NOT_KARATSUBA = 6):
    r = q*bx + by with bx = rint(r/q), by = r - q*bx; r_a*r_b mod p needs the
    three products C0 = ax*by, C1 = ay*bx, C2 = ay*by (the q^2*ax*bx term
    vanishes mod p), recombined q*(C0 + C1) + C2;
  * the other moduli: r = 16*bx + by with bx = sign(r)*ceil(|r|/16) (so
    |by| <= 15 and |bz = bx + by| <= 16), the Karatsuba triple (bx, by, bz):
    C0 = ax*bx, C1 = ay*by, C2 = az*bz, recombined
    256*C0 + 16*(C2 - C0 - C1) + C1.

The encoder (kernels.encode_planes_fp8) emits each operand as the (3nu, rows,
cols) GEMM-ready stack of its side's slot order, torch.float8_e4m3fn. On the
card the 3nu products run on the FP8 tensor cores, one torch._scaled_mm each
(f32 output, unit scales, full-precision accumulation), as the JAX package
leaves its batched dot to XLA; on the CPU they are one f32 torch.matmul of the
planes. Both are exact while every partial sum stays below 2^24 in magnitude:
|plane| <= 16, so products are at most 256 and K is chunked at 2^16.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _tables_data, quantize, tables
from .spans import span

#: K chunk bound for exact f32 accumulation of fp8-plane products
#: (max |plane| = 16 -> max product 256; 256 * 2^16 = 2^24)
K_CHUNK_FP8 = 1 << 16

_FP8 = tables.Backend.FP8


def _sqrt_moduli() -> tuple[int, ...]:
    """Integer square roots of the perfect-square FP8 moduli (the table's
    row, reference: table.hpp:56-62 sqrt_moduli)."""
    return tuple(_tables_data.SQRT_MODULI_FP8)


def split_planes(res: torch.Tensor, num_moduli: int) -> torch.Tensor:
    """Split wrapped residues (nu, r, c) into e4m3-exact plane triples.

    Returns (nu, 3, r, c) float8_e4m3fn with slots (x, y, z); z is 0 for the
    square moduli. Error-free: r == q*x + y (square moduli) and
    r == 16*x + y, z == x + y (Karatsuba moduli)."""
    sqrts = _sqrt_moduli()
    outs = []
    for i in range(num_moduli):
        r = res[i].to(torch.int32)
        if i < tables.NOT_KARATSUBA:
            q = sqrts[i]
            rf = r.to(torch.float32)
            bx = torch.round(rf * float(np.float32(1.0 / q)))
            by = rf - float(q) * bx
            bz = torch.zeros_like(bx)
        else:
            mag = (torch.abs(r) + 15) >> 4                 # ceil(|r|/16)
            bx_i = torch.where(r < 0, -mag, mag)
            by_i = r - 16 * bx_i
            bx = bx_i.to(torch.float32)
            by = by_i.to(torch.float32)
            bz = (bx_i + by_i).to(torch.float32)
        outs.append(torch.stack([bx, by, bz]).to(torch.float8_e4m3fn))
    return torch.stack(outs)


# slot gather orders per modulus kind: products for square moduli are
# (ax*by, ay*bx, ay*by); for Karatsuba (ax*bx, ay*by, az*bz)
_LHS_SLOTS = {"sqrt": (0, 1, 1), "kar": (0, 1, 2)}
_RHS_SLOTS = {"sqrt": (1, 0, 1), "kar": (0, 1, 2)}


def slot_order(num_moduli: int, side: str) -> list[tuple[int, int]]:
    """(modulus, slot) of each plane of a (3nu, ...) stack for one side."""
    table = _LHS_SLOTS if side == "lhs" else _RHS_SLOTS
    return [(i, s) for i in range(num_moduli)
            for s in table["sqrt" if i < tables.NOT_KARATSUBA else "kar"]]


def _gemm_stack(planes: torch.Tensor, num_moduli: int, side: str) -> torch.Tensor:
    """(nu, 3, r, c) canonical planes -> (3nu, r, c) GEMM operand stack."""
    return torch.stack([planes[i, s] for i, s in slot_order(num_moduli, side)])


def lhs_to_rhs_stack(stack3: torch.Tensor, num_moduli: int) -> torch.Tensor:
    """Reorder a (3nu, r, c) LHS-slot-order stack into RHS slot order: each
    square-modulus group (x, y, y) becomes (y, x, y) = rows (1, 0, 2);
    Karatsuba groups are the same on both sides."""
    idx = []
    for i in range(num_moduli):
        idx += ([3 * i + 1, 3 * i, 3 * i + 2] if i < tables.NOT_KARATSUBA
                else [3 * i, 3 * i + 1, 3 * i + 2])
    return stack3[torch.tensor(idx, device=stack3.device)]


@span("products")
def residue_matmul_fp8(a3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """(3nu, m, k) @ (3nu, k, n) e4m3 planes -> (3nu, m, n) f32 exact integer
    products, k <= K_CHUNK_FP8.

    On the card: one torch._scaled_mm per plane (A row-major, B a column-major
    view, unit scales, out_dtype f32, use_fast_accum=False) into one
    preallocated stack. On the CPU: an f32 matmul of the planes."""
    if a3.device.type == "cpu":
        return torch.matmul(a3.to(torch.float32), b3.to(torch.float32))
    n_planes, m, _ = a3.shape
    c3 = torch.empty((n_planes, m, b3.shape[2]), dtype=torch.float32,
                     device=a3.device)
    one = torch.ones((), dtype=torch.float32, device=a3.device)
    for i in range(n_planes):
        torch._scaled_mm(a3[i], b3[i], one, one, out_dtype=torch.float32,
                         use_fast_accum=False, out=c3[i])
    return c3


def _reassemble(c3: torch.Tensor, num_moduli: int) -> torch.Tensor:
    """(3nu, m, n) int32 exact products -> (nu, m, n) int32 wrapped residues
    of each modulus' product."""
    mods = tables.moduli(_FP8)[:num_moduli]
    sqrts = _sqrt_moduli()
    outs = []
    for i, p in enumerate(mods):
        c0, c1, c2 = c3[3 * i], c3[3 * i + 1], c3[3 * i + 2]
        if i < tables.NOT_KARATSUBA:
            u = torch.remainder(c0 + c1, p)                # |c0+c1| < 2^25
            t = torch.remainder(sqrts[i] * u + torch.remainder(c2, p), p)
        else:
            r0, r1, r2 = (torch.remainder(c, p) for c in (c0, c1, c2))
            t = torch.remainder(256 * r0 + 16 * (r2 - r0 - r1) + r1, p)
        outs.append(torch.where(2 * t >= p, t - p, t))
    return torch.stack(outs)


@span("products")
def _chunked_residue_acc(a3: torch.Tensor, b3: torch.Tensor,
                         num_moduli: int) -> torch.Tensor:
    """K-chunked int32 residue accumulator: sums of per-chunk wrapped
    residues (|part| <= p/2, so n_chunks * p/2 < 2^31)."""
    k = a3.shape[2]
    acc = None
    for lo in range(0, k, K_CHUNK_FP8):
        sl = slice(lo, min(lo + K_CHUNK_FP8, k))
        c3 = residue_matmul_fp8(a3[:, :, sl], b3[:, sl, :]).to(torch.int32)
        part = _reassemble(c3, num_moduli)
        acc = part if acc is None else acc + part
    return acc


def residue_gemm_fp8(a3: torch.Tensor, b3: torch.Tensor,
                     num_moduli: int) -> torch.Tensor:
    """Full-K exact FP8-backend residue GEMM of two (3nu, ...) stacks ->
    wrapped int16 C_mid (nu, m, n); K beyond K_CHUNK_FP8 is summed in
    residue space."""
    if a3.shape[2] <= K_CHUNK_FP8:
        c3 = residue_matmul_fp8(a3, b3).to(torch.int32)
        return _reassemble(c3, num_moduli).to(torch.int16)
    return quantize.mod_reduce(_chunked_residue_acc(a3, b3, num_moduli),
                               num_moduli, _FP8)
