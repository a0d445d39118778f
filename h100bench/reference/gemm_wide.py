"""The plain reference of an emulated GEMM in a dtype narrower than the
emulation's accuracy (float32): alpha A B + beta C computed in float64 from
the float32 operands, and the gap by which an output departs from it.

The gap is gemm.py's: |out - ref| over |alpha| |A||B| + |beta| |C| at each
element, in blocks of rows. Only the arithmetic is wider: a float32
reference rounds as much as the emulation errs at 8 moduli, so the limit
would read the reference and not the program. The output must be float32
of the reference's shape; anything else, or a NaN, reads infinity.

The control is the shortcut an H100 SGEMM user takes: torch.matmul on the
float32 operands with TF32 on (the configuration's control_dtype "tf32").
"""
from __future__ import annotations

import torch


def _highest_precision() -> None:
    # float32 products on this card may otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def max_gap(out: torch.Tensor, ops: dict, config: dict, traffic: dict,
            block_rows: int = 2048) -> float:
    """The largest gap of `out` (on any device) from the float64 reference
    on the float32 operands `ops` (on the device the reference runs on)."""
    m, n = ops["a"].shape[0], ops["b"].shape[1]
    if tuple(out.shape) != (m, n) or out.dtype != torch.float32:
        return float("inf")
    _highest_precision()
    a, b = ops["a"].double(), ops["b"].double()
    c = None if ops["c"] is None else ops["c"].double()
    alpha, beta = traffic["alpha"], traffic["beta"]
    abs_b = b.abs()
    worst = 0.0
    for r0 in range(0, m, block_rows):
        rows = slice(r0, min(m, r0 + block_rows))
        ref = torch.matmul(a[rows], b)
        if alpha != 1:
            ref = alpha * ref
        bnd = abs(alpha) * torch.matmul(a[rows].abs(), abs_b)
        if c is not None and beta != 0:
            ref = ref + beta * c[rows]
            bnd = bnd + abs(beta) * c[rows].abs()
        diff = (out[rows].to(a.device, torch.float64) - ref).abs()
        # a bound of 0 takes the least normal: any difference there fails
        gap = diff / bnd.clamp_min(torch.finfo(bnd.dtype).tiny)
        worst = max(worst, torch.nan_to_num(gap.max(), nan=torch.inf).item())
        del ref, bnd, diff, gap
    return worst


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10 fraction bits, to nearest (ties to
    even): the operands a TF32 tensor-core product takes, for a device
    that has no TF32 product of its own."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def control(config: dict, traffic: dict):
    """call(ops) -> alpha A B + beta C by torch.matmul on the float32
    operands with TF32 on (restored afterwards); off the card, where torch
    has no TF32 product, on operands rounded as TF32 rounds them."""
    alpha, beta = traffic["alpha"], traffic["beta"]

    def call(ops):
        a, b, c = ops["a"], ops["b"], ops["c"]
        if a.device.type != "cuda":
            a, b = tf32(a), tf32(b)
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            out = torch.matmul(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
        if alpha != 1:
            out = alpha * out
        if c is not None and beta != 0:
            out = out + beta * c
        return out

    return call
