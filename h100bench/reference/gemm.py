"""The plain reference of an emulated GEMM: alpha A B + beta C in the
configuration's own dtype with torch.matmul (cuBLAS DGEMM or ZGEMM on the
card), in blocks of rows, and the gap by which an output departs from it.

The gap of an element is |out - ref| over alpha |A||B| + beta |C| at that
element (|.| the complex modulus): the error the emulation's accuracy
promise is stated in, free of the element's own cancellation. A NaN
reads infinity, and so does a shape or dtype other than the reference's.
"""
from __future__ import annotations

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "complex128": torch.complex128, "complex64": torch.complex64}


def _highest_precision() -> None:
    # float32 products on this card may otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def product(a, b, c, alpha, beta, dtype) -> torch.Tensor:
    """alpha a b + beta c computed in `dtype`."""
    _highest_precision()
    out = torch.matmul(a.to(dtype), b.to(dtype))
    if alpha != 1:
        out = alpha * out
    if c is not None and beta != 0:
        out = out + beta * c.to(dtype)
    return out


def max_gap(out: torch.Tensor, ops: dict, config: dict, traffic: dict,
            block_rows: int = 2048) -> float:
    """The largest gap of `out` (on any device) from the reference on the
    operands `ops` (on the device the reference runs on)."""
    a, b, c = ops["a"], ops["b"], ops["c"]
    alpha, beta = traffic["alpha"], traffic["beta"]
    dtype = DTYPES[config["dtype"]]
    m, n = a.shape[0], b.shape[1]
    if tuple(out.shape) != (m, n) or out.dtype != dtype:
        return float("inf")
    abs_b = b.abs()
    worst = 0.0
    for r0 in range(0, m, block_rows):
        rows = slice(r0, min(m, r0 + block_rows))
        c_rows = None if c is None else c[rows]
        ref = product(a[rows], b, c_rows, alpha, beta, dtype)
        bnd = abs(alpha) * torch.matmul(a[rows].abs(), abs_b)
        if c_rows is not None and beta != 0:
            bnd = bnd + abs(beta) * c_rows.abs()
        diff = (out[rows].to(a.device) - ref).abs()
        # a bound of 0 takes the least normal: any difference there fails
        gap = diff / bnd.clamp_min(torch.finfo(bnd.dtype).tiny)
        worst = max(worst, torch.nan_to_num(gap.max(), nan=torch.inf).item())
        del ref, bnd, diff, gap
    return worst


def control(config: dict, traffic: dict):
    """call(ops) -> the reference computed in the configuration's
    control_dtype (TF32 off), returned in the configuration's dtype: what a
    lower-precision shortcut would give in the program's place."""
    dtype = DTYPES[config["dtype"]]
    lower = DTYPES[config["control_dtype"]]

    def call(ops):
        return product(ops["a"], ops["b"], ops["c"], traffic["alpha"],
                       traffic["beta"], lower).to(dtype)

    return call
