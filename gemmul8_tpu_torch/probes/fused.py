"""Counterpart of tools/probe_fused.py on the card: the batched exact int8
product (nu, m, k) x (nu, k, n) -> (nu, m, n) int32, K-sequential
(pallas_matmul_i8_seq) and A-stationary (pallas_matmul_i8_astat), both
through the hand-written tensor-core kernel (csrc/matmul_i8.cu), beside
core.residue_matmul, one torch._int_mm per plane (the counterpart of "XLA
batched dot").

    python -m gemmul8_tpu_torch.probes.fused

Runs the tool's two sweeps (main, main2) in one table, over the kernel's
instantiations: the K-loop schedule with 64- and 128-deep K stages and the
A-stationary one, on the tool's n-contiguous B and on the main path's
k-contiguous B; `ok` holds rows 0-255 against torch._int_mm.
"""
from __future__ import annotations

import torch

from .. import core, kernels
from .timing import cuda_ms, k_contiguous, launches, require_cuda


def matmul_i8_seq(a, b, bk=64):
    """(nu, m, k) i8 x (nu, k, n) i8 -> (nu, m, n) i32; K innermost."""
    return kernels.matmul_i8(a, b, "kloop", bk)


def matmul_i8_astat(a, b):
    """A-stationary: each block keeps its rows of A across the column sweep."""
    return kernels.matmul_i8(a, b, "astat", 64)


def random_planes(nu, m, k, n, seed, device="cuda"):
    """Int8 planes uniform in [-127, 127] from a seeded generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randint(-127, 128, (nu, m, k), dtype=torch.int8, device=device,
                      generator=g)
    b = torch.randint(-127, 128, (nu, k, n), dtype=torch.int8, device=device,
                      generator=g)
    return a, b


def report(rows, name, fn, out_rows, ref, ops, reps, shape=None):
    """Time fn() and hold its rows 0-255 (of each plane, after `shape`)
    against ref; print and append one row. Launches counts the kernel
    launches of this row's calls."""
    n0 = launches()
    out = fn()
    got = out if shape is None else out.view(shape)
    ok = bool(torch.equal(got[:, :out_rows], ref))
    del out, got
    ms = cuda_ms(fn, reps=reps)
    row = dict(name=name, ms=ms, tops=ops / (ms * 1e-3) / 1e12, ok=ok,
               launches=launches() - n0)
    print(f"{name}: {ms:9.3f} ms  {row['tops']:7.1f} TOPS  ok={ok}",
          flush=True)
    rows.append(row)
    return row


def main(nu=16, m=4096, seed=0, reps=5):
    """Both sweeps at nu planes of m x m x m; returns the rows (name, ms,
    tops, ok, launches)."""
    require_cuda("probes.fused")
    print("device:", torch.cuda.get_device_name(0), flush=True)
    a, b = random_planes(nu, m, m, m, seed)
    b_kc = k_contiguous(b)
    ref = core.residue_matmul(a[:, :256].contiguous(), b_kc)
    ops = 2.0 * nu * m ** 3
    rows = []
    report(rows, "torch._int_mm x nu", lambda: core.residue_matmul(a, b_kc),
           256, ref, ops, reps)
    for layout, bb in (("B n-contiguous", b), ("B k-contiguous", b_kc)):
        for bk in kernels.MATMUL_BK["kloop"]:
            report(rows, f"seq bk{bk} {layout}",
                   lambda bk=bk, bb=bb: matmul_i8_seq(a, bb, bk), 256, ref,
                   ops, reps)
        report(rows, f"astat {layout}", lambda bb=bb: matmul_i8_astat(a, bb),
               256, ref, ops, reps)
    if not all(r["ok"] for r in rows):
        raise AssertionError("probes.fused: a product differs from "
                             "torch._int_mm")
    return rows


if __name__ == "__main__":
    main()
