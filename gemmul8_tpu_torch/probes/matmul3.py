"""Counterpart of tools/probe_matmul3.py on the card: the batched exact int8
product on the flat plane views A (nu*m, k) and B (nu*k, n) -> C (nu*m, n),
with a K loop (mm_flat_kloop), full-K cells (mm_flat_fullk) and a deeper K
stage per step (mm_flat_kloop_multidot), through the hand-written
tensor-core kernels (csrc/matmul_i8_wgmma.cu wherever TMA can address the
operands, and csrc/matmul_i8.cu's mma.sync kernel in the rows named so),
beside core.int_mm_stack (one torch._int_mm per plane, given B
k-contiguous: the library's product).

    python -m gemmul8_tpu_torch.probes.matmul3 [nu m]

The flat views are the same memory as the batched (nu, m, k) and (nu, k, n)
ones, so each function hands the kernel those: the K-loop schedule for the
K-loop cells (on the mma.sync kernel 128-deep K stages for the multi-dot
ones, which double the depth per step as the tool's nd dots do; the wgmma
kernel always stages 128 bytes of K) and the A-stationary one for the
full-K cells, whose A block stays put across the column sweep. B is the
tool's n-contiguous flat view, so the wgmma rows include the transposing
pass.
"""
from __future__ import annotations

import sys

import torch

from .. import core, kernels
from .fused import random_planes, report
from .timing import k_contiguous, require_cuda


def _flat(a2, b2, nu, m, k, n, schedule, bk, kernel):
    c = kernels.matmul_i8(a2.view(nu, m, k), b2.view(nu, k, n), schedule, bk,
                          kernel)
    return c.view(nu * m, n)


def mm_flat_kloop(a2, b2, *, nu, m, k, n, kernel="auto"):
    """A: (nu*m, k), B: (nu*k, n) -> C: (nu*m, n); K innermost."""
    return _flat(a2, b2, nu, m, k, n, "kloop", 64, kernel)


def mm_flat_fullk(a2, b2, *, nu, m, k, n, kernel="auto"):
    """Full-K cells: each block's rows of A across every column block."""
    return _flat(a2, b2, nu, m, k, n, "astat", 64, kernel)


def mm_flat_kloop_multidot(a2, b2, *, nu, m, k, n, kernel="auto"):
    """K loop with a 128-deep K stage per step."""
    return _flat(a2, b2, nu, m, k, n, "kloop", 128, kernel)


def main(nu=16, m=4096, seed=0, reps=5):
    """The tool's table at nu planes of m x m x m; returns the rows (name,
    ms, tops, ok, launches)."""
    require_cuda("probes.matmul3")
    print("device:", torch.cuda.get_device_name(0), flush=True)
    k = n = m
    a3, b3 = random_planes(nu, m, k, n, seed)
    a2, b2 = a3.view(nu * m, k), b3.view(nu * k, n)
    b_kc = k_contiguous(b3)
    ref = core.int_mm_stack(a3[:, :256].contiguous(), b_kc)
    ops = 2.0 * nu * m * n * k
    dims = dict(nu=nu, m=m, k=k, n=n)
    rows = []
    report(rows, "torch._int_mm x nu", lambda: core.int_mm_stack(a3, b_kc),
           256, ref, ops, reps)
    for kernel, prefix in (("auto", ""), ("mma_sync", "mma.sync ")):
        for name, fn in (("flat-kloop", mm_flat_kloop),
                         ("flat-fullk", mm_flat_fullk),
                         ("flat-multidot", mm_flat_kloop_multidot)):
            report(rows, prefix + name,
                   lambda fn=fn, kernel=kernel: fn(a2, b2, **dims,
                                                   kernel=kernel),
                   256, ref, ops, reps, shape=(nu, m, n))
    if not all(r["ok"] for r in rows):
        raise AssertionError("probes.matmul3: a product differs from "
                             "torch._int_mm")
    return rows


if __name__ == "__main__":
    main(*(int(v) for v in sys.argv[1:3]))
