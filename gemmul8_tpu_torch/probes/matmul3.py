"""Counterpart of tools/probe_matmul3.py on the card: the batched exact int8
product on the flat plane views A (nu*m, k) and B (nu*k, n) -> C (nu*m, n),
with a K loop (mm_flat_kloop), full-K cells (mm_flat_fullk) and a deeper K
stage per step (mm_flat_kloop_multidot), through the hand-written wgmma +
TMA kernel (csrc/matmul_i8_wgmma.cu), beside core.int_mm_stack (one
torch._int_mm per plane, given B k-contiguous: the library's product).

    python -m gemmul8_tpu_torch.probes.matmul3 [nu m]

The flat views are the same memory as the batched (nu, m, k) and (nu, k, n)
ones, so each function hands the kernel those: the K-loop schedule for the
K-loop cells and the A-stationary one for the full-K cells, whose A block
stays put across the column sweep. The kernel stages 128 bytes of K a step
whatever the tool's depth, so mm_flat_kloop_multidot makes mm_flat_kloop's
launch. B is the tool's n-contiguous flat view, so the rows include the
transposing pass.
"""
from __future__ import annotations

import sys

import torch

from .. import core, kernels
from .fused import random_planes, report
from .timing import k_contiguous, require_cuda


def _flat(a2, b2, nu, m, k, n, schedule):
    c = kernels.matmul_i8(a2.view(nu, m, k), b2.view(nu, k, n), schedule)
    return c.view(nu * m, n)


def mm_flat_kloop(a2, b2, *, nu, m, k, n):
    """A: (nu*m, k), B: (nu*k, n) -> C: (nu*m, n); K innermost."""
    return _flat(a2, b2, nu, m, k, n, "kloop")


def mm_flat_fullk(a2, b2, *, nu, m, k, n):
    """Full-K cells: each block's rows of A across every column block."""
    return _flat(a2, b2, nu, m, k, n, "astat")


def mm_flat_kloop_multidot(a2, b2, *, nu, m, k, n):
    """The tool's K loop with nd dots a step (tools/probe_matmul3.py:90):
    the kernel already stages 128 bytes of K a step, so this makes
    mm_flat_kloop's launch."""
    return _flat(a2, b2, nu, m, k, n, "kloop")


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
    for name, fn in (("flat-kloop", mm_flat_kloop),
                     ("flat-fullk", mm_flat_fullk),
                     ("flat-multidot", mm_flat_kloop_multidot)):
        report(rows, name, lambda fn=fn: fn(a2, b2, **dims), 256, ref, ops,
               reps, shape=(nu, m, n))
    if not all(r["ok"] for r in rows):
        raise AssertionError("probes.matmul3: a product differs from "
                             "torch._int_mm")
    return rows


if __name__ == "__main__":
    main(*(int(v) for v in sys.argv[1:3]))
