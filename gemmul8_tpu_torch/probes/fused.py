"""Counterpart of tools/probe_fused.py on the card: the batched exact int8
product (nu, m, k) x (nu, k, n) -> (nu, m, n) int32, K-sequential
(pallas_matmul_i8_seq) and A-stationary (pallas_matmul_i8_astat), through
the hand-written wgmma + TMA kernel (csrc/matmul_i8_wgmma.cu, which
core.residue_matmul takes on the main path), beside core.int_mm_stack, one
torch._int_mm per plane (the library's product: the counterpart of "XLA
batched dot").

    python -m gemmul8_tpu_torch.probes.fused

Runs the tool's two sweeps (main, main2) in one table, on the tool's
n-contiguous B (the wgmma rows include the transposing pass) and on the main
path's k-contiguous B: the kernel's K-loop (grouped raster) and
A-stationary schedules. `ok` holds rows 0-255
against torch._int_mm. torch._int_mm's row takes B k-contiguous: the fair
comparison is with the k-contiguous rows.

product_rows times the same kernels in turns on given planes with B
k-contiguous (chip_smoke.py: the DGEMM 8192^3 nu=16 path's own planes);
sustained_rows times them in turns over whole seconds with the card's SM
clock and power draw sampled beside them, so that a burst's time can be
held against what the card keeps up under its power limit.
"""
from __future__ import annotations

import statistics
import time

import torch

from .. import core, kernels
from .power import NvidiaSmiSampler, Poller
from .timing import cuda_ms, in_turns, k_contiguous, launches, require_cuda


def matmul_i8_seq(a, b):
    """(nu, m, k) i8 x (nu, k, n) i8 -> (nu, m, n) i32; K innermost."""
    return kernels.matmul_i8(a, b, "kloop")


def matmul_i8_astat(a, b):
    """A-stationary: each block keeps its rows of A across the column sweep."""
    return kernels.matmul_i8(a, b, "astat")


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


def product_fns(a, b):
    """The product kernel's two rasters on (nu, m, k) A and k-contiguous B,
    beside torch._int_mm x nu."""
    fns = {"torch._int_mm x nu": lambda: core.int_mm_stack(a, b)}
    for schedule in ("kloop", "astat"):
        fns[f"wgmma {schedule}"] = (
            lambda s=schedule: kernels.matmul_i8(a, b, s))
    return fns


def product_rows(a, b, reps=5, check_rows=256):
    """In-turn times (timing.in_turns) of product_fns(a, b), each held on
    rows 0..check_rows of every plane against torch._int_mm first; returns
    the rows (name, ms, pass1_ms, pass2_ms, tops, ok)."""
    if not kernels.tma_addressable(a, b):
        raise ValueError("product_rows: the planes are not TMA-addressable")
    nu, m, k = a.shape
    ops = 2.0 * nu * m * b.shape[2] * k
    ref = core.int_mm_stack(a[:, :check_rows].contiguous(), b)
    fns = product_fns(a, b)
    ok = {}
    for name, fn in fns.items():
        ok[name] = bool(torch.equal(fn()[:, :check_rows], ref))
        torch.cuda.empty_cache()
    rows = []
    for name, (ms, ms1, ms2) in in_turns(fns, reps).items():
        rows.append(dict(name=name, ms=ms, pass1_ms=ms1, pass2_ms=ms2,
                         tops=ops / (ms * 1e-3) / 1e12, ok=ok[name]))
        print(f"product {name}: {ms:9.3f} ms ({ms1:.3f}, {ms2:.3f})  "
              f"{rows[-1]['tops']:7.1f} TOPS  ok={ok[name]}", flush=True)
    return rows


def sustained_rows(fns: dict, seconds: float = 10.0, turns: int = 2,
                   index: int | None = None):
    """Each fn() called back to back for `seconds` in all, in `turns` turns
    of the dict's order and its reverse in alternation, each call timed by
    CUDA events and waited for; the SM clock and power draw of card `index`
    (by default the current one) sampled beside by one streaming nvidia-smi
    every 100 ms (power.NvidiaSmiSampler). Returns {name: dict(ms,
    first_ms, last_ms, calls, seconds, sm_mhz, watts)}: the median ms a
    call over all its turns and over its first and last turn, and the mean
    clock and draw of the samples read while it ran."""
    out = {name: dict(times=[], spans=[]) for name in fns}
    if index is None:
        index = torch.cuda.current_device()
    smi = Poller(NvidiaSmiSampler(index, 0.1, ("clocks.sm", "power.draw")),
                 0.1).start()
    try:
        for turn in range(turns):
            order = list(fns) if turn % 2 == 0 else list(reversed(fns))
            for name in order:
                fns[name]()
                torch.cuda.synchronize()
                t0, times = time.time(), []
                while time.time() - t0 < seconds / turns:
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    fns[name]()
                    e.record()
                    e.synchronize()
                    times.append(s.elapsed_time(e))
                out[name]["times"].append(times)
                out[name]["spans"].append((t0, time.time()))
                torch.cuda.empty_cache()
    finally:
        samples = smi.stop()
    rows = {}
    for name, r in out.items():
        inside = [(t, *v) for t, v in samples
                  if isinstance(v, tuple) and all(x == x for x in v)
                  and any(t0 <= t <= t1 for t0, t1 in r["spans"])]
        flat = [t for ts in r["times"] for t in ts]
        rows[name] = dict(
            ms=statistics.median(flat),
            first_ms=statistics.median(r["times"][0]),
            last_ms=statistics.median(r["times"][-1]), calls=len(flat),
            seconds=sum(t1 - t0 for t0, t1 in r["spans"]),
            sm_mhz=(statistics.mean(x[1] for x in inside) if inside
                    else float("nan")),
            watts=(statistics.mean(x[2] for x in inside) if inside
                   else float("nan")))
        print(f"sustained {name}: {rows[name]['ms']:9.3f} ms a call "
              f"(first turn {rows[name]['first_ms']:.3f}, last "
              f"{rows[name]['last_ms']:.3f}), {rows[name]['calls']} calls in "
              f"{rows[name]['seconds']:.1f} s, SM {rows[name]['sm_mhz']:.0f} "
              f"MHz, {rows[name]['watts']:.1f} W", flush=True)
    return rows


def main(nu=16, m=4096, seed=0, reps=5):
    """Both sweeps at nu planes of m x m x m; returns the rows (name, ms,
    tops, ok, launches)."""
    require_cuda("probes.fused")
    print("device:", torch.cuda.get_device_name(0), flush=True)
    a, b = random_planes(nu, m, m, m, seed)
    b_kc = k_contiguous(b)
    ref = core.int_mm_stack(a[:, :256].contiguous(), b_kc)
    ops = 2.0 * nu * m ** 3
    rows = []
    report(rows, "torch._int_mm x nu", lambda: core.int_mm_stack(a, b_kc),
           256, ref, ops, reps)
    for layout, bb in (("B n-contiguous", b), ("B k-contiguous", b_kc)):
        report(rows, f"seq {layout}", lambda bb=bb: matmul_i8_seq(a, bb),
               256, ref, ops, reps)
        report(rows, f"astat {layout}", lambda bb=bb: matmul_i8_astat(a, bb),
               256, ref, ops, reps)
    if not all(r["ok"] for r in rows):
        raise AssertionError("probes.fused: a product differs from "
                             "torch._int_mm")
    return rows


if __name__ == "__main__":
    main()
