"""The rank-2k one-product win on the card: syr2k and her2k against the
naive two-GEMM forms at matched num_moduli, the counterpart of
tools/probe_blas3_perf.py.

syr2k computes C = A B^T + B A^T as G + G^T with ONE emulated product
(gemmul8_tpu_torch/blas3.py); the naive form runs gemm(a, b, trans_b=T)
plus gemm(b, a, trans_b=T). Expected: about 2x on the product phase, the
syr2k time near a single gemm's. her2k likewise on complex128 operands
against two ZGEMMs, which the card runs natively (the tool's guard for
runtimes without complex dtypes has no counterpart: a failure there is a
failure). All calls take fastmode="robust", so the comparison isolates
the one-product-versus-two structure.

Correctness first, as a check that raises: at 256 rows syr2k and the naive
form differ by exactly 0 (the naive second product reconstructs the same
exact residue integers under the same shifts, so g2 == g1^T bit for bit).
Then each call is timed in rotated turns (timing.in_turns: CUDA-event
medians on the card, perf_counter on the CPU), TF/s by the tool's
convention: 2 n^2 k per real product, 8 n^2 k per complex one.

    python -m gemmul8_tpu_torch.probes.blas3_perf [n] [k] [nu]
        [--reps 4] [--device cuda|cpu] [--out FILE]

(defaults 4096 4096 16). The operands are N(0, 1) in f32 widened to f64,
from numpy's default_rng(0), in the tool's order. The CSV (name, n, k,
num_moduli, ms, tflops; five rows) goes to gemmul8_tpu_torch/_results/
unless --out names a file.
"""
from __future__ import annotations

import argparse
import datetime
import sys

import numpy as np
import torch

from .accuracy import device_tag, result_path, write_csv
from .timing import in_turns

HEADER = ["name", "n", "k", "num_moduli", "ms", "tflops"]
CHECK_ROWS = 256


def measure(n: int = 4096, k: int = 4096, nu: int = 16, reps: int = 4,
            device="cuda", log=None) -> dict:
    """The check and the five timed rows: {"diff": syr2k - naive max abs
    difference at CHECK_ROWS rows (0.0, else this raises), "rows": [[name,
    n, k, nu, ms, tflops], ...]}."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import core
    log = log or sys.stdout
    device = core._device(device)
    rng = np.random.default_rng(0)

    def randn(*sh):
        return torch.from_numpy(rng.standard_normal(sh).astype(np.float32)
                                ).to(device=device, dtype=torch.float64)

    a = randn(n, k)
    b = randn(n, k)
    mode = dict(num_moduli=nu, fastmode="robust", device=device)

    def syr2k_fn(a, b):
        return gt.syr2k(a, b, **mode)

    def naive2(a, b, trans="T"):
        g1 = gt.gemm(a, b, trans_b=trans, **mode)
        g2 = gt.gemm(b, a, trans_b=trans, **mode)
        return g1 + g2

    def one_gemm(a, b):
        return gt.gemm(a, b, trans_b="T", **mode)

    d = float((syr2k_fn(a[:CHECK_ROWS], b[:CHECK_ROWS])
               - naive2(a[:CHECK_ROWS], b[:CHECK_ROWS])).abs().max())
    print(f"syr2k vs naive two-GEMM max abs diff ({CHECK_ROWS}^2): "
          f"{d:.3e}", file=log, flush=True)
    if d != 0.0:
        raise AssertionError(f"syr2k differs from the naive two-GEMM form "
                             f"by {d!r} at {CHECK_ROWS} rows")

    flops = 2.0 * n * n * k      # rank-2k convention: 2 n^2 k per product
    rows = []

    def timed(cases, x, y):
        fns = {name: (lambda fn=fn: fn(x, y)) for name, fn, _ in cases}
        times = in_turns(fns, reps, device)
        for name, _, nflops in cases:
            ms = times[name][0]
            rows.append([name, n, k, nu, ms, nflops / (ms * 1e-3) / 1e12])
            print(f"{name:18s} {ms:9.2f} ms  {rows[-1][5]:7.2f} TF/s",
                  file=log, flush=True)

    timed([("one gemm (A B^T)", one_gemm, flops),
           ("syr2k (G + G^T)", syr2k_fn, 2 * flops),
           ("naive 2-GEMM", naive2, 2 * flops)], a, b)
    del a, b
    az = torch.complex(randn(n, k), randn(n, k))
    bz = torch.complex(randn(n, k), randn(n, k))
    zflops = 8.0 * n * n * k
    timed([("her2k (G + G^H)", lambda x, y: gt.her2k(x, y, **mode),
            2 * zflops),
           ("naive 2-ZGEMM", lambda x, y: naive2(x, y, "C"), 2 * zflops)],
          az, bz)
    return dict(diff=d, rows=rows)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=4096)
    ap.add_argument("k", type=int, nargs="?", default=4096)
    ap.add_argument("nu", type=int, nargs="?", default=16)
    ap.add_argument("--reps", type=int, default=4,
                    help="timings per call in each of the two turns")
    ap.add_argument("--device", default="cuda",
                    help="'cpu' runs the port's CPU path")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from gemmul8_tpu_torch import core
    device = core._device(args.device)
    if device.type == "cuda":
        from .fp8_calls import card
        print(card())
    print(f"device: {device_tag(device)}  n={args.n} k={args.k} "
          f"nu={args.nu} reps={args.reps} x 2 turns", flush=True)
    res = measure(args.n, args.k, args.nu, args.reps, device)
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    out = args.out or result_path(
        f"blas3_perf_{device_tag(device)}_{stamp}.csv")
    write_csv(out, HEADER, res["rows"])
    print(f"wrote {out}")
    return dict(res, out=out)


if __name__ == "__main__":
    main()
