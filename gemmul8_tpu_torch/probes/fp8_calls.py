"""The FP8 paths on the card, whole calls and their epilogue (K3): FP8 DGEMM
8192^3 nu=14 and FP8 SGEMM 8192^3 nu=7 (chip_smoke.py's FP8_PATHS), on
(U - 0.5) * exp(0.5 N) operands made on the card from a seed.

Per path: K3 alone on the path's own lane products (median of 10 CUDA-event
timings after a warm-up), the whole `gemm` call (10 timings: median and
quartiles), and a checksum of the call's output bits, so that two versions
of the package that must agree bit for bit can be seen to. Printed with the
card's name and power limit; with --out, also written as JSON.

    python -m gemmul8_tpu_torch.probes.fp8_calls [--out FILE]

Run from two checkouts in turns (A, B, B, A) it compares two versions of the
package on one card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from .. import fp8, kernels, quantize
from .timing import cuda_ms, cuda_times, require_cuda

PATHS = ((torch.float64, 14), (torch.float32, 7))
SIZE = 8192


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else f"{torch.cuda.get_device_name(0)}, power limit not read")


def operand(g: torch.Generator, size: int) -> torch.Tensor:
    """(U - 0.5) * exp(0.5 N), f64, on the card."""
    u = torch.rand((size, size), dtype=torch.float64, device="cuda",
                   generator=g)
    z = torch.randn((size, size), dtype=torch.float64, device="cuda",
                    generator=g)
    return (u - 0.5) * torch.exp(0.5 * z)


def checksum(x: torch.Tensor) -> int:
    """The sum of x's bits as int64 words, modulo 2^64."""
    return int(x.contiguous().view(torch.int64 if x.element_size() == 8
                                   else torch.int32).to(torch.int64).sum())


def main(seed: int = 0, size: int = SIZE) -> dict:
    """Each path's K3 and whole-call times and its output checksum."""
    import gemmul8_tpu_torch as gt
    require_cuda("probes.fp8_calls")
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    print(name, flush=True)
    kernels.build()
    g = torch.Generator(device="cuda").manual_seed(seed)
    a64, b64 = operand(g, size), operand(g, size)
    rows = {}
    for dt, nu in PATHS:
        a, b = a64.to(dt), b64.to(dt)
        sa = quantize.shift_fast(a, nu, "FP8", 1)
        sb = quantize.shift_fast(b, nu, "FP8", 0)
        c3 = fp8.residue_matmul_fp8(kernels.encode_planes_fp8(a, sa, 0, nu),
                                    kernels.encode_planes_fp8(b, sb, 1, nu))
        k3_ms = cuda_ms(lambda: kernels.fused_epilogue_fp8(c3, sa, sb, nu, dt),
                        reps=10)
        del c3
        torch.cuda.empty_cache()
        runs = cuda_times(lambda: gt.gemm(a, b, num_moduli=nu, backend="FP8"),
                          reps=10)
        q1, q2, q3 = statistics.quantiles(runs, n=4)
        out = gt.gemm(a, b, num_moduli=nu, backend="FP8")
        key = f"FP8 {'f64' if dt == torch.float64 else 'f32'} nu={nu}"
        rows[key] = dict(k3_ms=k3_ms, gemm_ms=q2, gemm_ms_q1=q1, gemm_ms_q3=q3,
                         checksum=checksum(out))
        print(f"{name} | {key} {size}^3: K3 {k3_ms:.4f} ms, gemm {q2:.4f} ms "
              f"(q1 {q1:.4f}, q3 {q3:.4f}), checksum {rows[key]['checksum']}",
              flush=True)
        del a, b, out
        torch.cuda.empty_cache()
    return dict(card=name, rows=rows)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the rows as JSON to this file")
    args = ap.parse_args()
    result = main()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
