"""Factorization throughput on the card: getrf / potrf / geqrf TFLOP/s on
the emulated engine beside the native cuSOLVER f64 routines -- the
counterpart of benchmarks/solver_flops.py.

The O(n^3) bulk of each factorization runs through the emulated GEMM, so
its throughput tracks the emulated GEMM's against the native f64 path (the
HPL-MxP story). The operands are made on the card from a seed, as the JAX
harness makes them: A = N(0, 1) + n I (well conditioned) and the SPD
A A^T / n + n I. Each row is the median of `iters` CUDA-event timings after
a warm-up call, with the flop counts of the JAX harness (getrf 2/3 n^3,
potrf 1/3 n^3, geqrf 4/3 n^3), printed with the card's name and power
limit.

    python -m gemmul8_tpu_torch.probes.solver_flops [--ops getrf,potrf,geqrf]
        [--sizes 4096] [--nu 14] [--block N] [--iters 3] [--no-native]
"""
from __future__ import annotations

import argparse
import statistics

import torch

from .fp8_calls import card
from .timing import cuda_times, require_cuda

OPS = ("getrf", "potrf", "geqrf")


def flops_of(op: str, n: int) -> float:
    return {"getrf": 2 / 3 * n**3, "potrf": 1 / 3 * n**3,
            "geqrf": 4 / 3 * n**3}[op]


def default_block(n: int) -> int:
    """The JAX harness's block: min(1024, max(256, n // 8))."""
    return min(1024, max(256, n // 8))


def operands(n: int, seed: int = 0):
    """(A, SPD) on the card: A = N(0, 1) + n I, SPD = A A^T / n + n I."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    a = torch.randn((n, n), dtype=torch.float64, device="cuda",
                    generator=g) + n * eye
    return a, a @ a.T / n + n * eye


def emulated(op: str, a, spd, nu: int, block: int):
    """The emulated factorization `op` as a callable."""
    import gemmul8_tpu_torch as gt
    return {"getrf": lambda: gt.getrf(a, num_moduli=nu, block=block),
            "potrf": lambda: gt.potrf(spd, num_moduli=nu, block=block),
            "geqrf": lambda: gt.geqrf(a, num_moduli=nu, block=block)}[op]


def native(op: str, a, spd):
    """The native cuSOLVER f64 factorization `op` as a callable."""
    return {"getrf": lambda: torch.linalg.lu_factor_ex(a),
            "potrf": lambda: torch.linalg.cholesky_ex(spd),
            "geqrf": lambda: torch.geqrf(a)}[op]


def time_ms(fn, iters: int) -> float:
    """Median of `iters` CUDA-event timings of fn() in ms, after a warm-up
    call."""
    return statistics.median(cuda_times(fn, reps=iters, warmup=1))


def rows(ops=OPS, sizes=(4096,), nu: int = 14, block=None, iters: int = 3,
         with_native: bool = True) -> list:
    """One row per (op, n): ms and TFLOP/s emulated, and native beside."""
    out = []
    for n in sizes:
        blk = block or default_block(n)
        a, spd = operands(n)
        for op in ops:
            ms = time_ms(emulated(op, a, spd, nu, blk), iters)
            row = dict(op=op, n=n, num_moduli=nu, block=blk, ms=ms,
                       tflops=flops_of(op, n) / ms / 1e9)
            if with_native:
                row["native_ms"] = time_ms(native(op, a, spd), iters)
                row["native_tflops"] = flops_of(op, n) / row[
                    "native_ms"] / 1e9
                row["speedup"] = row["native_ms"] / ms
            out.append(row)
        del a, spd
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", default=",".join(OPS))
    ap.add_argument("--sizes", default="4096")
    ap.add_argument("--nu", type=int, default=14)
    ap.add_argument("--block", type=int, default=None)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--no-native", action="store_true",
                    help="skip the native-f64 comparison rows")
    args = ap.parse_args(argv)
    require_cuda("probes.solver_flops")
    torch.backends.cuda.preferred_linalg_library("cusolver")
    print(card())
    out = rows(args.ops.split(","), [int(s) for s in args.sizes.split(",")],
               args.nu, args.block, args.iters, not args.no_native)
    for r in out:
        line = (f"{r['op']} n={r['n']} nu={r['num_moduli']} "
                f"block={r['block']}: {r['ms']:.3f} ms = {r['tflops']:.3f} "
                f"TFLOP/s")
        if "native_ms" in r:
            line += (f"; native {r['native_ms']:.3f} ms = "
                     f"{r['native_tflops']:.3f} TFLOP/s, speedup "
                     f"{r['speedup']:.3f}")
        print(line)
    return out


if __name__ == "__main__":
    main()
