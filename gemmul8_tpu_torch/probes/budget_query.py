"""The cost of the memory-budget query that every real `gemm` on the card
makes before its first launch (core.device_budget_bytes, read by
pick_blocking): its host time, the host time of the free-memory rule it
replaced (torch.cuda.mem_get_info plus the allocator's reserved-but-
unallocated bytes), and whole DGEMM 8192^3 nu=16 calls under each rule and
under a constant budget; with the interposer's variants also `a @ b` under
gt.emulate and core.emulate_matmul called directly (the function the
interposer calls, with no budget query). Two schedules: rotated (one call of
each variant a round, the order rotated every round, so that no variant
keeps a fixed place after another) and blocks (probes.timing.in_turns:
five calls of one variant after another, the variants in order and then
reversed, as chip_smoke.py times the interposer). Each call is timed with
CUDA events. Operands are (U - 0.5) * exp(0.5 N), made on the card from a
seed. Printed with the card's name and power limit.

    python -m gemmul8_tpu_torch.probes.budget_query [--rounds 40]
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from .. import core
from .fp8_calls import card
from .timing import in_turns, require_cuda

SIZE = 8192
NU = 16


def free_rule(device) -> int:
    """The budget rule device_budget_bytes replaced: three quarters of
    mem_get_info's free bytes plus the allocator's reserved-but-unallocated
    ones."""
    free, _ = torch.cuda.mem_get_info(device)
    st = torch.cuda.memory_stats_as_nested_dict(device)
    return (free + st["reserved_bytes"]["all"]["current"]
            - st["allocated_bytes"]["all"]["current"]) * 3 // 4


def host_us(fn, reps: int = 200) -> float:
    """Mean host time of fn() in microseconds, after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def rotated(fns: dict, rounds: int) -> dict:
    """One CUDA-event timing of each fn() per round, in the dict's order
    rotated by one place each round, after one warm-up call of each;
    returns {name: (median, first quartile, third quartile)} in ms."""
    names = list(fns)
    for name in names:
        fns[name]()
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fns[name]()
            e.record()
            e.synchronize()
            times[name].append(s.elapsed_time(e))
    out = {}
    for name, t in times.items():
        q = statistics.quantiles(t, n=4)
        out[name] = (statistics.median(t), q[0], q[2])
    return out


def compare(a: torch.Tensor, b: torch.Tensor, num_moduli: int,
            rounds: int, hook: bool = False, blocks: bool = False) -> dict:
    """Host times of the two rules ("query_us", "free_rule_us") and whole
    gt.gemm(a, b) calls with the budget from the shipped query ("query"),
    from the free-memory rule ("free_rule") and a constant ("constant": the
    shipped query's value, read once); with hook=True, also `a @ b` under
    gt.emulate ("hook") and core.emulate_matmul ("emulate_matmul"). Timed
    rotated() over `rounds` rounds, each (median, q1, q3) in ms; with
    blocks=True, by in_turns(reps=5) instead, each (median, pass-1 median,
    pass-2 median)."""
    import gemmul8_tpu_torch as gt
    query = core.device_budget_bytes
    budget = query(a.device)

    def with_rule(rule):
        def call():
            core.device_budget_bytes = rule
            try:
                return gt.gemm(a, b, num_moduli=num_moduli)
            finally:
                core.device_budget_bytes = query
        return call

    def hooked():
        with gt.emulate(num_moduli=num_moduli):
            return a @ b

    fns = {"query": with_rule(query),
           "constant": with_rule(lambda device: budget),
           "free_rule": with_rule(free_rule)}
    if hook:
        fns["hook"] = hooked
        fns["emulate_matmul"] = lambda: core.emulate_matmul(
            a, b, num_moduli=num_moduli)
    res = {"query_us": host_us(lambda: query(a.device)),
           "free_rule_us": host_us(lambda: free_rule(a.device))}
    res.update(in_turns(fns, reps=5) if blocks else rotated(fns, rounds))
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    require_cuda("budget_query")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def phi():
        u = torch.rand((SIZE, SIZE), generator=gen, dtype=torch.float64,
                       device="cuda")
        z = torch.randn((SIZE, SIZE), generator=gen, dtype=torch.float64,
                        device="cuda")
        return (u - 0.5) * torch.exp(0.5 * z)
    a, b = phi(), phi()
    print(card())
    for blocks in (False, True):
        res = compare(a, b, NU, args.rounds, hook=True, blocks=blocks)
        print(f"budget query: device_budget_bytes {res['query_us']:.1f} us, "
              f"free-memory rule {res['free_rule_us']:.1f} us (host, mean "
              f"of 200)")
        how = ("blocks of 5, median, pass-1 and pass-2 medians" if blocks
               else f"{args.rounds} rotated rounds, median, q1, q3")
        for name in ("query", "constant", "free_rule", "hook",
                     "emulate_matmul"):
            print(f"gemm f64 {SIZE}^3 nu={NU} {name} ({how}): "
                  + ", ".join(f"{v:.3f}" for v in res[name]) + " ms")


if __name__ == "__main__":
    main()
