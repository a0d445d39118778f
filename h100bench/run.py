"""One run of one cell of BENCHMARK.json on one H100.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (configs/<name>.json: the library's dtype,
backend, num_moduli and mode, its entry and its plain reference) and a
traffic mix (traffic/<mix>.json). The run makes the mix's operand sets on the
card from the seed, warms up every shape it will call, then drives the
configuration's entry in a closed loop for --seconds: one caller, each
call's result synchronised before the next call, the operand sets in turn.
It prints the cell's end-to-end metrics (--trace 0) or, from a profiler
trace of a few more calls, its per-layer metrics (--trace 1; each a reader
in metrics/<name>.py) as the last line of standard output.

`correct` judges the outputs of the timed calls: the first warm-up output of
each operand set is kept on the host and compared with the plain reference
once the window has closed, and every timed call's output must carry the
same bits as the kept output of its set (the library's reproducibility
promise), checked by a position-weighted 64-bit checksum of its bits taken
after the call's timing.
Each number compared is printed beside its limit (limits/<cell>.json), as
the last lines of standard error and under "checks", the result's last key.

Every cache of the run sits at a fixed path inside the checkout: the
program's kernel build (gemmul8_tpu_torch/_build/), and _cache/ here for
Triton, torch extensions and the CUDA driver's cache.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()     # as near the process's start as can be

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from h100bench import counts, power, trace, traffic  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
OUT = os.path.join(HERE, "_out")
CALL_SPAN = "h100bench.call"
# the JAX package and what would load it: the run must not hold them
FORBIDDEN = ("jax", "jaxlib", "flax", "gemmul8_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str, root: str = ROOT) -> dict:
    """Everything one cell's run reads, found by the names in
    BENCHMARK.json: the cell, its configuration and mix, its limits, and
    the metrics it reports."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    config_file = next(c["file"] for c in bench["configs"]
                       if c["name"] == cell["config"])
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in
                                  e2e_names else [])]
    here = os.path.join(root, "h100bench")
    return {"cell": cell,
            "config": load_json(os.path.join(root, config_file)),
            "traffic": load_json(os.path.join(here, "traffic",
                                              cell["traffic"] + ".json")),
            "limits": load_json(os.path.join(here, "limits", name + ".json")),
            "end_to_end": end_to_end, "per_layer": per_layer,
            "layers": load_json(os.path.join(here, "layers.json")),
            "root": root}


def entry_module(spec: dict):
    return load_module(os.path.join(spec["root"], "h100bench", "entries",
                                    spec["config"]["entry"] + ".py"),
                       "h100bench_entry_" + spec["config"]["entry"])


def reference_module(spec: dict):
    return load_module(os.path.join(spec["root"], "h100bench", "reference",
                                    spec["config"]["reference"] + ".py"),
                       "h100bench_reference_" + spec["config"]["reference"])


def metric_reader(spec: dict, name: str):
    """metrics/<name>.py, or, where there is none, the file of the name less
    its last dotted part: `x.short` is read as `x` is, on other cells."""
    stem = name
    while True:
        path = os.path.join(spec["root"], "h100bench", "metrics",
                            stem + ".py")
        if os.path.exists(path) or "." not in stem:
            break
        stem = stem.rsplit(".", 1)[0]
    return load_module(path, "h100bench_metric_" + stem.replace(".", "_"))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_WEIGHTS: dict = {}


def odd_weights(n: int, axis: int, device) -> torch.Tensor:
    """n fixed odd 64-bit weights for the rows (axis 0) or columns (axis 1),
    drawn once from a seed of their own: no two positions weigh alike or in
    step, and an odd weight loses no bit of what it weighs."""
    key = (n, axis, str(device))
    if key not in _WEIGHTS:
        g = torch.Generator().manual_seed(0x5EED + axis)
        w = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=g,
                          dtype=torch.int64)
        _WEIGHTS[key] = (2 * w + 1).to(device)
    return _WEIGHTS[key]


def checksum(out: torch.Tensor) -> torch.Tensor:
    """Two 64-bit sums of out's bits, on out's device (wrapping): of its
    rows' sums and of its columns' sums, each weighted by odd_weights (a
    complex element's real and imaginary parts are columns of their own).
    An output whose values moved, as a permuted, transposed or misplaced
    block, reads another checksum, as one with an altered value does."""
    x = torch.view_as_real(out) if out.is_complex() else out
    x = x.reshape(x.shape[0], -1)
    ints = x.view({8: torch.int64, 4: torch.int32}[x.element_size()])
    return torch.stack([
        (ints.sum(1 - axis, dtype=torch.int64)
         * odd_weights(ints.shape[axis], axis, out.device)).sum()
        for axis in (0, 1)])


class Loop:
    """The closed loop of one caller over the operand sets in turn: each
    call timed on the host from entering the entry to the end of its
    synchronise, then its checksum taken (outside the call's time)."""

    def __init__(self, call, sets, device):
        self.call, self.sets, self.device = call, sets, device
        self.i = 0
        self.call_ms, self.host_ms, self.sums = [], [], []

    def step(self) -> None:
        s = self.i % len(self.sets)
        t0 = time.perf_counter()
        out = self.call(self.sets[s])
        t1 = time.perf_counter()
        sync(self.device)
        t2 = time.perf_counter()
        self.call_ms.append((t2 - t0) * 1e3)
        self.host_ms.append((t1 - t0) * 1e3)
        self.sums.append((s, checksum(out)))
        del out
        sync(self.device)
        self.i += 1


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" \
        else 0


def run(spec: dict, seed: int, seconds: float, traced: bool, device,
        call=None, sampler=None):
    """One run of the cell: (result, checks). `call` replaces the program's
    entry (the control, or a test's fault), `sampler` the card's power
    source (a test's); by default the configuration's entry and nvidia-smi.
    """
    device = torch.device(device)
    config, mix = spec["config"], spec["traffic"]
    if call is None:
        call = entry_module(spec).make(config, mix, device)
    sets = traffic.operand_sets(mix, config["dtype"], seed, device)
    sync(device)
    poller = power.Poller(sampler or power.NvidiaSmiSampler(
        device.index or 0)).start()
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        # warm-up: every shape the window calls. The first output of each
        # set is kept on the host for the reference, its bits for the rest.
        warm, kept = Loop(call, sets, device), []
        for s, ops in enumerate(sets):
            out = call(ops)
            kept.append(out.to("cpu", copy=True))
            warm.sums.append((s, checksum(out)))
            del out
        warm.i = len(sets)
        for _ in range(mix["warmup_calls"] - len(sets)):
            warm.step()
        sync(device)
        poller.wait_past(time.time())   # a power sample before the window
        setup_s = time.perf_counter() - T_PROCESS

        loop = Loop(call, sets, device)
        wall0, t0 = time.time(), time.perf_counter()
        while True:
            loop.step()
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        peak = peak_bytes(device)
        poller.wait_past(wall0 + window_s)
    finally:
        samples = poller.stop()
    joules = power.energy(samples, wall0, wall0 + window_s)
    if not joules > 0:
        raise SystemExit("no reading of the card's power over the window")

    summary = None
    if traced:
        summary = traced_calls(call, sets, device, mix["trace_calls"], spec,
                               loop)
    del call
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks, failed = verify(spec, sets, kept, warm, loop)
    flops = counts.flops(config, mix)
    if traced:
        ctx = Context(spec, summary, loop, window_s)
        metrics = {m["name"]: metric_reader(spec, m["name"]).read(ctx)
                   for m in spec["per_layer"]}
    else:
        # an end-to-end metric's name up to its first dot names the
        # quantity; the rest, the class of cells it is held on
        quantity = {"tflops": loop.i * flops / window_s / 1e12,
                    "call_ms_p95": float(np.percentile(loop.call_ms, 95)),
                    "gflops_per_w": loop.i * flops / 1e9 / joules,
                    "peak_mem_gib": peak / 2 ** 30,
                    "setup_s": setup_s}
        metrics = {m["name"]: quantity[m["name"].split(".")[0]]
                   for m in spec["end_to_end"]}
    refuse_forbidden()
    units = {m["name"]: m["unit"]
             for m in spec["per_layer" if traced else "end_to_end"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": failed == 0 and all(
                  c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(loop.sums), "failed": failed,
              "metrics": {name: {"value": metrics[name], "unit": unit}
                          for name, unit in units.items()
                          if metrics.get(name) is not None},
              "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {name: {k: (v if v == v and abs(v) != float("inf")
                                   else None) for k, v in c.items()}
                        for name, c in checks.items()}
    return result, checks


class Context:
    """What a per-layer metric reads: the cell, the trace's summary of the
    traced calls, and the untraced window: its calls, seconds and each
    call's host time in the entry."""

    def __init__(self, spec, summary, loop, window_s):
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.summary = summary
        self.calls = summary.calls
        self.window_calls, self.window_s = loop.i, window_s
        self.host_ms = loop.host_ms


def traced_calls(call, sets, device, n, spec, loop):
    """2n more calls of the loop under torch.profiler, their bits joining
    the window's. The first n are traced on the device alone, which costs
    the host little: the device's busy time over their host-clock window.
    The next n are traced with the host's operators and Python stacks, each
    call in a CALL_SPAN: each device operation's layer, and the breakdown.
    """
    from torch.profiler import ProfilerActivity, profile, record_function
    on_card = device.type == "cuda"
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, spec["cell"]["name"])
    quiet = Loop(call, sets, device)
    quiet.i = loop.i
    with profile(activities=[ProfilerActivity.CUDA] if on_card
                 else [ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            quiet.step()
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(path + ".device.json")
    busy_s = trace.busy_seconds(load_json(path + ".device.json"))

    stacked = Loop(call, sets, device)
    stacked.i = quiet.i
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities, with_stack=True) as prof:
        for _ in range(n):
            with record_function(CALL_SPAN):
                stacked.step()
    prof.export_chrome_trace(path + ".stacks.json")
    loop.sums.extend(quiet.sums + stacked.sums)
    summary = trace.summarize(load_json(path + ".stacks.json"),
                              spec["layers"], CALL_SPAN)
    summary.busy_s, summary.window_s = busy_s, window_s
    return summary


def refuse_forbidden() -> None:
    """Exit, naming them, where the process holds JAX or the JAX package:
    called once the window, the reference and the metrics' readers are done,
    just before the result is made."""
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise SystemExit(f"the run holds {found}: the benchmark must not "
                         "load the JAX package or JAX")


def verify(spec, sets, kept, warm, loop):
    """(checks, failed timed calls): each set's kept output against the
    plain reference, and every later call's bits against its set's kept
    output. A timed call fails if its bits differ, or if its set's kept
    output, whose bits it carries, is beyond the limit."""
    config, mix, limit = spec["config"], spec["traffic"], spec["limits"]["gap"]
    reference = reference_module(spec)
    gaps = [reference.max_gap(out, ops, config, mix)
            for out, ops in zip(kept, sets)]
    want = [v.tolist() for _, v in warm.sums[:len(sets)]]
    later = warm.sums[len(sets):] + loop.sums
    values = torch.stack([v for _, v in later]).tolist()
    differ = [v != want[s] for (s, _), v in zip(later, values)]
    n_warm = len(warm.sums) - len(sets)
    failed = sum(d or not gaps[s] <= limit
                 for (s, _), d in zip(loop.sums, differ[n_warm:]))
    checks = {"gap": {"value": max(gaps), "limit": limit},
              "bits_differ": {"value": sum(differ), "limit": 0}}
    return checks, failed


def check_card(chips: int) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this benchmark runs on an H100")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} found")


def set_caches() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()
    spec = cell_spec(args.workload)
    check_card(spec["cell"]["chips"])
    result, checks = run(spec, args.seed, args.seconds, bool(args.trace),
                         "cuda")
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
