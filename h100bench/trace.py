"""Reading torch.profiler chrome traces of the traced calls: the device's
busy time (busy_seconds, from a trace of the device alone), and from a trace
with the host's operators and Python stacks (summarize) the device
operations with the layer of each and the idle gaps with what the host was
doing in each.

A device operation (kernel, copy or fill) is tied to its launch on the host
by the trace's correlation id, and the launch to the Python frames open on
its thread at that moment (the profiler's with_stack events). The innermost
frame that layers.json maps gives the layer. The window of summarize runs
from the first call span to the end of the last (run.CALL_SPAN, on the
harness's thread); its gaps are wider than an untraced call's, since the
stacks slow the host.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
FRAME = re.compile(
    r"(?:^|/)(gemmul8_tpu_torch|h100bench)/([\w/]+)\.py\(\d+\): (\S+)")


@dataclass
class Summary:
    calls: int
    window_s: float
    busy_s: float
    layer_s: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)   # [name, seconds]
    idle_gaps: list = field(default_factory=list)    # [host activity, s]


def frame_key(name: str):
    """("gemmul8_tpu_torch" or "h100bench", "module.function") of a Python
    frame event's name, or None for any other frame."""
    mo = FRAME.search(name)
    if mo is None:
        return None
    pkg, path, func = mo.groups()
    return pkg, f"{path.replace('/', '.')}.{func}"


def open_at(spans: list, times: list) -> list:
    """For each of `times` (ascending, µs), the spans open at it, outermost
    first. `spans` are one thread's nested events."""
    spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
    def end(e):
        return e["ts"] + e["dur"]

    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i]["ts"] <= t:
            while stack and end(stack[-1]) <= spans[i]["ts"]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and end(stack[-1]) < t:
            stack.pop()
        out.append(list(stack))
    return out


def layer_of(frames: list, functions: dict) -> str:
    """The layer of the innermost mapped program frame among `frames`
    (outermost first); "unmapped" if program frames match none, "harness"
    if none is the program's."""
    seen = False
    for f in reversed(frames):
        key = frame_key(f["name"])
        if key and key[0] == "gemmul8_tpu_torch":
            seen = True
            if key[1] in functions:
                return functions[key[1]]
    return "unmapped" if seen else "harness"


def _union(intervals: list) -> list:
    merged = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def _host_activity(spans: list) -> str:
    """What the host was doing inside `spans` (outermost first): the
    innermost program or harness frame, and the innermost operator or
    runtime call within it."""
    label, op = "python", None
    for e in reversed(spans):
        if e.get("cat") == "python_function":
            key = frame_key(e["name"])
            if key:
                label = key[1] if key[0] == "gemmul8_tpu_torch" \
                    else f"harness:{key[1]}"
                break
        elif op is None:
            op = e["name"]
    return label if op is None else f"{label} > {op}"


def busy_seconds(trace: dict) -> float:
    """Seconds in which some device operation of the trace ran."""
    return sum(t - s for s, t in _union(
        [(e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
         if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS])) * 1e-6


def summarize(trace: dict, layers: dict, call_span: str, top: int = 10
              ) -> Summary:
    """The traced calls of a trace with host stacks: each layer's device
    seconds, the busy union and the window of the call spans, the `top`
    device operations by time and the idle gaps by what the host did."""
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    calls = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == call_span]
    if not calls:
        raise ValueError(f"the trace holds no {call_span!r} span")
    w0 = min(e["ts"] for e in calls)
    w1 = max(e["ts"] + e["dur"] for e in calls)
    host_tid = calls[0]["tid"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    frames_by_tid: dict = {}
    for e in events:
        if e.get("cat") == "python_function":
            frames_by_tid.setdefault(e["tid"], []).append(e)
    # the device's clock as the trace maps it may run ahead of the host's:
    # no operation starts before its launch, so shift them all by the most
    # that any one does
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    lead = [e["ts"] - launches[c]["ts"] for e in device
            if (c := e.get("args", {}).get("correlation")) in launches]
    skew = min(0.0, min(lead, default=0.0))
    ops = []
    for e in device:
        s = max(e["ts"] - skew, w0)
        t = min(e["ts"] - skew + e["dur"], w1)
        if t > s:
            ops.append((s, t, e))

    # each operation's layer, by its launch's frames
    layer = ["unattributed"] * len(ops)
    by_tid: dict = {}
    for i, (_, _, e) in enumerate(ops):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None and launch["tid"] in frames_by_tid:
            by_tid.setdefault(launch["tid"], []).append((launch["ts"], i))
    for tid, queries in by_tid.items():
        queries.sort()
        stacks = open_at(frames_by_tid[tid], [t for t, _ in queries])
        for (_, i), frames in zip(queries, stacks):
            layer[i] = layer_of(frames, layers["functions"])

    layer_s, op_s = {}, {}
    for (s, t, e), name in zip(ops, layer):
        layer_s[name] = layer_s.get(name, 0.0) + (t - s) * 1e-6
        kernel = e["name"].replace("(anonymous namespace)::", "")
        short = f"{name}: {kernel.split('(')[0][:100]}"
        op_s[short] = op_s.get(short, 0.0) + (t - s) * 1e-6
    busy = _union([(s, t) for s, t, _ in ops])

    # idle gaps inside the window, by what the host thread was doing
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(s, t) for s, t in zip(edges[::2], edges[1::2]) if t > s]
    host = [e for e in events if e["tid"] == host_tid and e.get("cat") in
            ("python_function", "cpu_op") + LAUNCH_CATS]
    mids = [(s + t) / 2 for s, t in gaps]
    gap_s = {}
    for (s, t), spans in zip(gaps, open_at(host, mids)):
        label = _host_activity(spans)
        gap_s[label] = gap_s.get(label, 0.0) + (t - s) * 1e-6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return Summary(calls=len(calls), window_s=(w1 - w0) * 1e-6,
                   busy_s=sum(t - s for s, t in busy) * 1e-6,
                   layer_s=layer_s, device_ops=ranked(op_s),
                   idle_gaps=ranked(gap_s))
