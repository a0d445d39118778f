"""The program's own spans in a traced run: the gemmul8.* user annotations
that gemmul8_tpu_torch opens around each stage of a call while a profiler
runs (gemmul8_tpu_torch/spans.py), read from the trace of the traced calls
with the host's operators (run.traced_calls, its second pass:
_out/<cell>.stacks.json).

span_summary gives each device operation the layer of the innermost
gemmul8.* span open on the caller's thread at its launch (tied by the
trace's correlation id), the host's seconds inside each layer's spans, and
inside gemmul8.entry the device operations launched and the runtime calls
that block the host on the device. The per-layer metrics read it through
the functions at the end, one per kind of reading; each returns None where
the trace holds nothing for it: no gemmul8.* span (a program without them),
or no device operation (a run on the CPU, whose host computes each stage
itself rather than queueing it).

That pass records Python stacks as well, which slow the host: its host
times are those of a traced host, wider than an untraced call's.
"""
from __future__ import annotations

import bisect
import json
import os
from dataclasses import dataclass, field

from h100bench import trace

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "_out")          # run.OUT
CALL_SPAN = "h100bench.call"              # run.CALL_SPAN
PREFIX = "gemmul8."
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


@dataclass
class SpanSummary:
    calls: int
    has_spans: bool
    on_device: bool = False     # the trace holds device operations
    device_s: dict = field(default_factory=dict)   # layer -> device s
    host_s: dict = field(default_factory=dict)     # layer -> host s
    entry_ops: int | None = None    # device operations launched in entry
    entry_syncs: int | None = None  # blocking runtime calls in entry
    idle_gaps: list = field(default_factory=list)  # [span or harness, s]


def blocking(name: str) -> bool:
    """Whether a runtime call of this name holds the host until the device
    has drained: a synchronise, or a synchronous (not Async) cudaMemcpy*."""
    return name in SYNCS or (name.startswith("cudaMemcpy")
                             and "Async" not in name)


def shifted_ops(events: list, launches: dict, w0: float, w1: float) -> list:
    """(start, end, event) of each device operation inside [w0, w1], µs.
    The device's clock as the trace maps it may run ahead of the host's: no
    operation starts before its launch, so all are shifted by the most that
    any one does (as trace.summarize shifts them)."""
    device = [e for e in events if e.get("cat") in trace.DEVICE_CATS]
    lead = [e["ts"] - launches[c]["ts"] for e in device
            if (c := e.get("args", {}).get("correlation")) in launches]
    skew = min(0.0, min(lead, default=0.0))
    ops = []
    for e in device:
        s = max(e["ts"] - skew, w0)
        t = min(e["ts"] - skew + e["dur"], w1)
        if t > s:
            ops.append((s, t, e))
    return ops


def _within(times: list, intervals: list) -> list:
    """For each of `times`, whether it lies in one of the merged,
    ascending `intervals`."""
    starts = [s for s, _ in intervals]
    out = []
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        out.append(i >= 0 and t <= intervals[i][1])
    return out


def _layer(spans: list) -> str:
    return spans[-1]["name"][len(PREFIX):] if spans else "harness"


def _intervals(events: list) -> list:
    return trace._union([(e["ts"], e["ts"] + e["dur"]) for e in events])


def span_summary(tr: dict, call_span: str = CALL_SPAN, top: int = 10
                 ) -> SpanSummary:
    """The traced calls (each in a `call_span`) read by the program's spans
    on the caller's thread: each layer's device and host seconds, the
    device operations and blocking runtime calls inside gemmul8.entry, and
    the idle gaps inside the calls by the span the host was in."""
    events = [e for e in tr["traceEvents"] if e.get("ph") == "X"
              and "dur" in e]
    calls = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == call_span]
    if not calls:
        raise ValueError(f"the trace holds no {call_span!r} span")
    tid = calls[0]["tid"]
    w0 = min(e["ts"] for e in calls)
    w1 = max(e["ts"] + e["dur"] for e in calls)
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["tid"] == tid and e["name"].startswith(PREFIX)]
    entry = _intervals([e for e in spans if e["name"] == PREFIX + "entry"])
    out = SpanSummary(calls=len(calls), has_spans=bool(entry))
    if not entry:
        return out
    for name in {e["name"] for e in spans}:
        out.host_s[name[len(PREFIX):]] = 1e-6 * sum(
            t - s for s, t in _intervals([e for e in spans
                                          if e["name"] == name]))

    runtime = [e for e in events if e.get("cat") in trace.LAUNCH_CATS]
    launches = {e["args"]["correlation"]: e for e in runtime
                if "correlation" in e.get("args", {})}
    ops = shifted_ops(events, launches, w0, w1)
    out.on_device = any(e.get("cat") in trace.DEVICE_CATS for e in events)

    # each operation's layer, by the spans open at its launch
    layer = ["unattributed"] * len(ops)
    queries = []
    for i, (_, _, e) in enumerate(ops):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            layer[i] = "harness"
            if launch["tid"] == tid:
                queries.append((launch["ts"], i))
    queries.sort()
    times = [t for t, _ in queries]
    for (_, i), open_ in zip(queries, trace.open_at(spans, times)):
        layer[i] = _layer(open_)
    for (s, t, _), name in zip(ops, layer):
        out.device_s[name] = out.device_s.get(name, 0.0) + (t - s) * 1e-6
    if out.on_device:
        # every operation counts, as long or short as the trace records it
        out.entry_ops = sum(_within(sorted(
            launches[c]["ts"] for e in events
            if e.get("cat") in trace.DEVICE_CATS
            and (c := e.get("args", {}).get("correlation")) in launches
            and launches[c]["tid"] == tid), entry))
        out.entry_syncs = sum(_within(sorted(
            e["ts"] for e in runtime
            if e["tid"] == tid and blocking(e["name"])), entry))

    # idle gaps inside the call spans, by the span open on the host
    busy = trace._union([(s, t) for s, t, _ in ops])
    gaps = []
    for c0, c1 in _intervals(calls):
        edges = [c0] + [min(max(x, c0), c1) for iv in busy for x in iv] + [c1]
        gaps += [(s, t) for s, t in zip(edges[::2], edges[1::2]) if t > s]
    gap_s: dict = {}
    for (s, t), open_ in zip(gaps, trace.open_at(
            spans, [(s + t) / 2 for s, t in gaps])):
        label = _layer(open_)
        gap_s[label] = gap_s.get(label, 0.0) + (t - s) * 1e-6
    out.idle_gaps = [[k, v] for k, v in sorted(gap_s.items(),
                                               key=lambda kv: -kv[1])][:top]
    return out


def _traces_newest_first() -> list:
    if not os.path.isdir(OUT):
        return []
    paths = [os.path.join(OUT, f) for f in os.listdir(OUT)
             if f.endswith(".stacks.json")]
    return sorted(paths, key=os.path.getmtime, reverse=True)


def of(ctx) -> SpanSummary | None:
    """The span summary of the run's traced calls, kept on the context: of
    the newest trace in _out/ whose stack summary is the context's (so
    another run's trace is never read), or None if none is."""
    if not hasattr(ctx, "spans"):
        ctx.spans = None
        with open(os.path.join(HERE, "layers.json")) as f:
            layers = json.load(f)
        for path in _traces_newest_first():
            with open(path) as f:
                tr = json.load(f)
            try:
                same = trace.summarize(tr, layers, CALL_SPAN).layer_s == \
                    ctx.summary.layer_s
            except ValueError:      # no call span: not a traced run's
                continue
            if same:
                ctx.spans = span_summary(tr)
                break
    return ctx.spans


def _reading(ctx):
    """The span summary, where it has program spans and device operations
    to read: on the CPU the host computes each stage itself, so its time
    there is no enqueue time of a device's work."""
    s = of(ctx)
    return s if s is not None and s.has_spans and s.on_device else None


def entry_syncs(ctx):
    """Blocking runtime calls a call inside gemmul8.entry."""
    s = _reading(ctx)
    return s.entry_syncs / s.calls if s else None


def entry_ops(ctx):
    """Device operations a call launched inside gemmul8.entry."""
    s = _reading(ctx)
    return s.entry_ops / s.calls if s else None


def host_ms(ctx, layer):
    """The host's ms a call inside `layer`'s spans."""
    s = _reading(ctx)
    t = s.host_s.get(layer) if s else None
    return 1e3 * t / s.calls if t else None


def device_ms(ctx, layer):
    """Device ms a call of the operations launched in `layer`'s spans."""
    s = _reading(ctx)
    t = s.device_s.get(layer) if s else None
    return 1e3 * t / s.calls if t else None
