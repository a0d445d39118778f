"""What the per-layer metrics read from a run's context (run.Context), one
function a kind of reading; each metric's own file in metrics/ calls one of
these (BENCHMARK.json gives its layer, unit, source and the end-to-end
metric it moves). Each returns None where the run holds nothing for it to
read."""
from __future__ import annotations

import statistics

from h100bench import counts


def idle_pct(ctx):
    """The share of the untraced window in which no operation runs on the
    card: one less the device's busy time a call, from the trace of the
    device alone, times the window's calls, over the window's seconds. A
    trace slows the host, and so widens the traced window's own gaps; the
    device's time a call it does not change."""
    s = ctx.summary
    if s.busy_s <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.calls * ctx.window_calls
                    / ctx.window_s)


def host_ms(ctx):
    """The median over the untraced window's calls of the host's time in
    the entry, from entering it to its return before the synchronise: the
    enqueue cost, which sets the pace where it exceeds the device's time
    (and which holds any wait of the host for the device inside the
    entry)."""
    return statistics.median(ctx.host_ms) if ctx.host_ms else None


def device_ms(ctx, layer):
    """Device time a traced call spends in `layer`'s operations."""
    t = ctx.summary.layer_s.get(layer)
    return 1e3 * t / ctx.calls if t else None


def roofline_pct(ctx, stage):
    """A stage's share of its roofline: the least time counts.stages gives
    it from the cell's shapes, over its device time, per traced call."""
    t = ctx.summary.layer_s.get(stage)
    if not t:
        return None
    least = counts.stages(ctx.config, ctx.traffic)[stage][0]
    return 100.0 * least * ctx.calls / t
