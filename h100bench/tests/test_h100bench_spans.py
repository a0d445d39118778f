"""The program's gemmul8.* spans as the benchmark reads them: span_summary
on a hand-made chrome trace, the readers of the span metrics, a traced run
on the CPU, and the stack summary left as it read before the spans."""
import dataclasses
import importlib
import json
import os

import pytest
from test_h100bench_trace import LAYERS, P, kernel, launch, one_call, py

from h100bench import run, spans, trace
from h100bench.trace import Summary


def ann(layer, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": "gemmul8." + layer,
            "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def runtime(name, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 1, "tid": tid, "pid": 1, "args": {}}


def spanned_call():
    """one_call() with the program's spans: gemm's and emulate_matmul's
    entry (1-80, 2-80), shifts 3-13 with a nested shifts span 4-9, encode
    14-18, products 19-24, epilogue 25-28; and runtime calls: a stream
    synchronise, a cudaMemcpyAsync and a synchronous cudaMemcpy inside the
    shifts, and a device synchronise by the harness (82) outside entry."""
    return one_call() + [
        ann("entry", 1, 79), ann("entry", 2, 78), ann("shifts", 3, 10),
        ann("shifts", 4, 5), ann("encode", 14, 4), ann("products", 19, 5),
        ann("epilogue", 25, 3),
        runtime("cudaStreamSynchronize", 6), runtime("cudaMemcpyAsync", 7),
        runtime("cudaMemcpy", 8), runtime("cudaDeviceSynchronize", 83)]


def test_innermost_span_wins_and_host_time_is_the_union():
    s = spans.span_summary({"traceEvents": spanned_call()})
    assert s.calls == 1 and s.has_spans
    assert s.device_s == pytest.approx({"shifts": 10e-6, "encode": 20e-6,
                                        "products": 30e-6,
                                        "epilogue": 10e-6, "harness": 5e-6})
    # the nested shifts span adds nothing to the union; entry is 1-80
    assert s.host_s == pytest.approx({"entry": 79e-6, "shifts": 10e-6,
                                      "encode": 4e-6, "products": 5e-6,
                                      "epilogue": 3e-6})
    assert s.entry_ops == 4
    # an operation the trace records with no length counts all the same
    events = spanned_call() + [launch(9, 21), kernel("fill", 9, 71, 0)]
    assert spans.span_summary({"traceEvents": events}).entry_ops == 5
    # idle 0-10 in the shifts, 80-90 and 95-100 in the harness
    assert dict(s.idle_gaps) == pytest.approx({"shifts": 10e-6,
                                               "harness": 15e-6})


def test_only_blocking_calls_inside_entry_count():
    s = spans.span_summary({"traceEvents": spanned_call()})
    # the stream synchronise and the synchronous copy; not the async copy,
    # nor the harness's device synchronise after the entry
    assert s.entry_syncs == 2
    assert [spans.blocking(n) for n in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
        "cudaMemcpyAsync", "cudaMemcpy2DAsync", "cudaLaunchKernel",
        "cudaStreamWaitEvent")] == [True] * 5 + [False] * 4
    other_thread = spanned_call() + [runtime("cudaStreamSynchronize", 7,
                                             tid=2)]
    assert spans.span_summary({"traceEvents": other_thread}).entry_syncs == 2


def test_device_clock_ahead_is_shifted_back():
    """The first kernel 8 µs before its place, the rest 3: every operation
    moves 3 µs later (as trace.summarize moves them), and none starts
    before its launch."""
    events = spanned_call()
    for e in events:
        if e["cat"] == "kernel":
            e["ts"] -= 3 if e["args"]["correlation"] != 1 else 8
    s = spans.span_summary({"traceEvents": events})
    assert s.device_s["shifts"] == pytest.approx(10e-6)
    assert s.device_s["products"] == pytest.approx(30e-6)
    launches = {e["args"]["correlation"]: e for e in events
                if e["cat"] == "cuda_runtime" and "correlation" in e["args"]}
    ops = spans.shifted_ops(events, launches, 0, 100)
    assert all(st >= launches[e["args"]["correlation"]]["ts"]
               for st, _, e in ops)
    # the first gap, 0-5, has its midpoint before the shifts span opens
    # at 3: the host was in emulate_matmul's entry span; the first kernel
    # now ends at 15, five before the second
    assert dict(s.idle_gaps) == pytest.approx({"entry": 5e-6,
                                               "encode": 5e-6,
                                               "harness": 15e-6})


def test_a_trace_without_program_spans_reads_nothing():
    """The program before its spans: the summary says so, and every reader
    returns None rather than raising."""
    s = spans.span_summary({"traceEvents": one_call()})
    assert not s.has_spans and s.entry_syncs is None and s.entry_ops is None
    ctx = type("Ctx", (), {"spans": s})()
    assert spans.entry_syncs(ctx) is None and spans.entry_ops(ctx) is None
    assert spans.host_ms(ctx, "shifts") is None
    assert spans.device_ms(ctx, "alpha_beta") is None
    with pytest.raises(ValueError):
        spans.span_summary({"traceEvents": spanned_call()[1:]})


def test_a_cpu_trace_has_no_device_reading():
    """Without device operations the host computes each stage itself:
    the spans' host times are summed, but no metric reads them."""
    events = [e for e in spanned_call() if e["cat"] not in
              ("kernel", "cuda_runtime")]
    s = spans.span_summary({"traceEvents": events})
    assert not s.on_device and s.entry_syncs is None and s.entry_ops is None
    assert s.host_s["shifts"] == pytest.approx(10e-6)
    ctx = type("Ctx", (), {"spans": s})()
    assert spans.host_ms(ctx, "shifts") is None


@pytest.mark.parametrize("name, value", [
    ("entry.syncs", 1.0), ("entry.device_ops", 2.0),
    ("quantize.shifts_host_ms", 5e-3), ("core.alpha_beta_ms", 0.25e-3)])
def test_readers_per_call(name, value):
    s = spans.SpanSummary(calls=4, has_spans=True, on_device=True,
                          entry_syncs=4,
                          entry_ops=8, host_s={"shifts": 20e-6},
                          device_s={"alpha_beta": 1e-6})
    ctx = type("Ctx", (), {"spans": s})()
    spec = run.cell_spec("dgemm-int8-nu16.upd8192k512")
    got = run.metric_reader(spec, name + ".short").read(ctx)
    assert got == pytest.approx(value)


def test_the_context_s_own_trace_is_read(tmp_path, monkeypatch):
    """Of the traces in _out/ the newest whose stack summary is the
    context's: not a newer one of another run."""
    monkeypatch.setattr(spans, "OUT", str(tmp_path))
    ours = {"traceEvents": spanned_call()}
    other = {"traceEvents": [e for e in spanned_call()
                             if e.get("args", {}).get("correlation") != 3]}
    for name, tr, mtime in (("a.stacks.json", ours, 1e9),
                            ("b.stacks.json", other, 2e9)):
        (tmp_path / name).write_text(json.dumps(tr))
        os.utime(tmp_path / name, (mtime, mtime))
    (tmp_path / "c.stacks.json").write_text(json.dumps(
        {"traceEvents": spanned_call()[1:]}))    # no call span
    summary = trace.summarize(ours, LAYERS, run.CALL_SPAN)
    ctx = type("Ctx", (), {"summary": summary})()
    assert spans.of(ctx).device_s["products"] == pytest.approx(30e-6)
    assert spans.of(ctx) is ctx.spans
    ctx = type("Ctx", (), {"summary": Summary(calls=1, window_s=1.0,
                                              busy_s=1.0)})()
    assert spans.of(ctx) is None and spans.entry_syncs(ctx) is None


def test_stack_summary_reads_as_before_the_spans():
    """The spans and the wrapper frames they add to a stack trace change
    nothing summarize reads."""
    events = one_call()
    frames = [e for e in events if e["cat"] == "python_function"
              and e["name"].split(": ")[-1] in (
                  "gemm", "emulate_matmul", "shift_fast", "encode_planes",
                  "residue_matmul", "fused_epilogue")]
    wrappers = [py(P + "spans.py(50): spanned", e["ts"] - 0.25,
                   e["dur"] + 0.5) for e in frames]
    with_spans = spanned_call() + wrappers
    before = trace.summarize({"traceEvents": events}, LAYERS, run.CALL_SPAN)
    after = trace.summarize({"traceEvents": with_spans}, LAYERS,
                            run.CALL_SPAN)
    assert dataclasses.asdict(after) == dataclasses.asdict(before)


def test_every_mapped_function_carries_its_layer_s_span():
    for key, layer in LAYERS["functions"].items():
        module, func = key.rsplit(".", 1)
        fn = getattr(importlib.import_module("gemmul8_tpu_torch." + module),
                     func)
        assert getattr(fn, "span", None) == layer, key


def test_constants_are_the_harness_s():
    assert spans.OUT == run.OUT and spans.CALL_SPAN == run.CALL_SPAN


@pytest.mark.parametrize("cell", ["dgemm-int8-nu16.sq8192",
                                  "dgemm-int8-nu16.upd8192k512"])
def test_traced_cpu_run(cell):
    """On the CPU the spans are in the run's trace, nested in its calls,
    but no device operation runs: the line leaves every span metric out."""
    from h100bench_helpers import run_small, small_spec
    spec = small_spec(cell)
    names = {m["name"] for m in spec["per_layer"]
             if m["source"] == "program_span"}
    assert names
    result = run_small(spec, traced=True)
    assert result["correct"]
    assert not names & set(result["metrics"])
    with open(os.path.join(run.OUT, cell + ".stacks.json")) as f:
        s = spans.span_summary(json.load(f))
    assert s.calls == spec["traffic"]["trace_calls"] and s.has_spans
    assert not s.on_device
    # the CPU's "auto" epilogue is the unfused f64 one, inside entry
    assert set(s.host_s) == {"entry", "shifts", "encode", "products",
                             "alpha_beta"}
    assert 0 < s.host_s["shifts"] < s.host_s["entry"]
