"""The trace reader on a small hand-made chrome trace: layers from launch
stacks, the busy union, and the idle gaps by what the host was doing."""
import json
import os

import pytest

from h100bench import run, trace

LAYERS = run.load_json(os.path.join(run.ROOT, "h100bench", "layers.json"))
P = "gemmul8_tpu_torch/"


def py(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "python_function", "name": name, "ts": ts,
            "dur": dur, "tid": tid, "pid": 1}


def launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "tid": tid, "pid": 1,
            "args": {"correlation": corr}}


def kernel(name, corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "tid": 7, "pid": 0, "args": {"correlation": corr}}


def call_span(ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": run.CALL_SPAN,
            "ts": ts, "dur": dur, "tid": 1, "pid": 1}


def one_call():
    """One call, 0-100 µs: shifts (a reduce) 10-20, K1 20-40 launched from
    encode_planes, products 40-70, K2 70-80 launched from fused_epilogue,
    and a checksum from the harness 90-95."""
    return [
        call_span(0, 100),
        py("h100bench/run.py(134): step", 0, 100),
        py(P + "core.py(391): gemm", 1, 80),
        py(P + "core.py(302): emulate_matmul", 2, 78),
        py(P + "quantize.py(114): shift_fast", 3, 10),
        py(P + "quantize.py(97): ilogb", 4, 5),
        launch(1, 5),
        py(P + "kernels.py(283): encode_planes", 14, 4),
        py(P + "kernels.py(206): _launch", 15, 2),
        launch(2, 16),
        py(P + "core.py(39): residue_matmul", 19, 5),
        launch(3, 20),
        py(P + "kernels.py(587): fused_epilogue", 25, 3),
        launch(4, 26),
        {"ph": "X", "cat": "cpu_op", "name": "cudaDeviceSynchronize",
         "ts": 82, "dur": 7, "tid": 1, "pid": 1},
        launch(5, 89),
        kernel("reduce_kernel", 1, 10, 10),
        kernel("void encode_rows_kernel<Int8Residues, 5>(...)", 2, 20, 20),
        kernel("sm90_xmma_gemm_s8s8_s32", 3, 40, 30),
        kernel("void epilogue_kernel<7, true>(int const*)", 4, 70, 10),
        kernel("reduce_kernel", 5, 90, 5),
    ]


def test_layers_busy_and_gaps():
    s = trace.summarize({"traceEvents": one_call()}, LAYERS, run.CALL_SPAN)
    assert s.calls == 1 and s.window_s == pytest.approx(100e-6)
    assert s.layer_s == pytest.approx({"shifts": 10e-6, "encode": 20e-6,
                                       "products": 30e-6, "epilogue": 10e-6,
                                       "harness": 5e-6})
    assert s.busy_s == pytest.approx(75e-6)
    gaps = dict(s.idle_gaps)
    # 0-10 in ilogb's launch, 80-90 in the synchronise, 95-100 after it
    assert gaps["quantize.ilogb > cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["harness:run.step > cudaDeviceSynchronize"] == \
        pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(25e-6)
    names = [name for name, _ in s.device_ops]
    assert names[0] == "products: sm90_xmma_gemm_s8s8_s32"
    assert "epilogue: void epilogue_kernel<7, true>" in names


def test_unmapped_and_unattributed():
    events = one_call()
    events.append(py(P + "tables.py(10): moduli", 40, 3))
    events.append(launch(6, 41))
    events.append(kernel("some_kernel", 6, 96, 2))
    events.append(kernel("some_other_kernel", 99, 98, 1))
    s = trace.summarize({"traceEvents": events}, LAYERS, run.CALL_SPAN)
    # tables.moduli is inside emulate_matmul's frame, which maps to entry
    assert s.layer_s["entry"] == pytest.approx(2e-6)
    assert s.layer_s["unattributed"] == pytest.approx(1e-6)


def test_no_call_span_is_an_error():
    with pytest.raises(ValueError):
        trace.summarize({"traceEvents": one_call()[1:]}, LAYERS,
                        run.CALL_SPAN)


def test_profiler_trace_of_a_cpu_run_reads(tmp_path):
    """The profiler's own export on this machine parses: python frames and
    the call spans are found."""
    from h100bench_helpers import run_small, small_spec
    result = run_small(small_spec(), traced=True)
    path = os.path.join(run.OUT, "dgemm-int8-nu16.sq8192.stacks.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    cats = {e.get("cat") for e in events}
    assert {"python_function", "user_annotation", "cpu_op"} <= cats
    assert result["device"]["window_s"] > 0


def test_busy_seconds_is_the_union_of_device_operations():
    events = [kernel("k", 1, 0, 10), kernel("k", 2, 5, 10),
              kernel("k", 3, 30, 5), py(P + "core.py(1): gemm", 0, 50)]
    assert trace.busy_seconds({"traceEvents": events}) == pytest.approx(20e-6)


def test_device_clock_ahead_of_the_host_is_shifted_back():
    """The trace puts the first kernel 3 µs before its launch: every device
    operation moves 3 µs later, and the first idle gap, before that kernel
    now starts at its launch, shrinks to 5 µs."""
    events = one_call()
    for e in events:
        if e["cat"] == "kernel":
            e["ts"] -= 3 if e["args"]["correlation"] != 1 else 8
    s = trace.summarize({"traceEvents": events}, LAYERS, run.CALL_SPAN)
    assert s.layer_s["shifts"] == pytest.approx(10e-6)
    assert s.layer_s["encode"] == pytest.approx(20e-6)
    gaps = dict(s.idle_gaps)
    assert gaps["core.emulate_matmul"] == pytest.approx(5e-6)
    assert sum(gaps.values()) == pytest.approx(25e-6)
