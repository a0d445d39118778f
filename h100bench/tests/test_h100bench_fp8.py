"""The FP8 cell on the CPU at a small size: the sound program is `correct`
against the plain reference, each fault a GEMM cell can have and the control
are not, and the harness finds the cell's files and metrics by name."""
import pytest

from h100bench import run
from h100bench_helpers import run_small, small_spec
from test_h100bench_faults import FAULTS

CELL = "dgemm-fp8-nu14.sq8192"
FP8_ROOFLINES = {"kernels.encode_fp8_roofline", "fp8.products_roofline",
                 "kernels.epilogue_fp8_roofline"}


def test_sound_fp8_program_is_correct():
    result = run_small(small_spec(CELL))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["checks"]["bits_differ"]["value"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fp8_fault_is_not_correct(fault):
    spec = small_spec(CELL)
    result = run_small(spec, call=FAULTS[fault](spec))
    assert result["correct"] is False, (fault, result["checks"])
    assert result["failed"] > 0


def test_fp8_control_is_not_correct():
    spec = small_spec(CELL)
    reference = run.reference_module(spec)
    result = run_small(spec, call=reference.control(spec["config"],
                                                    spec["traffic"]))
    assert result["correct"] is False
    assert result["checks"]["gap"]["value"] > 10 * spec["limits"]["gap"]


def test_fp8_cell_spec():
    spec = run.cell_spec(CELL)
    config = spec["config"]
    assert (config["backend"], config["num_moduli"], config["dtype"]) == (
        "FP8", 14, "float64")
    assert config["reduced"] == [] and spec["cell"]["chips"] == 1
    assert (spec["traffic"]["m"], spec["traffic"]["n"],
            spec["traffic"]["k"]) == (8192, 8192, 8192)
    assert 0 < spec["limits"]["lower"] < spec["limits"]["gap"] \
        < spec["limits"]["upper"]
    assert {m["name"] for m in spec["end_to_end"]} == {
        "tflops", "call_ms_p95", "gflops_per_w", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == FP8_ROOFLINES | {
        "device.idle_pct", "entry.host_ms", "quantize.shifts_ms",
        "quantize.shifts_host_ms", "entry.syncs", "entry.device_ops"}
    for name in FP8_ROOFLINES:
        assert callable(run.metric_reader(spec, name).read)


def test_fp8_rooflines_read_nothing_without_spans():
    """On the CPU the trace holds no device operation: the FP8 rooflines,
    like the other span metrics, leave the line."""
    result = run_small(small_spec(CELL), traced=True)
    assert result["correct"], result["checks"]
    assert not FP8_ROOFLINES & set(result["metrics"])

