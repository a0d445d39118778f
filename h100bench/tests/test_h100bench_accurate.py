"""The accurate-mode cell: its files load as one cell, its stage counts
against bytes and operations counted by hand at 8192^3, its operands tell an
accurate call from a fast one, and its rooflines read the program's spans
and nothing else."""
import pytest

from h100bench import counts_accurate, run, traffic
from h100bench.reference import gemm as reference
from h100bench.spans import SpanSummary
from h100bench.trace import Summary

CELL = "dgemm-int8-nu16-accurate.sq8192phi2"
SQ8192 = {"m": 8192, "n": 8192, "k": 8192}
# accurate nu=16 reads 1.4e-15 to 1.8e-15 at 128^3, phi=2 (a few units of
# f64 rounding relative to |A||B|); fast mode's norm-based shifts spend
# bits on the rows' spread and read 2.6e-13 to 1.9e-12 on the same seeds:
# the tolerance keeps 10x above the one and 10x below the other
TOLERANCE = 2e-14


def test_spec_loads_with_its_controls():
    spec = run.cell_spec(CELL)
    config, mix, limits = spec["config"], spec["traffic"], spec["limits"]
    assert config["fastmode"] is False and config["mode"] == "accurate"
    assert (config["dtype"], config["backend"], config["num_moduli"]) == (
        "float64", "INT8", 16)
    assert mix["phi"] == 2 and (mix["m"], mix["n"], mix["k"]) == (
        8192, 8192, 8192)
    controls = limits["controls"]
    assert {"float32_reference", "num_moduli_15", "num_moduli_14",
            "num_moduli_13", "fastmode_nu16"} <= set(controls)
    # the limit sits above every sound run and 3x or more below fast mode
    assert limits["lower"] < limits["gap"] <= controls["fastmode_nu16"] / 3
    names = {m["name"] for m in spec["per_layer"]}
    assert {"accurate.scaling_ms", "accurate.extract_roofline",
            "accurate.estimate_roofline", "core.products_roofline"} <= names
    assert "quantize.shifts_ms" not in names


def test_extract_by_hand():
    # 8192^2 f64 a side: 8 bytes read and 1 written an element, 4 bytes of
    # pre-shift a row (A) or column (B)
    side = 8192 * 8192 * 9 + 4 * 8192
    assert side == 604_012_544
    t, by = counts_accurate.stages({"dtype": "float64", "backend": "INT8",
                                    "num_moduli": 16, "fastmode": False},
                                   SQ8192)["extract"]
    assert by == "bytes"
    assert t == pytest.approx(2 * side / 3.35e12)
    assert t * 1e3 == pytest.approx(0.3606, abs=1e-4)


def test_estimate_by_hand():
    t, by = counts_accurate.estimate(8192, 8192, 8192)
    assert by == "operations"
    assert t == pytest.approx(2 * 8192 ** 3 / 1979e12)
    assert t * 1e3 == pytest.approx(0.5556, abs=1e-4)
    # a short product is bound by its planes and its int32 output
    t, by = counts_accurate.estimate(256, 128, 64)
    assert by == "bytes"
    assert t == pytest.approx((256 * 64 + 64 * 128 + 4 * 256 * 128)
                              / 3.35e12)


@pytest.mark.parametrize("change", [
    {"fastmode": True}, {"backend": "FP8"}, {"dtype": "complex128"}])
def test_stages_refuse_what_they_do_not_count(change):
    config = dict(run.cell_spec(CELL)["config"], **change)
    with pytest.raises(ValueError):
        counts_accurate.stages(config, SQ8192)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 7])
def test_phi2_tells_accurate_from_fast(seed):
    import gemmul8_tpu_torch as gt
    spec = run.cell_spec(CELL)
    mix = dict(spec["traffic"], m=128, n=128, k=128)
    ops = traffic.operand_sets(mix, "float64", seed, "cpu")[0]
    gaps = {}
    for fastmode in (False, True):
        out = gt.gemm(ops["a"], ops["b"], num_moduli=16, fastmode=fastmode,
                      device="cpu")
        gaps[fastmode] = reference.max_gap(out, ops, spec["config"], mix)
    assert gaps[False] < TOLERANCE < gaps[True]


class Ctx:
    """A traced run's context whose span summary is given: 4 calls."""

    def __init__(self, device_s, on_device=True, has_spans=True):
        spec = run.cell_spec(CELL)
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.summary = Summary(calls=4, window_s=0.2, busy_s=0.1)
        self.calls = 4
        self.spans = SpanSummary(calls=4, has_spans=has_spans,
                                 on_device=on_device, device_s=device_s)


def read(name, ctx):
    return run.metric_reader(run.cell_spec(CELL), name).read(ctx)


@pytest.mark.parametrize("name, stage", [
    ("accurate.extract_roofline", "extract"),
    ("accurate.estimate_roofline", "estimate")])
def test_rooflines_read_the_spans(name, stage):
    spec = run.cell_spec(CELL)
    least = counts_accurate.stages(spec["config"], spec["traffic"])[stage][0]
    # the stage's spans took four times its least time in each of 4 calls
    assert read(name, Ctx({stage: 4 * least * 4})) == pytest.approx(25.0)


def test_scaling_ms_sums_the_three_layers():
    ctx = Ctx({"extract": 0.032, "estimate": 0.008, "shifts": 0.0012,
               "products": 1.0})
    assert read("accurate.scaling_ms", ctx) == pytest.approx(10.3)


@pytest.mark.parametrize("name", ["accurate.scaling_ms",
                                  "accurate.extract_roofline",
                                  "accurate.estimate_roofline"])
def test_metrics_read_none_without_their_spans(name):
    # a program that opens only gemmul8.shifts around accurate scaling
    assert read(name, Ctx({"shifts": 0.04, "products": 1.0})) is None
    # no gemmul8.* span at all, or a run on the CPU
    assert read(name, Ctx({}, has_spans=False)) is None
    assert read(name, Ctx({"extract": 0.04, "estimate": 0.01},
                          on_device=False)) is None
    # the stack's layers are not read: only the program's spans are
    ctx = Ctx({"harness": 1.0})
    ctx.summary.layer_s = {"extract": 0.04, "estimate": 0.01}
    assert read(name, ctx) is None


def test_small_run_on_the_cpu_reads_no_span_metric():
    from h100bench_helpers import run_small, small_spec
    result = run_small(small_spec(CELL), traced=True)
    assert result["correct"]
    assert not {"accurate.scaling_ms", "accurate.extract_roofline",
                "accurate.estimate_roofline"} & set(result["metrics"])
