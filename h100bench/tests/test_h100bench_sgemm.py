"""The SGEMM cell: its files load as one cell with its metrics,
its float64 reference (reference/gemm_wide.py) judges a float32 output by
gemm.py's gap and refuses any other, its TF32 control stands apart from the
float64 product, and `correct` comes out false for each fault a GEMM cell can
have, driven through the rest of a run on the CPU at a small size."""
import numpy as np
import pytest
import torch

from h100bench import run, traffic
from h100bench.reference import gemm, gemm_wide
from h100bench_helpers import run_small, small_spec
from test_h100bench_faults import FAULTS

CELL = "sgemm-int8-nu8.sq8192"
CONFIG = {"dtype": "float32", "control_dtype": "tf32"}
MIX = {"alpha": 1.0, "beta": 0.0}
U32 = 2.0 ** -24


def operands(m=40, k=70, n=24, seed=2601):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(m, k, generator=g),
            "b": torch.randn(k, n, generator=g), "c": None}


def test_spec_loads_with_its_metrics():
    spec = run.cell_spec(CELL)
    config, mix = spec["config"], spec["traffic"]
    assert (config["dtype"], config["backend"], config["num_moduli"],
            config["fastmode"], config["mode"], config["epilogue"]) == (
        "float32", "INT8", 8, True, "fast", "auto")
    assert (config["entry"], config["reference"], config["control_dtype"]) \
        == ("gemm", "gemm_wide", "tf32")
    assert (mix["m"], mix["n"], mix["k"], mix["phi"]) == (8192, 8192, 8192,
                                                          -1)
    assert spec["cell"]["chips"] == 1
    assert {m["name"] for m in spec["end_to_end"]} == {
        "tflops", "call_ms_p95", "gflops_per_w.short", "peak_mem_gib",
        "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == {
        "device.idle_pct", "entry.host_ms", "quantize.shifts_ms",
        "kernels.encode_roofline", "core.products_roofline",
        "kernels.epilogue_roofline", "entry.syncs",
        "quantize.shifts_host_ms", "entry.device_ops"}
    assert run.reference_module(spec).max_gap is not None


def test_rounded_float64_product_reads_under_one_float32_ulp():
    ops = operands()
    exact = ops["a"].double() @ ops["b"].double()
    gap = gemm_wide.max_gap(exact.float(), ops, CONFIG, MIX, block_rows=16)
    # |fl(x) - x| <= 2^-24 |x| <= 2^-24 |A||B|, and float64's own rounding
    # of the reference is some 2^-45 of that
    assert 0 < gap < 2 * U32


@pytest.mark.parametrize("alpha, beta, with_c", [(1.0, 0.0, False),
                                                 (-1.0, 1.0, True),
                                                 (0.5, -2.0, True)])
def test_gap_is_gemm_gap_in_float64(alpha, beta, with_c):
    """gemm_wide's gap on float32 is gemm.py's on the same values in
    float64, to the bit, in blocks of rows or whole."""
    ops = operands()
    if with_c:
        ops["c"] = torch.randn(40, 24, generator=torch.Generator()
                               .manual_seed(5))
    mix = {"alpha": alpha, "beta": beta}
    out = alpha * (ops["a"] @ ops["b"]) + (beta * ops["c"] if with_c else 0)
    wide = {k: None if v is None else v.double() for k, v in ops.items()}
    want = gemm.max_gap(out.double(), wide, {"dtype": "float64"}, mix)
    assert want > 0
    for rows in (16, 2048):
        assert gemm_wide.max_gap(out, ops, CONFIG, mix, rows) == want


@pytest.mark.parametrize("bad", ["float64", "shape", "nan"])
def test_gap_refuses_other_outputs(bad):
    ops = operands()
    out = (ops["a"].double() @ ops["b"].double()).float()
    if bad == "float64":
        out = out.double()
    elif bad == "shape":
        out = out[:, :-1]
    else:
        out[3, 5] = float("nan")
    assert gemm_wide.max_gap(out, ops, CONFIG, MIX) == float("inf")


def test_tf32_keeps_ten_fraction_bits_to_nearest_even():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one, one + ulp, one + ulp / 2, one + 3 * ulp / 2,
                      one + ulp / 2 + 2.0 ** -20, -(one + 3 * ulp / 2), 0.0])
    want = [one, one + ulp, one, one + 2 * ulp, one + ulp,
            -(one + 2 * ulp), 0.0]
    assert gemm_wide.tf32(x).tolist() == want
    y = torch.randn(1000, generator=torch.Generator().manual_seed(3))
    t = gemm_wide.tf32(y)
    assert torch.all((t.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((t - y).abs() <= 2.0 ** -11 * y.abs())


def test_control_differs_from_the_float64_product_and_restores_tf32():
    ops = operands(m=64, k=256, n=48)
    before = torch.backends.cuda.matmul.allow_tf32
    out = gemm_wide.control(CONFIG, MIX)(ops)
    assert torch.backends.cuda.matmul.allow_tf32 == before
    assert out.dtype == torch.float32
    exact = (ops["a"].double() @ ops["b"].double()).float()
    assert not torch.equal(out, exact)
    # TF32's operand rounding: some 2^-11 |a||b| a term, far beyond float32
    gap = gemm_wide.max_gap(out, ops, CONFIG, MIX)
    assert gap > 2.0 ** -18
    native = gemm_wide.max_gap(ops["a"] @ ops["b"], ops, CONFIG, MIX)
    assert gap > 100 * native


def test_sound_program_is_correct():
    result = run_small(small_spec(CELL))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["checks"]["gap"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    spec = small_spec(CELL)
    result = run_small(spec, call=FAULTS[fault](spec))
    assert result["correct"] is False, (fault, result["checks"])
    assert result["failed"] > 0


def test_control_is_not_correct():
    spec = small_spec(CELL)
    reference = run.reference_module(spec)
    result = run_small(spec, call=reference.control(spec["config"],
                                                    spec["traffic"]))
    assert result["correct"] is False
    assert result["checks"]["gap"]["value"] > 10 * spec["limits"]["gap"]


def test_gap_reads_the_program_not_the_float32_reference():
    """At 8 moduli the program errs less than float32's own product: judged
    in float32 arithmetic the gap would read the reference's rounding."""
    spec = small_spec(CELL)
    mix = dict(spec["traffic"], operand_sets=1)
    ops = traffic.operand_sets(mix, "float32", 2 ** 31 + 7, "cpu")[0]
    out = run.entry_module(spec).make(spec["config"], mix, "cpu")(ops)
    program = gemm_wide.max_gap(out, ops, spec["config"], mix)
    native = gemm_wide.max_gap(ops["a"] @ ops["b"], ops, spec["config"], mix)
    assert np.isfinite(program) and program < native
