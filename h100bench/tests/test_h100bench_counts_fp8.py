"""The FP8 stage counts against bytes and operations counted by hand, against
the bounds in PERF.md's kernel table (K6, the FP8 products, K3 at 8192^3 f64
nu=14), and the rooflines that read the program's spans."""
import pytest

from h100bench import counts_fp8, run
from h100bench.spans import SpanSummary
from h100bench.trace import Summary

FP8 = {"dtype": "float64", "backend": "FP8", "num_moduli": 14}
SQ8192 = {"m": 8192, "n": 8192, "k": 8192}


def test_encode_by_hand():
    # 128 x 64 f64, nu = 14: 5 limbs; per element 2 loads + 3 x 20 for the
    # components + 2 + 4 x 4 carries, 13 moduli x (4 + 6) + 3 for 1024, and
    # the split (14) of each of the 14
    ops32 = 2 + 60 + 2 + 16 + 13 * 10 + 3 + 14 * 14
    assert ops32 == 409
    bytes_ = 128 * 64 * (8 + 3 * 14) + 4 * 128
    want = max(ops32 * 128 * 64 / 33.5e12, 10 * 128 * 64 / 17e12,
               bytes_ / 3.35e12)
    assert counts_fp8.encode(128, 64, 128, 14, 8) == (pytest.approx(want),
                                                      "bytes")
    # f32, nu = 7: 3 limbs, the scale (3), one component; 6 x 8 + 3
    ops32 = 2 + 3 + 20 + 2 + 8 + 6 * 8 + 3 + 7 * 14
    t, _ = counts_fp8.encode(64, 32, 32, 7, 4)
    assert t == pytest.approx(max(ops32 * 64 * 32 / 33.5e12,
                                  (64 * 32 * (4 + 21) + 4 * 32) / 3.35e12))


def test_products_by_hand():
    t, by = counts_fp8.products(14, 256, 128, 64)
    assert by == "bytes"
    assert t == pytest.approx(42 * (256 * 64 + 64 * 128 + 4 * 256 * 128)
                              / 3.35e12)
    t, by = counts_fp8.products(14, 8192, 8192, 8192)
    assert by == "operations"
    assert t == pytest.approx(2 * 42 * 8192 ** 3 / 1979e12)


def test_epilogue_by_hand():
    # nu = 14, f64 out: 7 limbs; 3nu + 3 loads and store; the reassembly:
    # 5 squares x 15, the square 1024 14, 8 Karatsuba moduli x 16; the CRT
    # pipeline 14 x 7 + 8 x 6 + 8 + 7 + 13 x 7
    ops32 = 42 + 3 + (5 * 15 + 14 + 8 * 16) + (98 + 48 + 8 + 7 + 91)
    assert ops32 == 514
    t, by = counts_fp8.epilogue(64, 32, 14, 53)
    bytes_ = 64 * 32 * (12 * 14 + 8) + 4 * 96
    assert t == pytest.approx(max(ops32 * 64 * 32 / 33.5e12,
                                  35 * 64 * 32 / 17e12, bytes_ / 3.35e12))
    assert by == "bytes"


@pytest.mark.parametrize("stage, ms, by", [
    ("encode", 2 * 1.002, "bytes"),     # K6 on A and on B
    ("products", 23.335, "operations"),
    ("epilogue", 3.526, "bytes"),       # K3
])
def test_stage_bounds_match_perf_md(stage, ms, by):
    t, got_by = counts_fp8.stages(FP8, SQ8192)[stage]
    assert t * 1e3 == pytest.approx(ms, rel=1e-3)
    assert got_by == by


@pytest.mark.parametrize("config, traffic", [
    (FP8, dict(SQ8192, k=2 ** 16 + 128)),        # the K-chunked route
    (dict(FP8, dtype="complex128"), SQ8192),
    (dict(FP8, dtype="complex64", num_moduli=7), SQ8192),
    (dict(FP8, backend="INT8"), SQ8192),
])
def test_stages_refuse_what_they_do_not_count(config, traffic):
    with pytest.raises(ValueError):
        counts_fp8.stages(config, traffic)


def test_stages_count_k_up_to_the_chunk():
    assert counts_fp8.stages(FP8, dict(SQ8192, k=2 ** 16))["products"][1] \
        == "operations"


def test_tables_match_the_program():
    """The counts' copy of the FP8 moduli, split and limb counts is the
    program's (a test may read the program; the yardstick may not)."""
    from gemmul8_tpu_torch import ff, fp8, quantize, tables
    assert counts_fp8.FP8_MODULI == tuple(tables.moduli("FP8"))
    assert counts_fp8.NOT_KARATSUBA == tables.NOT_KARATSUBA
    assert [q * q for q in fp8._sqrt_moduli()] == list(
        counts_fp8.FP8_MODULI[:counts_fp8.NOT_KARATSUBA])
    assert counts_fp8.K_CHUNK == fp8.K_CHUNK_FP8
    for nu, nl in counts_fp8.ENCODE_LIMBS.items():
        assert quantize.n_limbs(nu, "FP8") == nl
    for bits, by_nu in counts_fp8.EPILOGUE_LIMBS.items():
        for nu, L in by_nu.items():
            assert ff.limb_plan(nu, "FP8", bits)[1] == L


class Ctx:
    """A traced run's context whose span summary is given: 4 calls."""

    def __init__(self, device_s, on_device=True):
        spec = run.cell_spec("dgemm-fp8-nu14.sq8192")
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.summary = Summary(calls=4, window_s=0.2, busy_s=0.1)
        self.calls = 4
        self.spans = SpanSummary(calls=4, has_spans=True, on_device=on_device,
                                 device_s=device_s)


@pytest.mark.parametrize("name, stage", [
    ("kernels.encode_fp8_roofline", "encode"),
    ("fp8.products_roofline", "products"),
    ("kernels.epilogue_fp8_roofline", "epilogue")])
def test_rooflines_read_the_spans(name, stage):
    spec = run.cell_spec("dgemm-fp8-nu14.sq8192")
    least = counts_fp8.stages(spec["config"], spec["traffic"])[stage][0]
    reader = run.metric_reader(spec, name)
    # the stage's spans took twice its least time in each of 4 calls: 50 %
    assert reader.read(Ctx({stage: 2 * least * 4})) == pytest.approx(50.0)
    # the stack's layers are not read: only the program's spans are
    ctx = Ctx({"harness": 1.0})
    ctx.summary.layer_s = {stage: 2 * least * 4}
    assert reader.read(ctx) is None
    # a run on the CPU: no device operation to read
    assert reader.read(Ctx({stage: 1.0}, on_device=False)) is None
