"""Each per-layer reader on a context made by hand: what it reads, and that
it returns nothing where the trace holds nothing for it."""
import pytest

from h100bench import counts, run
from h100bench.trace import Summary

DGEMM = run.cell_spec("dgemm-int8-nu16.sq8192")
ZGEMM = run.cell_spec("zgemm-int8-nu16.sq8192")


class Ctx:
    def __init__(self, spec, layer_s, calls=4, busy_s=0.1, window_calls=300,
                 window_s=10.0, host_ms=(1.0, 2.0, 9.0)):
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.summary = Summary(calls=calls, window_s=0.2, busy_s=busy_s,
                               layer_s=layer_s)
        self.calls = calls
        self.window_calls, self.window_s = window_calls, window_s
        self.host_ms = list(host_ms)


def read(spec, name, ctx):
    return run.metric_reader(spec, name).read(ctx)


def test_idle_share_of_the_untraced_window():
    # 25 ms of device time a call, 300 calls in 10 s: 7.5 s busy
    assert read(DGEMM, "device.idle_pct", Ctx(DGEMM, {})) == \
        pytest.approx(25.0)
    assert read(DGEMM, "device.idle_pct", Ctx(DGEMM, {}, busy_s=0)) is None


def test_host_ms_is_the_median():
    assert read(DGEMM, "entry.host_ms", Ctx(DGEMM, {})) == 2.0


@pytest.mark.parametrize("name, layer", [("quantize.shifts_ms", "shifts"),
                                         ("complex_gemm.lanes_ms", "lanes")])
def test_device_ms_a_call(name, layer):
    assert read(ZGEMM, name, Ctx(ZGEMM, {layer: 0.04})) == pytest.approx(10.0)
    assert read(ZGEMM, name, Ctx(ZGEMM, {"products": 0.04})) is None


@pytest.mark.parametrize("spec", [DGEMM, ZGEMM])
@pytest.mark.parametrize("name, stage", [
    ("kernels.encode_roofline", "encode"),
    ("core.products_roofline", "products"),
    ("kernels.epilogue_roofline", "epilogue")])
def test_roofline_shares(spec, name, stage):
    least = counts.stages(spec["config"], spec["traffic"])[stage][0]
    # the stage took twice its least time in each of 4 calls: 50 %
    ctx = Ctx(spec, {stage: 2 * least * 4})
    assert read(spec, name, ctx) == pytest.approx(50.0)
    assert read(spec, name, Ctx(spec, {})) is None


@pytest.mark.parametrize("name", ["device.idle_pct", "entry.host_ms",
                                  "quantize.shifts_ms",
                                  "kernels.encode_roofline",
                                  "core.products_roofline",
                                  "kernels.epilogue_roofline"])
def test_short_twin_reads_as_its_quantity(name):
    least = counts.stages(DGEMM["config"], DGEMM["traffic"])
    ctx = Ctx(DGEMM, {stage: 3 * t[0] for stage, t in least.items()} |
              {"shifts": 0.04})
    assert read(DGEMM, name + ".short", ctx) == read(DGEMM, name, ctx)
