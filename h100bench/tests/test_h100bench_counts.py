"""The stage counts against bytes and operations counted by hand, and
against the bounds in PERF.md's kernel table, which chip_smoke.py computed
with the same conventions from the program's tables."""
import pytest

from h100bench import counts

DGEMM = {"dtype": "float64", "num_moduli": 16}
ZGEMM = {"dtype": "complex128", "num_moduli": 16}
SQ8192 = {"m": 8192, "n": 8192, "k": 8192}


def test_encode_by_hand():
    # 128 x 64 f64, nu = 16: 5 limbs; per element 2 loads + 3 x 20 for the
    # components + 2 + 4 x 4 carries, then 15 moduli x (4 + 7) + 4 for 256
    ops32 = 2 + 60 + 2 + 16 + 15 * 11 + 4
    assert ops32 == 249
    bytes_ = 128 * 64 * (8 + 16) + 4 * 128
    t_ops = max(ops32 * 128 * 64 / 33.5e12, 10 * 128 * 64 / 17e12)
    assert counts.encode(128, 64, 128, 16, 8) == (
        pytest.approx(max(t_ops, bytes_ / 3.35e12)), "operations")


def test_products_by_hand():
    t, by = counts.products(16, 256, 128, 64)
    assert by == "bytes"
    assert t == pytest.approx(16 * (256 * 64 + 64 * 128 + 4 * 256 * 128)
                              / 3.35e12)
    t, by = counts.products(16, 8192, 8192, 8192)
    assert by == "operations"
    assert t == pytest.approx(2 * 16 * 8192 ** 3 / 1979e12)


def test_epilogue_by_hand():
    # nu = 16, f64 out: 7 limbs; nu + 3 loads and store, 15 x 6 + 3
    # reductions, the CRT pipeline 16 x 7 + 8 x 6 + 8 + 7 + 13 x 7
    ops32 = 16 + 3 + 93 + (112 + 48 + 8 + 7 + 91)
    t, by = counts.epilogue(64, 32, 16, 53)
    bytes_ = 64 * 32 * (4 * 16 + 8) + 4 * 96
    assert t == pytest.approx(max(ops32 * 64 * 32 / 33.5e12,
                                  35 * 64 * 32 / 17e12, bytes_ / 3.35e12))
    assert by == "bytes"


@pytest.mark.parametrize("config, stage, ms, by", [
    (DGEMM, "encode", 2 * 0.499, "operations"),    # K1 on A and on B
    (DGEMM, "products", 8.889, "operations"),
    (DGEMM, "epilogue", 1.442, "bytes"),           # K2
    (ZGEMM, "encode", 4 * 0.499, "operations"),    # K1 on Re, Im of each
    (ZGEMM, "products", 3 * 8.889, "operations"),
    (ZGEMM, "epilogue", 4.167, "bytes"),           # K4
])
def test_stage_bounds_match_perf_md(config, stage, ms, by):
    t, got_by = counts.stages(config, SQ8192)[stage]
    assert t * 1e3 == pytest.approx(ms, rel=1e-3)
    assert got_by == by


def test_flops_by_the_reference_convention():
    assert counts.flops(DGEMM, SQ8192) == 2 * 8192 ** 3
    assert counts.flops(ZGEMM, SQ8192) == 8 * 8192 ** 3


def test_tables_match_the_program():
    """The counts' copy of the moduli and limb counts is the program's
    (a test may read the program; the yardstick may not)."""
    from gemmul8_tpu_torch import ff, quantize, tables
    assert counts.INT8_MODULI == tuple(tables.moduli("INT8"))
    for nu, nl in counts.ENCODE_LIMBS.items():
        assert quantize.n_limbs(nu, "INT8") == nl
    for bits, by_nu in counts.EPILOGUE_LIMBS.items():
        for nu, L in by_nu.items():
            assert ff.limb_plan(nu, "INT8", bits)[1] == L
