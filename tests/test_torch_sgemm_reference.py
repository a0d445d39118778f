"""Emulated SGEMM at the benchmark's deployment (float32, INT8, 8 moduli, fast
mode) against the benchmark's float64 reference on the CPU:
gemmul8_tpu_torch.gemm on seeded standard normal float32 operands from the
benchmark's own generator, judged by h100bench/reference/gemm_wide.py's gap;
at 5 moduli the same operands read far beyond it, so a path that lost
precision would be caught, and two calls return the same bits."""
import json
import os

import pytest
import torch

import gemmul8_tpu_torch as gt
from h100bench import traffic
from h100bench.reference import gemm_wide as reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(*parts):
    with open(os.path.join(ROOT, "h100bench", *parts)) as f:
        return json.load(f)


CONFIG = _load("configs", "fp32", "sgemm-int8-nu8.json")
MIX = _load("traffic", "sq8192.json")
# nu=8 reads 1.8e-8 to 3.3e-8 of alpha |A||B| on these shapes and seeds (k up
# to 4096 alike); nu=7 2.4e-7 to 5.2e-7, float32's own torch.matmul 1.8e-7
# to 3.7e-7, nu=5 5.9e-5 and more: the tolerance keeps 3x above the one and
# 2.4x below the next, so it also holds nu=8 beyond a native float32 product
TOLERANCE = 1e-7
# (m, k, n): square, a multiple of 128 in every dimension, and ragged
SHAPES = [(256, 256, 256), (128, 256, 96), (203, 131, 97)]
SEEDS = [7, 2 ** 31 + 7]


def _call(shape, num_moduli, seed, **kw):
    m, k, n = shape
    mix = dict(MIX, m=m, n=n, k=k)
    ops = traffic.operand_sets(mix, CONFIG["dtype"], seed, "cpu")[0]
    out = gt.gemm(ops["a"], ops["b"], num_moduli=num_moduli,
                  fastmode=CONFIG["fastmode"], backend=CONFIG["backend"],
                  alpha=mix["alpha"], beta=mix["beta"], device="cpu", **kw)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    return out, ops, mix


def _gap(shape, num_moduli, seed, **kw):
    out, ops, mix = _call(shape, num_moduli, seed, **kw)
    return reference.max_gap(out, ops, dict(CONFIG, num_moduli=num_moduli),
                             mix)


def test_deployment_is_the_cell_configuration():
    assert (CONFIG["dtype"], CONFIG["backend"], CONFIG["num_moduli"],
            CONFIG["fastmode"], CONFIG["reference"]) == (
        "float32", "INT8", 8, True, "gemm_wide")


# the card resolves epilogue="auto" to the int32-limb epilogue ("ff"), the
# CPU to "f64": each held to the same tolerance
@pytest.mark.parametrize("epilogue", ["ff", "f64"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_nu8_within_the_tolerance(shape, seed, epilogue):
    gap = _gap(shape, 8, seed, epilogue=epilogue)
    assert 0 < gap <= TOLERANCE


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_nu5_fails_the_tolerance(shape, seed):
    assert _gap(shape, 5, seed, epilogue="ff") > 100 * TOLERANCE


@pytest.mark.parametrize("shape", SHAPES)
def test_tf32_control_fails_the_tolerance(shape):
    _, ops, mix = _call(shape, 8, SEEDS[0])
    control = reference.control(CONFIG, mix)(ops)
    assert reference.max_gap(control, ops, CONFIG, mix) > 100 * TOLERANCE


@pytest.mark.parametrize("shape", SHAPES)
def test_two_calls_give_the_same_bits(shape):
    first, _, _ = _call(shape, 8, SEEDS[1], epilogue="ff")
    second, _, _ = _call(shape, 8, SEEDS[1], epilogue="ff")
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
