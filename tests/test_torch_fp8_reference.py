"""The FP8 backend at the benchmark's deployment (DGEMM, 14 moduli, fast
mode) against the benchmark's plain reference on the CPU: gemmul8_tpu_torch
.gemm(..., backend="FP8", num_moduli=14) on seeded standard normal operands
from the benchmark's own generator, judged by h100bench/reference/gemm.py's
gap under the cell's limit; at 11 moduli the same operands read beyond it,
so a path that lost precision would be caught."""
import json
import os

import pytest
import torch

import gemmul8_tpu_torch as gt
from h100bench import traffic
from h100bench.reference import gemm as reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "dgemm-fp8-nu14.sq8192"


def _load(*parts):
    with open(os.path.join(ROOT, "h100bench", *parts)) as f:
        return json.load(f)


CONFIG = _load("configs", "dgemm-fp8-nu14.json")
MIX = _load("traffic", "sq8192.json")
LIMIT = _load("limits", CELL + ".json")["gap"]
# (m, k, n): a multiple of 128 in every dimension, and a ragged one
SHAPES = [(256, 384, 128), (203, 331, 97)]


def _gap(shape, num_moduli, seed=2 ** 31 + 11):
    m, k, n = shape
    mix = dict(MIX, m=m, n=n, k=k)
    ops = traffic.operand_sets(mix, CONFIG["dtype"], seed, "cpu")[0]
    out = gt.gemm(ops["a"], ops["b"], num_moduli=num_moduli,
                  fastmode=CONFIG["fastmode"], backend=CONFIG["backend"],
                  epilogue=CONFIG["epilogue"], alpha=mix["alpha"],
                  beta=mix["beta"], device="cpu")
    assert out.dtype == torch.float64 and out.shape == (m, n)
    return reference.max_gap(out, ops, dict(CONFIG, num_moduli=num_moduli),
                             mix)


@pytest.mark.parametrize("shape", SHAPES)
def test_deployment_within_the_cell_limit(shape):
    assert CONFIG["backend"] == "FP8" and CONFIG["num_moduli"] == 14
    assert _gap(shape, 14) <= LIMIT


@pytest.mark.parametrize("shape", SHAPES)
def test_fewer_moduli_beyond_the_cell_limit(shape):
    assert _gap(shape, 11) > LIMIT
