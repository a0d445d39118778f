"""The port's GEMM examples (gemmul8_tpu_torch/examples: dgemm_int8,
fp8_backend, planar_complex, compat_gemmlt, iterative_refinement) against
the JAX package's scripts (examples/*.py), each run in this process through
runpy with its output captured. The printed lines are equal text, and every
product an example computes holds the JAX product's bits (the public calls
of both packages recorded as the examples run). Also: every example's
default device is the card, so it raises where CUDA is missing."""
import importlib

import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu import compat as jcompat
from gemmul8_tpu_torch import compat as tcompat
from gemmul8_tpu_torch.examples import (compat_gemmlt, dgemm_int8,
                                        fp8_backend, iterative_refinement,
                                        planar_complex)
from torch_example_helpers import (assert_bits, assert_calls_bits, run_port,
                                   run_script, spied)

EXAMPLES = ("dgemm_int8", "fp8_backend", "planar_complex", "compat_gemmlt",
            "blas3_tour", "iterative_refinement", "lu_solver", "dense_linalg",
            "hook_training", "distributed_summa")


def _both(name, main, jax_module, port_module, names, with_args=False):
    """(JAX lines, JAX calls, port lines, port calls, port result)."""
    with spied(jax_module, names, with_args) as jc:
        jlines, _ = run_script(f"examples/{name}.py")
    with spied(port_module, names, with_args) as pc:
        plines, out = run_port(main)
    return jlines, jc, plines, pc, out


def test_dgemm_int8_bit_equal_and_same_lines():
    jl, jc, pl, pc, out = _both("dgemm_int8", dgemm_int8.main, g8, gt,
                                ["gemm"])
    assert pl == jl
    assert pl[-1] == "OK" and out["err"] == 0.0
    assert_calls_bits(pc, jc)
    assert_bits(out["c"], jc[0][1])


def test_fp8_backend_bit_equal_and_same_lines():
    jl, jc, pl, pc, out = _both("fp8_backend", fp8_backend.main, g8, gt,
                                ["gemm"])
    assert pl == jl
    assert len(pc) == 3
    assert_calls_bits(pc, jc)
    for (_, j), nu in zip(jc, (6, 9, 13)):
        assert_bits(out[nu]["c"], j)
    # the dial: each nu more accurate than the last
    errs = [out[nu]["err"] for nu in (6, 9, 13)]
    assert errs[0] > errs[1] > errs[2]


def test_planar_complex_bit_equal_and_gemm_on_complex():
    jl, jc, pl, pc, out = _both("planar_complex", planar_complex.main, g8,
                                gt, ["gemm_planar"])
    # the port adds one line: gemm on complex128 tensors, bit for bit the
    # planar result (the card has complex dtypes)
    extra = "gemm on complex128 bit-identical: True"
    assert extra in pl
    assert [x for x in pl if x != extra] == jl
    assert_calls_bits(pc, jc)
    assert_bits(out["cr"], jc[0][1][0])
    assert_bits(out["ci"], jc[0][1][1])
    assert_bits(out["cz"].real.copy(), out["cr"])


def test_compat_gemmlt_bit_equal_and_same_lines():
    names = ["gemm", "gemmLt"]
    with spied(jcompat, names, with_args=True) as jc:
        jl, _ = run_script("examples/compat_gemmlt.py")
    with spied(tcompat, names, with_args=True) as pc:
        pl, out = run_port(compat_gemmlt.main)
    # the golden values hold; the one line that differs is the text of the
    # FP8 refusal, whose wording is each package's own
    reject = "plain gemm rejected FP8 as expected:"
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        if p.startswith(reject):
            assert j.startswith(reject)
            assert "gemm does not support the FP8 backend" in p
        else:
            assert p == j
    # the calls that returned (the refused one raises first), each C
    # buffer (argument 12) updated in place to the JAX call's bits
    assert [n for n, *_ in pc] == [n for n, *_ in jc] == [
        "gemm", "gemmLt", "gemm", "gemm"]
    for (_, _, pa), (_, _, ja) in zip(pc, jc):
        assert_bits(pa[12], ja[12])
    for key, (_, _, ja) in zip(("got", "got2", "got3", "got4"), jc):
        ldc = 4
        assert_bits(out[key], ja[12].reshape(5, ldc).T[:4])
    assert out["ws"] == jcompat.workSize(4, 5, 3, 8)


def test_iterative_refinement_bit_equal_and_same_lines():
    jl, jc, pl, pc, out = _both("iterative_refinement",
                                iterative_refinement.main, g8, gt, ["gemm"])
    assert pl == jl
    assert len(pc) == 6
    # every emulated residual product holds the JAX product's bits, so the
    # refined x is the JAX script's too
    assert_calls_bits(pc, jc)
    assert out["errs"][-1] < min(out["x0_err"] * 1e-3, 1e-6)


@pytest.mark.parametrize("name", EXAMPLES)
def test_default_device_is_the_card(name):
    """With no device argument an example runs on the card: here, without
    CUDA, it raises instead of running on the CPU."""
    mod = importlib.import_module(f"gemmul8_tpu_torch.examples.{name}")
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main()
