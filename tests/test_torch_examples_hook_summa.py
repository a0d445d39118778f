"""The port's hook_training and distributed_summa examples
(gemmul8_tpu_torch/examples) against the JAX package's scripts, each run in
this process through runpy with its output captured.

- hook_training: the MLP trained under gemmul8_tpu_torch.emulate ends
  within 1e-5 of the JAX script's loss and parameters (XLA's f32 tanh is
  not torch's, so the bits part after the first step), and the port's two
  runs are bit-identical.
- distributed_summa: a spawned 2x2 gloo cluster runs the example (no JAX
  in the ranks); every rank's block of C, and the gathered C, holds the
  bits of the JAX script's result on its 2x4 mesh (SUMMA's bits do not
  depend on the mesh shape), in each of the three modes, and the printed
  lines match but for the mesh line.
"""
import re

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_mesh_workers as w
from gemmul8_tpu_torch.examples import hook_training
from torch_example_helpers import assert_bits, host, run_port, run_script, \
    spied


@pytest.fixture(scope="module")
def hook_runs():
    with spied(jax.tree, ["leaves"]) as calls:
        jl, _ = run_script("examples/hook_training.py")
    # the script's bit-identity check takes the leaves of p1, then p2
    p1 = [host(x) for x in calls[0][1]]
    pl, out = run_port(hook_training.main)
    return jl, p1, pl, out


def _loss(line):
    return float(re.search(r"final loss: ([0-9.]+)", line).group(1))


def test_hook_training_within_1e5_of_jax(hook_runs):
    jl, p1, pl, out = hook_runs
    assert abs(out["loss"] - _loss(jl[0])) < 1e-5
    assert abs(_loss(pl[0]) - _loss(jl[0])) < 1e-5
    for got, ref in zip((out["w1"], out["w2"]), p1):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert np.max(np.abs(got - ref)) < 1e-5


def test_hook_training_two_runs_bit_identical(hook_runs):
    jl, _, pl, out = hook_runs
    assert out["same"] and out["loss"] == out["loss2"]
    assert_bits(out["w1"], out["w1_2"])
    assert_bits(out["w2"], out["w2_2"])
    # 20 steps of 2 forward and 3 backward products, then the final loss's
    # 2, in each of the two runs
    assert out["intercepted"] == 2 * (20 * 5 + 2)
    # the JAX script's two lines, and the port's count of the products
    # the interposer emulated
    for lines in (pl, jl):
        assert lines[0].startswith("final loss: ")
        assert lines[0].endswith("; two runs bit-identical: True")
        assert lines[-1] == "OK"
    assert pl[1:] == [f"products intercepted: {out['intercepted']}", "OK"]
    assert len(jl) == 2


@pytest.fixture(scope="module")
def summa_runs(tmp_path_factory):
    jl, glb = run_script("examples/distributed_summa.py")
    tmp = tmp_path_factory.mktemp("summa")
    mp.spawn(w.example_worker, args=(4, str(tmp / "store"), str(tmp)),
             nprocs=4, join=True)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return jl, glb, ranks


MODES = (("gather", "c_gather"), ("stream", "c_stream"),
         ("accurate", "c_accu"))


@pytest.mark.parametrize("mode,jax_name", MODES, ids=[m for m, _ in MODES])
def test_distributed_summa_blocks_bit_equal_to_jax_2x4(summa_runs, mode,
                                                       jax_name):
    _, glb, ranks = summa_runs
    ref = host(glb[jax_name])
    assert tuple(glb["mesh"].devices.shape) == (2, 4)
    for r, got in enumerate(ranks):
        out = got["out"]
        assert got["imported"] == [], got["imported"]
        assert out["mesh"] == (2, 2)
        xi, yi = out["coord"]
        blk = ref[xi * 128:(xi + 1) * 128, yi * 128:(yi + 1) * 128]
        assert_bits(out["blocks"][mode], blk, f"rank {r} {mode}")
        assert_bits(out[mode], ref, f"rank {r} {mode} gathered")


def test_distributed_summa_lines(summa_runs):
    jl, _, ranks = summa_runs
    pl = ranks[0]["lines"]
    assert all(not got["lines"] for got in ranks[1:])    # rank 0 prints
    assert jl[0] == "mesh: (2, 4) on cpu" and pl[0] == "mesh: (2, 2) on cpu"
    # the rest equal text (the same bits), and the port's closing OK
    assert pl[1:] == jl[1:] + ["OK"]
    assert ranks[0]["out"]["stream_equal"]
    # the example leaves alone a group it did not start
    assert all(got["initialized"] for got in ranks)
