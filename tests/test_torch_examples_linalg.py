"""The port's linear-algebra examples (gemmul8_tpu_torch/examples:
blas3_tour, lu_solver, dense_linalg) against the JAX package's scripts
(examples/*.py), each run in this process through runpy with its output
captured.

The solvers' native pieces (triangular solves, panel LU and QR, small
eigensolvers) are torch.linalg in the port and LAPACK through XLA in JAX;
with tests/torch_native_seam.py's seam swapped both packages compute those
pieces alike, and then every call an example makes holds the JAX call's
bits and the printed lines are equal text. The one exception is svd, whose
singular values come from a column-norm sum that XLA and torch order
differently (tests/test_torch_eig.py): converged, its vt is bit-equal and
s and u are within 4 ulps; at nu = 8 (the dial's cheap end, where an
emulated product is good to about 1e-8) the ulps steer the sweeps apart and
both sets of singular values are held within 1e-7 of each other and of
numpy's. Without the seam (the port's own
LAPACK) lu_solver's results are within a relative 1e-12 of JAX's."""
import contextlib
import re

import numpy as np
import pytest

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
import torch_native_seam as seam
from gemmul8_tpu_torch.examples import blas3_tour, dense_linalg, lu_solver
from torch_example_helpers import (assert_bits, assert_calls_bits, leaves,
                                   max_relerr, run_port, run_script, spied)

SPIED = {"blas3_tour": ["syr2k", "her2k", "symm", "hemm", "trtri"],
         "lu_solver": ["solve", "trsm"],
         "dense_linalg": ["qr", "lstsq", "svd", "eigh", "inv"]}
MAINS = {"blas3_tour": blas3_tour.main, "lu_solver": lu_solver.main,
         "dense_linalg": dense_linalg.main}


def _jax(name):
    with seam.swapped(), spied(g8, SPIED[name]) as calls:
        lines, _ = run_script(f"examples/{name}.py")
    return lines, calls


@pytest.fixture(scope="module")
def lu_jax():
    return _jax("lu_solver")


def _port(name, swapped=True):
    with (seam.swapped() if swapped else contextlib.nullcontext()), \
            spied(gt, SPIED[name]) as calls:
        lines, out = run_port(MAINS[name])
    return lines, calls, out


def test_blas3_tour_bit_equal_with_native_seam():
    jl, jc = _jax("blas3_tour")
    pl, pc, out = _port("blas3_tour")
    assert pl == jl
    assert_calls_bits(pc, jc)
    # the structural guarantees, exact
    assert np.array_equal(out["syr2k"], out["syr2k"].T)
    assert np.array_equal(out["her2k"], out["her2k"].conj().T)
    assert (np.triu(out["trtri"], 1) == 0).all()


def test_lu_solver_bit_equal_with_native_seam(lu_jax):
    jl, jc = lu_jax
    pl, pc, out = _port("lu_solver")
    assert pl == jl
    assert [n for n, _ in pc] == ["solve", "solve", "solve", "trsm"]
    assert_calls_bits(pc, jc)
    assert out["r2"] < 1e-12 and out["r"] < 1e-11 and out["rt"] < 1e-11


def test_lu_solver_native_path_within_1e12_of_jax(lu_jax):
    """The port's own LAPACK (no seam): each solution within a relative
    1e-12 of JAX's, every assert of the example holding."""
    _, jc = lu_jax
    pl, pc, out = _port("lu_solver", swapped=False)
    assert pl[-1] == "OK"
    assert len(pc) == len(jc)
    for (name, p), (_, j) in zip(pc, jc):
        for x, y in zip(leaves(p), leaves(j)):
            assert max_relerr(x, y) < 1e-12, name


def _within_ulps(got, ref, ulps):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= ulps * np.spacing(np.abs(ref)))


def _numbers(line):
    return [float(x) for x in re.findall(r"\d\.\d+e[-+]\d+", line)]


def test_dense_linalg_with_native_seam():
    jl, jc = _jax("dense_linalg")
    pl, pc, out = _port("dense_linalg")
    # the port ends with OK once every result is finite; the JAX script
    # prints no OK
    assert pl[-1] == "OK"
    pl = pl[:-1]
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        if p.startswith(("svd:", "dial:")):
            # the svd lines' values, within the svd tolerances below
            assert p.split("=")[0] == j.split("=")[0]
            for x, y in zip(_numbers(p), _numbers(j)):
                assert abs(x - y) <= 0.5 * y + 1e-14, (p, j)
        else:
            assert p == j
    names = [n for n, _ in pc]
    assert names == [n for n, _ in jc] == ["qr", "lstsq", "svd", "eigh",
                                           "inv", "svd"]
    exact = [i for i, n in enumerate(names) if n != "svd"]
    assert_calls_bits([pc[i] for i in exact], [jc[i] for i in exact])
    # converged svd: vt bit for bit, s and u within 4 ulps
    (u, s, vt), (u_r, s_r, vt_r) = leaves(pc[2][1]), leaves(jc[2][1])
    assert_bits(vt, vt_r)
    _within_ulps(s, s_r, 4)
    _within_ulps(u, u_r, 4)
    # nu = 8: within 1e-7 of JAX's and of numpy's singular values
    sref = np.linalg.svd(np.random.default_rng(42).standard_normal(
        (384, 256)), compute_uv=False)
    s8, s8_r = leaves(pc[5][1])[0], leaves(jc[5][1])[0]
    assert np.max(np.abs(s8 - s8_r) / s8_r) < 1e-7
    assert np.max(np.abs(s8 - sref) / sref) < 1e-7
    assert np.max(np.abs(s8_r - sref) / sref) < 1e-7
