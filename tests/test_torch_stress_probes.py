"""The port's device stress sweep and rank-2k probe
(gemmul8_tpu_torch/probes: device_stress, blas3_perf) on the CPU.

- device_stress against tools/device_stress.py, run in this process
  through runpy: with the public entries of both packages spied on, the
  two runs make the same gemm and gemm_planar calls in the same order,
  with the same arguments (the port's device= aside), and each result
  holds the JAX result's bits; the trial lines are equal text and both
  exit 0. Seed 0 draws INT8 trials only; seed 1 three FP8 ones too.
- device_stress --against-cpu reruns every trial on the CPU path; a wrong
  result fails the sweep (exit 1); the default device is the card, so
  without CUDA the sweep raises instead of falling back to the CPU.
- blas3_perf at n = k = 96, nu = 8: syr2k and the naive two-GEMM form
  differ by exactly 0, a difference raises, the her2k leg runs and the CSV
  holds the five rows."""
import contextlib
import csv
import io
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu_torch.probes import blas3_perf, device_stress
from torch_example_helpers import ROOT, assert_bits, host

ENTRIES = ("gemm", "gemm_planar")


@contextlib.contextmanager
def recorded(module, names):
    """(name, args, kwargs, output) of every call of module.<name>."""
    calls = []
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        return call

    for n in names:
        setattr(module, n, wrap(n, saved[n]))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def _run_tool(argv):
    """tools/device_stress.py as a script: (exit code, stderr lines,
    stdout lines)."""
    path = os.path.join(ROOT, "tools", "device_stress.py")
    out, err = io.StringIO(), io.StringIO()
    saved = sys.argv
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            with pytest.raises(SystemExit) as done:
                runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved
    return done.value.code, err.getvalue().splitlines(), \
        out.getvalue().splitlines()


def _run_port(argv):
    """device_stress.main(argv) on one torch thread: (exit code, stderr
    lines, stdout lines)."""
    out, err = io.StringIO(), io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            code = device_stress.main(argv)
    finally:
        torch.set_num_threads(threads)
    return code, err.getvalue().splitlines(), out.getvalue().splitlines()


def _outputs(out):
    return [host(x) for x in out] if isinstance(out, tuple) else [host(out)]


@pytest.mark.parametrize("seed", [0, 1])
def test_device_stress_same_calls_and_bits(seed):
    argv = ["--trials", "5", "--seed", str(seed)]
    with recorded(g8, ENTRIES) as jcalls:
        jcode, jerr, jout = _run_tool(argv)
    with recorded(gt, ENTRIES) as pcalls:
        pcode, perr, pout = _run_port(argv + ["--device", "cpu"])
    assert jcode == pcode == 0
    assert jout == pout == ["stress passed"]
    # the trial lines (the first line names the device)
    assert perr[0] == "device: cpu" and perr[1:] == jerr[1:]
    assert len(perr) == 1 + 5 + 3
    assert [c[0] for c in pcalls] == [c[0] for c in jcalls] == \
        ["gemm"] * 5 + ["gemm_planar"] * 3
    if seed == 1:
        assert sum(c[2]["backend"] == "FP8" for c in pcalls[:5]) == 3
    for i, ((name, pargs, pkw, pout_), (_, jargs, jkw, jout_)) in enumerate(
            zip(pcalls, jcalls)):
        what = f"call {i} {name}"
        assert len(pargs) == len(jargs), what
        for x, y in zip(pargs, jargs):
            assert_bits(x, y, what)
        pkw = dict(pkw)
        assert pkw.pop("device") == torch.device("cpu")
        pc, jc = pkw.pop("c", None), jkw.get("c")
        assert pkw == {k: v for k, v in jkw.items() if k != "c"}, what
        if jc is not None:
            assert_bits(pc, jc, what)
        for x, y in zip(_outputs(pout_), _outputs(jout_)):
            assert_bits(x, y, what)


def test_device_stress_against_cpu():
    code, err, out = _run_port(["--trials", "3", "--seed", "1", "--device",
                                "cpu", "--against-cpu"])
    assert code == 0 and out == ["stress passed"]
    assert len(err) == 1 + 3 + 3
    assert all(line.endswith(" cpu bit-equal") for line in err[1:])


def test_device_stress_fails_on_a_wrong_result(monkeypatch):
    """A result off by one part in 2^20 fails its trial and the sweep."""
    orig = gt.gemm

    def off(*a, **k):
        out = orig(*a, **k)
        return out * (1 + 2.0 ** -20) if k.get("num_moduli") == 12 else out

    monkeypatch.setattr(gt, "gemm", off)
    code, err, out = _run_port(["--trials", "3", "--seed", "0", "--device",
                                "cpu"])
    assert code == 1 and out == ["1 FAILURES"]
    assert [line[6:10] for line in err[1:4]] == ["FAIL", "ok  ", "ok  "]


def test_device_stress_card_has_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_stress.main(["--trials", "1"])


def test_blas3_perf_on_the_cpu(tmp_path):
    out = tmp_path / "b3.csv"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = blas3_perf.main(["96", "96", "8", "--device", "cpu", "--reps",
                               "1", "--out", str(out)])
    assert res["diff"] == 0.0
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == blas3_perf.HEADER
    assert [r[0] for r in rows[1:]] == [
        "one gemm (A B^T)", "syr2k (G + G^T)", "naive 2-GEMM",
        "her2k (G + G^H)", "naive 2-ZGEMM"]
    for name, n, k, nu, ms, tflops in rows[1:]:
        assert (n, k, nu) == ("96", "96", "8")
        ms, tflops = float(ms), float(tflops)
        # the tool's flop convention: 2 n^2 k per real product, 8 per
        # complex one; syr2k, her2k and the naive forms count two
        per = (8.0 if "Z" in name or "her2k" in name else 2.0) * 96 ** 3
        count = 1 if name.startswith("one") else 2
        assert ms > 0 and np.isclose(tflops, count * per / (ms * 1e-3) / 1e12)
    text = buf.getvalue()
    assert "syr2k vs naive two-GEMM max abs diff (256^2): 0.000e+00" in text


def test_blas3_perf_check_raises(monkeypatch):
    """A syr2k one ulp off the naive form is a failure, not a print."""
    orig = gt.syr2k
    monkeypatch.setattr(gt, "syr2k", lambda *a, **k: orig(*a, **k) * (
        1 + 2.0 ** -52))
    with pytest.raises(AssertionError, match="differs from the naive"):
        blas3_perf.measure(32, 32, 8, reps=1, device="cpu",
                           log=io.StringIO())


def test_blas3_perf_card_has_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        blas3_perf.main(["32", "32", "8"])
