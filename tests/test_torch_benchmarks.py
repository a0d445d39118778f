"""The port's benchmark probes (gemmul8_tpu_torch/probes: accuracy, flops,
big_flops, power) against the JAX package's harnesses (benchmarks/*.py),
the JAX ones run in this process through runpy on the CPU.

- accuracy: the same sweep (k = 1024, phi 0.5 and 4, nu 9 and 16 on f64;
  nu 8 on f32, for the bf16x9 rows) gives the same k, phi, method and nu columns; the emulated rows
  (oz2-*, os1-int8) are bit-equal. The native rows (torch.matmul against
  numpy's matmul, both f64 or f32 BLAS with their own summation orders)
  and the bf16x9 rows (the port's is held to 2k 2^-24 |A||B| of the JAX
  package's, tests/test_torch_compare.py) agree within a factor of 4 and
  stay under the dot-product bound k u max(|A||B| / |AB|).
- flops: the same header, methods and nu, and each row's TFLOP/s is
  2mnk (8mnk complex) over its seconds, in both.
- big_flops: the stripe widths at the defaults are JAX's pick_blocking's.
- power: nvidia-smi's power.draw output parsed on fixtures; rapl_watts and
  the trapezoid energy equal benchmarks/power.py's on the fixtures of
  tests/test_power_parsers.py; a sampler whose reads raise keeps its
  thread alive and counts the errors; the streaming sampler is one
  process, read a line a sample, and is stopped with the run.
"""
import csv
import glob
import math
import os
import stat
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu import core as jcore
from gemmul8_tpu_torch.probes import accuracy, big_flops, flops, power
from torch_example_helpers import ROOT, run_script

sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
import power as jpower  # noqa: E402

ACC_CASES = {"f64": ["--ks", "1024", "--phis", "0.5,4", "--nus", "9,16"],
             "f32": ["--dtype", "f32", "--ks", "1024", "--phis", "0.5,4",
                     "--nus", "8"]}


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module", params=list(ACC_CASES))
def acc_tables(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("acc")
    args = ACC_CASES[request.param]
    run_script("benchmarks/accuracy.py",
               ["--cpu", *args, "--out", str(tmp / "jax.csv")])
    accuracy.main(["--device", "cpu", *args, "--out", str(tmp / "port.csv")])
    return request.param, _read(tmp / "jax.csv"), _read(tmp / "port.csv")


def test_accuracy_same_rows(acc_tables):
    dtype, jt, pt = acc_tables
    assert pt[0] == jt[0] == accuracy.HEADER
    assert [r[:4] for r in pt] == [r[:4] for r in jt]
    methods = {r[2] for r in pt[1:]}
    assert methods == ({"native", "os1-int8", "oz2-fast", "oz2-robust"}
                       if dtype == "f64" else
                       {"native", "bf16x9", "oz2-fast", "oz2-robust"})


def test_accuracy_emulated_rows_bit_equal(acc_tables):
    _, jt, pt = acc_tables
    rows = [(p, j) for p, j in zip(pt[1:], jt[1:])
            if p[2].startswith("oz2-") or p[2] == "os1-int8"]
    assert rows
    for p, j in rows:
        assert p[4:] == j[4:], (p, j)     # the same float repr: same bits


def test_accuracy_native_and_bf16x9_within_tolerance(acc_tables):
    dtype, jt, pt = acc_tables
    u = 2.0 ** -53 if dtype == "f64" else 2.0 ** -24
    np_dtype = accuracy.NP_DTYPES[dtype]
    rows = [(p, j) for p, j in zip(pt[1:], jt[1:])
            if p[2] in ("native", "bf16x9")]
    assert rows
    for p, j in rows:
        k, phi = int(p[0]), float(p[1])
        a = accuracy.gen(np.random.default_rng(12345 + k), 128, k, phi,
                         np_dtype).astype(np.float64)
        b = accuracy.gen(np.random.default_rng(54321 + k), k, 128, phi,
                         np_dtype).astype(np.float64)
        bound = 2 * k * u * np.max(np.abs(a) @ np.abs(b) / np.abs(a @ b))
        for row in (p, j):
            assert float(row[4]) <= bound and float(row[5]) <= bound, (
                row, bound)
        # the medians, a stable statistic, within a factor of 2
        x, y = float(p[5]), float(j[5])
        assert x <= 2 * y and y <= 2 * x, (p, j)


@pytest.fixture(scope="module")
def flops_tables(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flops")
    cwd = os.getcwd()
    os.chdir(tmp)                 # the JAX harness writes into the cwd
    try:
        run_script("benchmarks/flops.py",
                   ["--cpu", "--sizes", "64", "--nu", "8", "--iters", "1"])
    finally:
        os.chdir(cwd)
    (jax_csv,) = glob.glob(str(tmp / "oz2_results_INT8_f64_flops_*.csv"))
    flops.main(["--device", "cpu", "--sizes", "64", "--nu", "8", "--iters",
                "1", "--phases", "--out", str(tmp / "port.csv")])
    return _read(jax_csv), _read(tmp / "port.csv")


def test_flops_same_header_methods_and_nu(flops_tables):
    jt, pt = flops_tables
    assert pt[0] == jt[0] == flops.HEADER
    assert [(r[0], r[1], r[2]) for r in pt[1:]] == \
        [(r[0], r[1], r[2]) for r in jt[1:]]
    # the port's oz2-fast row carries the four phases (seconds, > 0)
    (fast,) = [r for r in pt[1:] if r[1] == "oz2-fast"]
    assert all(float(x) > 0 for x in fast[5:])


def test_flops_arithmetic(flops_tables):
    for table in flops_tables:
        for size, method, _, sec, tflops, *_ in table[1:]:
            n = int(size)
            assert math.isclose(float(tflops),
                                2.0 * n ** 3 / float(sec) / 1e12,
                                rel_tol=1e-12), method


def test_flops_complex_rows(tmp_path):
    out = flops.main(["--device", "cpu", "--dtype", "c128", "--sizes",
                      "32", "--nu", "8", "--iters", "1", "--out",
                      str(tmp_path / "c.csv")])
    rows = out["rows"]
    assert [r[1] for r in rows] == ["native", "oz2-fast"]
    for r in rows:
        assert math.isclose(r[4], 8.0 * 32 ** 3 / r[3] / 1e12, rel_tol=1e-12)


def test_flops_os1_skip_only_past_free_memory():
    need = flops.os1_work_bytes(4096, 4096, 4096, 8, 8)
    assert need < 80 * (1 << 30) // 4      # fits the card at 4096
    assert flops.free_bytes(torch.device("cpu")) > need


def test_big_flops_blocking_is_jax_pick_blocking():
    want = jcore.pick_blocking(16384, 16384, 16384, 16, jnp.float64,
                               budget_bytes=8 << 30)
    assert big_flops.blocking(16384, 16, 8.0) == tuple(want)
    assert want[1] is not None and want[1] < 16384     # it stripes


def test_big_flops_needs_the_card():
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        big_flops.main([])


@pytest.mark.parametrize("text,want", [
    ("312.45", 312.45), ("312.45\n", 312.45), ("312.45 W", 312.45),
    ("  98.10 W  \n", 98.1), ("[N/A]", float("nan")),
    ("[Not Supported]", float("nan")), ("", float("nan")),
    ("100.5\n200.25\n", 300.75), ("100.5\n[N/A]\n", float("nan")),
])
def test_parse_nvidia_smi_power(text, want):
    got = power.parse_nvidia_smi_power(text)
    assert (math.isnan(got) and math.isnan(want)) or got == want


def test_rapl_watts_equals_the_jax_harness():
    # tests/test_power_parsers.py's fixtures, and a few more
    for e0, e1, dt in ((1_000_000, 2_000_000, 0.1), (10_000_000, 5_000, 0.1),
                       (5, 5, 0.0), (123_456, 987_654_321, 0.37)):
        got, want = power.rapl_watts(e0, e1, dt), jpower.rapl_watts(e0, e1,
                                                                     dt)
        assert (math.isnan(got) and math.isnan(want)) or got == want


def test_trapezoid_energy_equals_the_jax_harness():
    rng = np.random.default_rng(0)
    ts = np.cumsum(rng.random(50) * 0.2)
    ws = 300 + 50 * rng.random(50)
    ws[[3, 17, 40]] = np.nan                 # failed reads
    samples = list(zip(ts.tolist(), ws.tolist()))
    # benchmarks/power.py's integral, as its main() computes it
    snap = [s for s in list(samples) if s[1] == s[1]]
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    t = np.array([s[0] for s in snap])
    w = np.array([s[1] for s in snap])
    want = float(trapezoid(w, t))
    joules, watts = power.energy(samples)
    assert joules == want
    assert watts == want / (t[-1] - t[0])
    assert all(math.isnan(x) for x in power.energy(samples[:1]))


class _Flaky:
    """A sampler whose every other read raises."""
    paced = False

    def __init__(self):
        self.n = 0

    def sample(self):
        self.n += 1
        if self.n % 2:
            raise OSError("transient read failure")
        return 250.0

    def close(self):
        pass


def test_failed_reads_keep_the_thread_alive():
    poller = power.Poller(_Flaky(), 0.005).start()
    time.sleep(0.3)
    assert poller._thread.is_alive()
    samples = poller.stop()
    assert not poller._thread.is_alive()
    assert poller.errors >= 5
    good = [w for _, w in samples if w == w]
    assert len(good) >= 5 and set(good) == {250.0}
    # reads went on after the first error
    first_err = next(i for i, (_, w) in enumerate(samples) if w != w)
    assert any(w == w for _, w in samples[first_err:])


@pytest.fixture
def fake_smi(tmp_path, monkeypatch):
    """An `nvidia-smi` on PATH that answers the power.draw query: one line,
    or with -lms a line every period until it is stopped; it logs each
    start."""
    log = tmp_path / "starts"
    script = tmp_path / "nvidia-smi"
    script.write_text(f"""#!/bin/sh
echo "$@" >> {log}
case "$*" in
  *-lms*) while true; do echo "123.5"; sleep 0.01; done ;;
  *) echo "123.5" ;;
esac
""")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}"
                       f"{os.environ.get('PATH', '')}")
    return log


def test_streaming_sampler_is_one_process(fake_smi):
    sampler, source = power.pick_sampler(0, 0.01)
    assert source == "nvidia-smi"
    poller = power.Poller(sampler, 0.01).start()
    time.sleep(0.3)
    samples = poller.stop()
    assert sampler.proc.poll() is not None           # stopped with the run
    assert poller.errors == 0
    assert len(samples) >= 5 and {w for _, w in samples} == {123.5}
    starts = fake_smi.read_text().splitlines()
    # one availability query, then one streaming process
    assert len(starts) == 2
    assert "-lms 10" in starts[1] and "-i 0" in starts[1]
    assert "--query-gpu=power.draw" in starts[1]
