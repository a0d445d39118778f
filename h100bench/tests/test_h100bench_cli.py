"""The run command's outside: it refuses to run without a card or without
the program, and its result line has the contract's keys."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from h100bench import run
from h100bench_helpers import run_small, small_spec

COMMAND = [sys.executable, "-m", "h100bench.run", "--workload",
           "dgemm-int8-nu16.sq8192", "--seed", str(2 ** 33 + 1),
           "--seconds", "1", "--trace", "0"]


def test_exits_non_zero_with_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(COMMAND, cwd=run.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_exits_non_zero_with_only_the_benchmark(tmp_path):
    """A checkout that holds only BENCHMARK.json and h100bench/ cannot run:
    the program under test is missing."""
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "h100bench"),
                    tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("_out", "_cache"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(COMMAND, cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_result_line_has_the_contracts_keys():
    result = run_small(small_spec())
    line = json.dumps(result, allow_nan=False)
    assert list(json.loads(line)) == ["correct", "attempted", "failed",
                                      "metrics", "device", "checks"]
    assert set(result["metrics"]) == {"tflops", "call_ms_p95",
                                      "gflops_per_w", "peak_mem_gib",
                                      "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            m["unit"] == "GiB"          # no card memory on the CPU
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


def test_short_cells_report_the_short_metrics():
    result = run_small(small_spec("dgemm-int8-nu16.upd8192k512"))
    assert set(result["metrics"]) == {"tflops.short", "call_ms_p95.short",
                                      "gflops_per_w.short", "peak_mem_gib",
                                      "setup_s"}


def test_traced_result_adds_breakdown_and_the_layer_metrics():
    spec = small_spec("zgemm-int8-nu16.sq8192")
    result = run_small(spec, traced=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert result["correct"]
    # on the CPU no device operation runs: only the host's metric reads
    assert set(result["metrics"]) == {"entry.host_ms"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in result["breakdown"].values())
