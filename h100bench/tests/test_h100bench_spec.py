"""BENCHMARK.json keeps to the contract's form, and the harness finds a
configuration, a mix, a metric and a cell by name: a new one added as files
and entries alone is picked up without editing any file already there."""
import json
import os
import re
import shutil

import pytest

from h100bench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["h100bench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len(b["command"]) <= 32
    assert all(LINE.match(w) for w in b["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_lines():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert LINE.match(m["layer"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for w in b["workloads"]:
        spec = run.cell_spec(w["name"])
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"], w["name"]
        assert spec["limits"]["gap"] > 0
        # each per-layer metric moves an end-to-end metric the cell reports
        assert all(m["moves"] in names for m in spec["per_layer"])


def test_bounds_within_the_contract():
    for m in bench()["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")


def test_every_per_layer_metric_finds_its_reader():
    """metrics/<name>.py, or for `<name>.short` the file of `<name>`: one
    reader for a quantity, whichever end-to-end metric it moves."""
    for m in bench()["per_layer"]:
        spec = run.cell_spec(m["workloads"][0])
        reader = run.metric_reader(spec, m["name"])
        stem = m["name"].removesuffix(".short")
        assert reader.__file__ == os.path.join(ROOT, "h100bench", "metrics",
                                               stem + ".py"), m["name"]
        assert callable(reader.read)


def test_config_files_match_their_entries():
    for c in bench()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert c["file"].startswith("h100bench/")
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        for key in ("dtype", "backend", "num_moduli", "fastmode", "entry",
                    "reference", "control_dtype", "guarantees"):
            assert key in config


def test_new_config_mix_metric_and_cell_are_found_by_adding_files(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a metric and
    a cell as new files and new entries of BENCHMARK.json: every file that
    was there is left as it was, and the harness finds the new ones."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "h100bench"), root / "h100bench",
                    ignore=shutil.ignore_patterns("_out", "_cache",
                                                  "__pycache__"))
    b = bench()
    before = {p: p.read_bytes() for p in (root / "h100bench").rglob("*")
              if p.is_file()}
    h = root / "h100bench"
    config = json.loads((h / "configs" / "dgemm-int8-nu16.json").read_text())
    config.update(name="sgemm-int8-nu8", dtype="float32", num_moduli=8,
                  control_dtype="float32")
    (h / "configs" / "sgemm-int8-nu8.json").write_text(json.dumps(config))
    mix = json.loads((h / "traffic" / "sq4096.json").read_text())
    mix.update(m=2048, n=2048, k=2048)
    (h / "traffic" / "sq2048.json").write_text(json.dumps(mix))
    (h / "limits" / "sgemm-int8-nu8.sq2048.json").write_text(
        json.dumps({"gap": 1e-5}))
    (h / "metrics" / "entry.calls.py").write_text(
        "def read(ctx):\n    return len(ctx.host_ms)\n")
    b["configs"].append({"name": "sgemm-int8-nu8", "source": "x",
                         "file": "h100bench/configs/sgemm-int8-nu8.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "sgemm-int8-nu8.sq2048",
                           "config": "sgemm-int8-nu8", "traffic": "sq2048",
                           "chips": 1, "why": "x"})
    next(m for m in b["end_to_end"]
         if m["name"] == "tflops")["workloads"].append("sgemm-int8-nu8.sq2048")
    b["per_layer"].append({"name": "entry.calls", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "entry", "moves": "tflops",
                           "workloads": ["sgemm-int8-nu8.sq2048"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    spec = run.cell_spec("sgemm-int8-nu8.sq2048", root=str(root))
    assert {m["name"] for m in spec["end_to_end"]} == {
        "tflops", "peak_mem_gib", "setup_s"}
    assert spec["config"]["dtype"] == "float32"
    assert spec["traffic"]["m"] == 2048
    assert [m["name"] for m in spec["per_layer"]] == ["entry.calls"]
    reader = run.metric_reader(spec, "entry.calls")
    assert reader.read(type("Ctx", (), {"host_ms": [1.0, 2.0]})) == 2
    assert run.entry_module(spec).make and run.reference_module(spec).max_gap
    for p, data in before.items():
        assert p.read_bytes() == data, p
    # an old cell is found as before
    assert run.cell_spec("dgemm-int8-nu16.sq8192",
                         root=str(root))["traffic"]["m"] == 8192


def test_unknown_workload_exits():
    with pytest.raises(SystemExit):
        run.cell_spec("no-such.cell")
