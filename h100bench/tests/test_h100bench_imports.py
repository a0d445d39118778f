"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's), and
the plain references import nothing of the program."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from h100bench import run
from h100bench_helpers import run_small, small_spec

HERE = os.path.join(run.ROOT, "h100bench")


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    for dirpath, dirs, files in os.walk(os.path.join(HERE, sub)):
        dirs[:] = [d for d in dirs if d not in ("tests", "__pycache__",
                                                "_out", "_cache")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_the_benchmark_runs_imports_jax():
    paths = list(sources())
    assert len(paths) >= 15
    for path in paths:
        assert not top_level_imports(path) & set(run.FORBIDDEN), path


def test_references_import_nothing_of_the_program():
    paths = list(sources("reference"))
    assert paths
    for path in paths:
        names = top_level_imports(path)
        assert "gemmul8_tpu_torch" not in names, path
        assert names <= {"__future__", "torch", "numpy", "math"}, path


def test_a_run_holds_no_jax_module():
    code = ("import json, sys\n"
            "sys.path.insert(0, 'h100bench/tests')\n"
            "from h100bench_helpers import run_small, small_spec\n"
            "r = run_small(small_spec('zgemm-int8-nu16.sq8192'))\n"
            "names = {m.split('.')[0] for m in sys.modules}\n"
            "print(json.dumps(sorted(names)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert "gemmul8_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


@pytest.mark.parametrize("planted", ["reference/gemm.py",
                                     "metrics/entry.host_ms.py"])
def test_a_run_whose_reference_or_reader_loads_jax_is_refused(
        tmp_path, monkeypatch, planted):
    """The check of sys.modules comes after the reference and the metrics'
    readers have run: one of them that loads a module named `jax` (here a
    stub) ends the run with no result."""
    stubs = tmp_path / "stubs" / "jax"
    stubs.mkdir(parents=True)
    (stubs / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "stubs"))
    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "h100bench",
                    ignore=shutil.ignore_patterns("_out", "_cache",
                                                  "__pycache__"))
    path = root / "h100bench" / planted
    path.write_text(path.read_text() + "\nimport jax  # noqa: E402,F401\n")
    spec = small_spec("dgemm-int8-nu16.sq8192")
    call = run.entry_module(spec).make(spec["config"], spec["traffic"], "cpu")
    spec["root"] = str(root)
    try:
        with pytest.raises(SystemExit, match="jax"):
            run_small(spec, call=call, traced=planted.startswith("metrics"))
    finally:
        sys.modules.pop("jax", None)
