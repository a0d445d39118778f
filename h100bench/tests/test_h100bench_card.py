"""On an H100: a short run of each cell, as the driver starts it, comes out
correct with every metric it owes. Run on the card with
`python -m pytest h100bench/tests/test_h100bench_card.py`."""
import json
import subprocess
import sys

import pytest

from h100bench import run

CELLS = [w["name"] for w in run.load_json(
    f"{run.ROOT}/BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, traced):
    out = subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload", cell,
         "--seed", str(2 ** 32 + 17), "--seconds", "2", "--trace",
         str(traced)], cwd=run.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"], result["checks"]
    spec = run.cell_spec(cell)
    owed = spec["per_layer" if traced else "end_to_end"]
    assert set(result["metrics"]) == {m["name"] for m in owed}
    assert result["device"]["platform"] == "gpu"
