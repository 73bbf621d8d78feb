"""On the card: a short run of each cell `BENCHMARK.json` lists, through
`run.py`, prints a correct result line (`python -m pytest portbench/tests
-m cuda`)."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.traffic import load_json

LISTED = [w["name"] for w in
          load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", LISTED)
def test_short_run_is_correct(card, name):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "3000000101", "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert "pods_per_s" in line["metrics"] and "setup_s" in line["metrics"]
