"""On the card: a short run of each cell is correct, and the float32
control is not.  Run on a machine with a CUDA device:

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in
         harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(name):
    _card()
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "3", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert list(line)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_float32_control_fails_on_the_card(name):
    from benchmark import control
    cell = harness.Cell(name)
    cell.traffic = dict(cell.traffic, check_calls=1)
    numbers, ok = control.control(cell, 2147483660, _card())
    assert not ok, numbers
