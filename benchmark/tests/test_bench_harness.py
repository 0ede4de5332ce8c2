"""The harness's arithmetic, its output line and its refusals, on the
CPU at a small size."""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import harness

CPU = torch.device("cpu")
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device",
             "readings", "checks"]


@pytest.mark.parametrize("pct", [0, 5, 50, 95, 100])
@pytest.mark.parametrize("n", [1, 2, 7, 400])
def test_percentile_is_numpys_linear(pct, n):
    v = list(np.random.default_rng(n).random(n))
    assert harness.percentile(v, pct) == pytest.approx(
        float(np.percentile(v, pct)))


def test_percentile_of_nothing():
    assert math.isnan(harness.percentile([], 95))


def test_call_seed_takes_large_seeds_and_separates_streams():
    s = [harness.call_seed(2 ** 31 + 5, st, i) for st in range(4)
         for i in range(50)]
    assert len(set(s)) == len(s)
    assert all(0 <= x < 2 ** 63 for x in s)
    assert harness.call_seed(3, 0, 9) == harness.call_seed(3, 0, 9)
    assert harness.call_seed(-1, 0, 0) >= 0


def test_reservoir_is_uniform_and_seeded():
    counts = np.zeros(20)
    for r in range(2000):
        res = harness.Reservoir(4, np.random.default_rng([r, 2]))
        for i in range(20):
            res.offer(i)
        assert len(res.items) == 4
        counts[res.items] += 1
    assert counts.min() > 0.7 * 400 and counts.max() < 1.3 * 400
    a, b = (harness.Reservoir(3, np.random.default_rng([9, 2]))
            for _ in range(2))
    for i in range(100):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items


def _calls():
    return [{"seconds": 0.2, "optimal": [True, True, False],
             "iterations": [9, 11, 100]},
            {"seconds": 0.3, "optimal": [True, True, True],
             "iterations": [10, 10, 12]}]


def _metric(name):
    return harness.metric_reader(name)


def test_window_arithmetic():
    run = {"calls": _calls(), "setup_s": 4.5}
    assert _metric("solves_per_s").read(run) == pytest.approx(5 / 0.5)
    assert _metric("call_p95_ms").read(run) == pytest.approx(
        1e3 * (0.2 + 0.95 * 0.1))
    assert _metric("setup_s").read(run) == 4.5
    assert _metric("iters_per_solve").read(run) == pytest.approx(52 / 5)
    # a call counts its largest lane: 100 + 12 steps in 0.5 s
    assert _metric("ms_per_ipm_iter").read(run) == pytest.approx(
        1e3 * 0.5 / 112)


def test_trace_readers():
    from types import SimpleNamespace
    prof = SimpleNamespace(wall=2.0, busy=0.5, why=None)
    run = {"readings": {"profile": prof, "syncs": 30,
                        "sync_iterations": [[4, 6], [5]]}}
    assert _metric("device_idle_share").read(run) == pytest.approx(75.0)
    # a call counts its largest lane: 6 + 5 steps
    assert _metric("host_syncs_per_iter").read(run) == pytest.approx(30 / 11)
    prof.why = "trace lost 3 of 900 kernels"
    assert _metric("device_idle_share").read(run) is None


def test_union_and_gaps():
    from benchmark import tracing
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert tracing.union(iv) == 4
    assert tracing.gaps(iv, -1, 8) == [(-1, 0), (3, 5), (6, 8)]
    assert tracing.gaps(iv, 0, 6) == [(3, 5)]


def test_innermost_host_event():
    from types import SimpleNamespace as E

    from benchmark import tracing
    ev = [E(name="outer", start=0, end=10), E(name="inner", start=2, end=4),
          E(name="late", start=8, end=9)]
    assert tracing._innermost(ev, [1, 3, 5, 8.5, 11]) == [
        "outer", "inner", "outer", "late", None]


def test_spec_names_its_files():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for w in spec["workloads"]:
        cell = harness.Cell(w["name"], spec)
        assert cell.limits == {
            "not_optimal": 0, "residual": cell.cfg["tolerances"]["feastol"]}
        for m in cell.metrics("end_to_end") + cell.metrics("per_layer"):
            assert callable(harness.metric_reader(m["name"]).read)
    for c in spec["configs"]:
        assert (harness.ROOT / c["file"]).exists()


def test_metric_reader_falls_back_to_the_name_before_the_dot():
    assert harness.metric_reader("solves_per_s.single").__doc__ == \
        harness.metric_reader("solves_per_s").__doc__
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such_metric.single")


def test_a_limits_file_overrides_the_configurations_limits(tmp_path,
                                                          monkeypatch):
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark" / "limits").mkdir(exist_ok=True)
    (tmp_path / "benchmark" / "limits" / "portfolio-b32.json").write_text(
        '{"residual": 3e-8}')
    monkeypatch.setattr(harness, "BENCH", tmp_path / "benchmark")
    assert harness.Cell("portfolio-b32").limits == {"not_optimal": 0,
                                                    "residual": 3e-8}
    assert harness.Cell("portfolio-single").limits["residual"] == 1e-7


def test_an_answer_off_the_card_fails_the_run(small_cell):
    """A single cell whose program answers on the CPU (as solvers.qp does
    below its dispatch threshold) while the run is on the card."""
    cell = small_cell("portfolio-single")
    entry = harness.load_module(harness.BENCH / "entries" / "qp.py")
    call, result = entry.prepare(cell.cfg["dims"])
    card = torch.device("cuda", 0)
    with pytest.raises(harness.OffCard):
        harness.run_window(cell, call, result, 5, 0.1, card, lambda: None)
    harness.require_on(CPU, {"x": torch.zeros(3)})
    with pytest.raises(harness.OffCard):
        harness.require_on(card, {"x": torch.zeros(3)})


@pytest.mark.parametrize("name", ["portfolio-b32", "portfolio-single"])
def test_trace0_line_has_the_contract_keys(small_cell, name):
    cell = small_cell(name)
    line = harness.run(cell, 2 ** 31 + 11, 0.3, False, time.perf_counter(),
                       device=CPU)
    assert list(line) == LINE_KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    e2e = {m["name"] for m in cell.metrics("end_to_end")}
    assert set(line["metrics"]) == e2e and "setup_s" in e2e and len(e2e) == 3
    assert set(line["checks"]) == {"not_optimal", "residual"}
    assert line["readings"]["gap"] <= 1.0
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    json.dumps(line)


def _run_cli(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "portfolio-b32",
         "--seed", "3", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_fails_and_prints_no_result():
    r = _run_cli(harness.ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run_cli(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
