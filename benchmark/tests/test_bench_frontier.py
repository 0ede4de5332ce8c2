"""The cell portfolio-frontier on the CPU at a small size: its generator,
its plain reference and judge on lane-shared data, its control, the
faults its check must catch, and its two per-layer metrics."""

import itertools
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import control, harness, program_trace
from benchmark.tests.test_bench_control import FAULTS

CPU = torch.device("cpu")
NAME = "portfolio-frontier"
# the market cut to a size a test run holds, its widths kept (n = 100 k,
# m = n), at 8 points of the frontier
SMALL = {"k": 2, "n": 200, "lanes": 8, "dims": {"l": 200},
         "shapes": {"n_var": 202, "m": 200, "p": 3, "kkt_order": 405}}
SEEDS = [11, 2 ** 31 + 3, 987654321]


def small_cell():
    cell = harness.Cell(NAME)
    cell.cfg = {**cell.cfg, **SMALL}
    cell.traffic = {**cell.traffic, "batch": SMALL["lanes"]}
    return cell


def make(seed):
    cell = small_cell()
    gen = torch.Generator().manual_seed(seed)
    return cell.problem.make(cell.cfg, gen, SMALL["lanes"], CPU,
                             torch.float64)


def test_the_cell_names_its_configuration_and_traffic():
    cell = harness.Cell(NAME)
    assert cell.cfg["lanes"] == cell.traffic["batch"] == 100
    assert cell.traffic["entry"] == "batched_qp_solver"
    assert cell.traffic["inputs"] == "device"
    assert cell.chips == 1 and cell.cfg["reduced"] == []
    nv, m, p = cell.problem.shapes(cell.cfg)
    sh = cell.cfg["shapes"]
    assert (nv, m, p, nv + m + p) == (sh["n_var"], sh["m"], sh["p"],
                                      sh["kkt_order"]) == (1010, 1000, 11,
                                                           2021)
    g = cell.problem.gammas(cell.cfg, torch.float64, CPU)
    assert float(g[0]) == pytest.approx(0.1)
    assert float(g[-1]) == pytest.approx(10 ** 3.95)


def test_shapes_and_shared_market():
    d = make(7)
    nv, m, p = 202, 200, 3
    assert d["P"].shape == (nv, nv) and d["q"].shape == (8, nv)
    assert d["G"].shape == (m, nv) and d["h"].shape == (m,)
    assert d["A"].shape == (p, nv) and d["b"].shape == (p,)
    assert all(v.dtype == torch.float64 for v in d.values())
    # every lane is the same market at its own gamma
    g = small_cell().problem.gammas(small_cell().cfg, torch.float64, CPU)
    assert torch.allclose(d["q"] * g[:, None], d["q"][:1] * g[0],
                          rtol=1e-14, atol=0)


def test_the_market_is_portfolios_market():
    """The same generator state gives problems/portfolio.py's instance at
    gamma = 1 as the frontier's market."""
    cell = small_cell()
    port = harness.load_module(harness.BENCH / "problems" / "portfolio.py")
    gen = torch.Generator().manual_seed(3)
    one = port.make({**cell.cfg, "gamma": 1.0}, gen, 1, CPU, torch.float64)
    d = make(3)
    for k in ("P", "G", "h", "A", "b"):
        assert torch.equal(d[k], one[k][0])
    g = cell.problem.gammas(cell.cfg, torch.float64, CPU)
    assert torch.allclose(d["q"], one["q"] / g[:, None], rtol=1e-15, atol=0)


def test_determinism_by_seed():
    a, b, c = make(2 ** 31 + 5), make(2 ** 31 + 5), make(2 ** 31 + 6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["A"], c["A"])


def test_the_traffic_must_match_the_sweep():
    with pytest.raises(ValueError, match="8 lanes"):
        small_cell().problem.make(small_cell().cfg, torch.Generator(), 5,
                                  CPU, torch.float64)


def test_judge_accepts_the_references_answer_on_shared_data():
    cell = small_cell()
    d = make(4)
    tol = cell.cfg["tolerances"]
    out = cell.reference.solve(**d, tol=tol)
    assert out["status"] == ["optimal"] * SMALL["lanes"]
    j = cell.reference.judge(d, out, tol)
    assert max(j["residual"]) <= tol["feastol"]
    assert max(j["gap"]) <= 1.0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_judge_rejects_each_fault(fault):
    cell = small_cell()
    d = make(4)
    tol = cell.cfg["tolerances"]
    out = cell.reference.solve(**d, tol=tol)
    x, y, s, z = FAULTS[fault]((out["x"], out["y"], out["s"], out["z"]))
    j = cell.reference.judge(d, {"x": x, "y": y, "s": s, "z": z}, tol)
    assert max(j["residual"]) > tol["feastol"]


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_control_is_not_correct(seed):
    numbers, ok = control.control(small_cell(), seed, CPU)
    assert not ok
    assert numbers["not_optimal"] > 0


def test_float64_reference_in_the_programs_place_is_correct():
    numbers, ok = control.control(small_cell(), 5, CPU, dtype=torch.float64)
    assert ok, numbers


def _broken_batch(monkeypatch, fault):
    from kvxopt_tpu_torch import parallel
    real = parallel.batched_qp_solver

    def factory(*a, **k):
        solve = real(*a, **k)
        return lambda *args: FAULTS[fault](solve(*args))
    monkeypatch.setattr(parallel, "batched_qp_solver", factory)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_the_cell_fails_each_fault(monkeypatch, fault):
    _broken_batch(monkeypatch, fault)
    line = harness.run(small_cell(), 12, 0.2, False, time.perf_counter(),
                       device=CPU)
    assert line["correct"] is False, line["checks"]


def test_cpu_trace_run_reads_the_cells_metrics(monkeypatch):
    """harness.run with --trace 1 on the CPU, the device profile and the
    sync count replaced by stand-ins that make the same calls: every
    per-layer metric of the cell but the device's reads a number, and
    operand_mb_per_call reads one market and the lanes' q."""
    from benchmark import tracing
    from kvxopt_tpu_torch import trace

    def profiled(fn):
        t0 = time.perf_counter()
        fn()
        return SimpleNamespace(wall=time.perf_counter() - t0, busy=0.0,
                               why="CPU", device_ops=[], idle_gaps=[])

    def count_syncs(fn):
        fn()
        return 1
    monkeypatch.setattr(tracing, "profiled", profiled)
    monkeypatch.setattr(tracing, "count_syncs", count_syncs)
    monkeypatch.setattr(trace, "_seq", itertools.count())
    trace.clear()
    cell = small_cell()
    try:
        line = harness.run(cell, 2 ** 31 + 13, 0.3, True,
                           time.perf_counter(), device=CPU)
    finally:
        trace.clear()
    assert line["correct"] is True and line["failed"] == 0
    names = {m["name"] for m in cell.metrics("per_layer")}
    assert {"operand_mb_per_call.frontier",
            "lane_occupancy.frontier"} <= names
    missing = names - set(line["metrics"]) - {"device_idle_share.batch"}
    assert not missing
    nv, m, p = 202, 200, 3
    market = 8 * (nv * nv + m * nv + m + p * nv + p)
    assert line["metrics"]["operand_mb_per_call.frontier"]["value"] == \
        pytest.approx((market + 8 * 8 * nv) / 1e6)
    assert 0 < line["metrics"]["lane_occupancy.frontier"]["value"] <= 100


def _rec(steps, operand=None):
    counters = {"ipm.steps": steps}
    if operand is not None:
        counters["operand_bytes"] = operand
    return SimpleNamespace(seq=0, name="batched_qp", start_ns=0, end_ns=1,
                           spans={}, counters=counters)


def _run(iterations):
    cell = SimpleNamespace(traffic={"trace_calls": 1, "sync_calls": 1})
    return {"cell": cell, "readings": {},
            "calls": [{"seconds": 1.0, "iterations": its}
                      for its in iterations]}


def test_readers_on_synthetic_records(monkeypatch):
    """Two window calls of 4 lanes (steps 5 and 10), then the traced
    run's untraced call and its two stretches."""
    recs = [_rec(99, 7)] + [_rec(5, 2 * 10 ** 6), _rec(10, 4 * 10 ** 6)] + \
        [_rec(99, 9)] * 3
    monkeypatch.setattr(program_trace, "records", lambda: recs)
    run = _run([[5, 5, 3, 2], [10, 6, 4, 4]])
    occ = harness.metric_reader("lane_occupancy.frontier").read(run)
    assert occ == pytest.approx(100.0 * (15 + 24) / (4 * 5 + 4 * 10))
    mb = harness.metric_reader("operand_mb_per_call.frontier").read(run)
    assert mb == pytest.approx(3.0)


def test_readers_find_nothing_without_the_counters(monkeypatch):
    """The parent's program keeps no operand_bytes: nothing to read;
    and nothing where no step was taken."""
    recs = [_rec(0)] * 5
    monkeypatch.setattr(program_trace, "records", lambda: recs)
    run = _run([[0, 0], [0, 0]])
    assert harness.metric_reader("operand_mb_per_call.frontier").read(
        run) is None
    assert harness.metric_reader("lane_occupancy.frontier").read(run) is None
    monkeypatch.setattr(program_trace, "records", lambda: None)
    assert harness.metric_reader("lane_occupancy.frontier").read(run) is None
