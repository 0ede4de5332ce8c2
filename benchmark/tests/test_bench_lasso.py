"""The cell lasso-b32 and its two metrics of the KKT strategy's fallback
(fallback_lane_share, fallback_ms_per_iter): the readers on synthetic
records, where they find nothing, the cell's files, and a CPU run of the
harness at SMALL size."""

import itertools
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, program_trace

CPU = torch.device("cpu")
MS = 1_000_000
NEW = ("fallback_lane_share.lasso", "fallback_ms_per_iter.lasso")


def rec(seq, ms, steps, lanes=None, fallback_ms=0):
    """A record of a call of `ms` milliseconds with `steps` ipm.steps, the
    counter kkt.fallback_lanes (absent where lanes is None) and the self
    time of its kkt.fallback spans."""
    spans = {"batched_qp": (1, ms * MS, MS), "ipm": (1, (ms - 1) * MS, 0)}
    if fallback_ms:
        spans["kkt.fallback"] = (5, fallback_ms * MS, fallback_ms * MS)
    counters = {"ipm.steps": steps}
    if lanes is not None:
        counters["kkt.fallback_lanes"] = lanes
    return SimpleNamespace(seq=seq, name="batched_qp", start_ns=0,
                           end_ns=ms * MS, spans=spans, counters=counters)


def run_of(calls, trace=True):
    cell = SimpleNamespace(traffic={"warm_calls": 2, "trace_calls": 3,
                                    "sync_calls": 2})
    return {"cell": cell, "readings": {} if trace else None,
            "calls": [{"seconds": s, "iterations": its} for s, its in calls]}


def read(name, run):
    return harness.metric_reader(name).read(run)


def synthetic(monkeypatch, lanes=(3, 0), fallback_ms=(12, 0)):
    """Two warm calls, a window of two calls of 4 lanes (9 and 7 steps),
    then the 6 calls of the traced stretches."""
    window = [rec(2, 99, 9, lanes[0], fallback_ms[0]),
              rec(3, 79, 7, lanes[1], fallback_ms[1])]
    tail = [rec(i, 500, 50, 40, 300) for i in range(4, 10)]
    recs = [rec(0, 900, 9, 9, 9), rec(1, 90, 9, 9, 9)] + window + tail
    monkeypatch.setattr(program_trace, "records", lambda: recs)
    return run_of([(0.1, [8, 8, 6, 8]), (0.08, [6, 6, 6, 6])])


def test_readers_on_synthetic_records(monkeypatch):
    run = synthetic(monkeypatch)
    # 3 lanes on the fallback of 8 + 8 + 6 + 8 + 4 * 6 = 54 lane-steps
    assert read("fallback_lane_share.lasso", run) == pytest.approx(
        100 * 3 / 54)
    # 12 ms of fallback over 9 + 7 steps
    assert read("fallback_ms_per_iter.lasso", run) == pytest.approx(0.75)


def test_a_window_without_fallback_reads_zero(monkeypatch):
    run = synthetic(monkeypatch, lanes=(0, 0), fallback_ms=(0, 0))
    for m in NEW:
        assert read(m, run) == 0.0, m


def test_nothing_to_read_without_the_counter(monkeypatch):
    """A program without the fallback keeps no kkt.fallback_lanes."""
    run = synthetic(monkeypatch, lanes=(None, None), fallback_ms=(0, 0))
    for m in NEW:
        assert read(m, run) is None, m
    monkeypatch.setattr(program_trace, "records", lambda: None)
    for m in NEW:
        assert read(m, run) is None, m


def test_nothing_to_read_where_the_records_are_too_few(monkeypatch):
    run = synthetic(monkeypatch)
    recs = program_trace.records()
    monkeypatch.setattr(program_trace, "records", lambda: recs[-7:])
    for m in NEW:
        assert read(m, run) is None, m


def test_the_cell_loads_with_lasso_inputs():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.Cell("lasso-b32", spec)
    assert cell.cfg["problem"] == "lasso" and cell.chips == 1
    assert cell.problem.__file__.endswith("problems/lasso.py")
    assert cell.reference.__file__.endswith("reference/qp_orthant.py")
    assert cell.traffic["entry"] == "batched_qp_solver"
    assert cell.traffic["batch"] == 32
    assert cell.limits == {"not_optimal": 0, "residual": 1e-7}
    ours = {m["name"] for m in cell.metrics("per_layer")}
    assert set(NEW) <= ours
    assert {m["name"] for m in cell.metrics("end_to_end")} == {
        "solves_per_s.batch", "call_p95_ms.batch", "setup_s"}
    for name in NEW:
        m = next(m for m in spec["per_layer"] if m["name"] == name)
        assert m["workloads"] == ["lasso-b32"]
        assert m["moves"] == "solves_per_s.batch"


def test_the_cells_inputs_are_lassos(small_cell):
    cell = small_cell("lasso-b32")
    d = harness.make_inputs(cell, 2 ** 31 + 7, harness.WINDOW, 0, CPU)
    n, m = cell.cfg["n"], cell.cfg["m"]
    nv, mi, p = cell.problem.shapes(cell.cfg)
    assert d["P"].shape == (32, nv, nv) and d["A"].shape == (32, p, nv)
    assert d["G"].shape == (32, mi, nv) and mi == 2 * n and p == m
    # A = [A_d, -I, 0]: each lane its own A_d
    assert torch.equal(d["A"][0, :, n:n + m], -torch.eye(m).double())
    assert not torch.equal(d["A"][0, :, :n], d["A"][1, :, :n])
    again = harness.make_inputs(cell, 2 ** 31 + 7, harness.WINDOW, 0, CPU)
    assert all(torch.equal(d[k], again[k]) for k in d)


def test_cpu_trace_run_reads_the_fallback(small_cell, monkeypatch):
    """harness.run with --trace 1 at SMALL size on the CPU, the device
    profile and the sync count replaced by stand-ins that make the same
    calls: the run is correct and both new metrics read a number, the
    share above 0."""
    from benchmark import tracing
    from kvxopt_tpu_torch import trace

    def profiled(fn):
        t0 = time.perf_counter()
        fn()
        return SimpleNamespace(wall=time.perf_counter() - t0, busy=0.0,
                               why="CPU", device_ops=[], idle_gaps=[])

    def count_syncs(fn):
        fn()
        return 0
    monkeypatch.setattr(tracing, "profiled", profiled)
    monkeypatch.setattr(tracing, "count_syncs", count_syncs)
    monkeypatch.setattr(trace, "_seq", itertools.count())
    trace.clear()
    cell = small_cell("lasso-b32")
    try:
        # at SMALL size about one call in six holds a lane that breaks
        # chol2 down; this seed's window call does
        line = harness.run(cell, 2 ** 31 + 6, 1.0, True, time.perf_counter(),
                           device=CPU)
    finally:
        trace.clear()
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["fallback_lane_share.lasso"]["value"] > 0
    assert line["metrics"]["fallback_ms_per_iter.lasso"]["value"] > 0
