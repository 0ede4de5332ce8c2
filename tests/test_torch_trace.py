"""kvxopt_tpu_torch.trace: one record per top-level QP call, its spans'
self times, its counters (ipm.steps, h2d_bytes), the recorder off, and
the spans in options['profile']'s trace and under trace.annotate()."""

import json

import numpy as np
import pytest
import torch

from kvxopt_tpu_torch import ConeDims, config, parallel, solvers, trace

B, N, M = 4, 8, 16
INNER = ("ipm", "kkt.factor", "kkt.solve", "cone", "sync")


@pytest.fixture(autouse=True)
def _cpu():
    trace.clear()
    with config.using_device("cpu"):
        yield
    trace.enable(True)
    solvers.options.pop("profile", None)


def qp_data(seed=0, batch=None):
    """P, q, G, h, A, b of a feasible QP, or of `batch` of them."""
    rng = np.random.default_rng(seed)

    def one():
        F = rng.standard_normal((N, N))
        G = rng.standard_normal((M, N))
        x0 = rng.standard_normal(N)
        A = rng.standard_normal((2, N))
        return (F @ F.T + np.eye(N), rng.standard_normal(N), G,
                G @ x0 + rng.uniform(0.5, 1.5, M), A, A @ x0)
    if batch is None:
        return one()
    return tuple(np.stack(a) for a in zip(*(one() for _ in range(batch))))


def solve_qp(**kw):
    r = solvers.qp(*qp_data(), **kw)
    return r, r["iterations"], [r[k] for k in "xysz"]


def solve_batch(**kw):
    data = [torch.as_tensor(a) for a in qp_data(batch=B)]
    out = parallel.batched_qp_solver(ConeDims(l=M), **kw)(*data)
    return out, int((out[4] - 1).max()), list(out[:4])


def solve_seq(**kw):
    data = [torch.as_tensor(a) for a in qp_data(batch=B)]
    out = parallel.batched_qp_solver_seq(ConeDims(l=M), "chol2",
                                         group=2)(*data)
    return out, int((out[4] - 1).max()), list(out[:4])


ENTRIES = {"qp": solve_qp, "batched_qp": solve_batch, "seq": solve_seq}
ROOT = {"qp": "qp", "batched_qp": "batched_qp", "seq": "batched_qp"}


@pytest.mark.parametrize("entry", ENTRIES)
def test_a_call_leaves_one_record(entry):
    _, iters, _ = ENTRIES[entry]()
    assert len(trace.calls()) == 1
    rec = trace.calls()[0]
    assert rec.name == ROOT[entry]
    assert set(INNER) <= set(rec.spans)
    # one root: a nested front end (coneqp, make_qp_solver) opens none
    assert rec.spans[rec.name][0] == 1
    assert not {"coneqp", "qp", "batched_qp"} - {rec.name} & set(rec.spans)
    if entry != "seq":
        # the largest lane's iterations; seq steps each slice on its own
        assert rec.counters["ipm.steps"] == iters
        assert rec.spans["ipm"][0] == 1


@pytest.mark.parametrize("entry", ["qp", "batched_qp"])
def test_self_times_sum_to_the_root(entry):
    ENTRIES[entry]()
    rec = trace.calls()[-1]
    total = rec.end_ns - rec.start_ns
    assert rec.spans[rec.name][1] == total
    assert sum(s for _, _, s in rec.spans.values()) == pytest.approx(
        total, rel=0.01)
    for name, (count, tot, self_) in rec.spans.items():
        assert count >= 1 and 0 <= self_ <= tot <= total, name
    # the loop's waits hold nothing inside them
    assert rec.spans["sync"][1] == rec.spans["sync"][2]


@pytest.mark.parametrize("entry", ["qp", "batched_qp"])
def test_recorder_off_records_nothing_and_changes_no_bit(entry):
    _, _, on = ENTRIES[entry]()
    n = len(trace.calls())
    last = trace.calls()[-1].seq
    trace.enable(False)
    _, _, off = ENTRIES[entry]()
    assert len(trace.calls()) == n and trace.calls()[-1].seq == last
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    trace.enable(True)
    ENTRIES[entry]()
    assert trace.calls()[-1].seq == last + 1


def test_clear_empties_the_records():
    solve_qp()
    seq = trace.calls()[0].seq
    trace.clear()
    assert trace.calls() == []
    solve_qp()
    assert [c.seq for c in trace.calls()] == [seq + 1]


def test_h2d_bytes_counts_the_copies_to_the_card(monkeypatch):
    # the CPU copies nothing: the card's predicate is patched in
    solve_qp()
    assert "h2d_bytes" not in trace.calls()[-1].counters
    monkeypatch.setattr(trace, "_on_card", lambda device: True)
    data = qp_data()
    solve_qp()
    assert trace.calls()[-1].counters["h2d_bytes"] == sum(
        a.size * 8 for a in data)
    # tensors given on the host count too; numpy batches go through
    # parallel.batch._tensors
    solvers.qp(*(torch.as_tensor(a) for a in data))
    assert trace.calls()[-1].counters["h2d_bytes"] == sum(
        a.size * 8 for a in data)
    batch = qp_data(batch=B)
    parallel.batched_qp_solver(ConeDims(l=M))(*batch)
    assert trace.calls()[-1].counters["h2d_bytes"] == sum(
        a.nbytes for a in batch)


def _events(path):
    files = sorted(path.iterdir())
    assert len(files) == 1, files
    trace_ = json.loads(files[0].read_text())
    events = trace_["traceEvents"] if isinstance(trace_, dict) else trace_
    return [e for e in events if e.get("ph") == "X"]


def _nested_in_root(events, root):
    top = [e for e in events if e["name"] == root]
    assert len(top) == 1, [e["name"] for e in events][:50]
    lo, hi = top[0]["ts"], top[0]["ts"] + top[0]["dur"]
    for name in INNER:
        inner = [e for e in events if e["name"] == name]
        assert inner, name
        for e in inner:
            assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, name


def test_profile_trace_holds_the_spans_inside_the_root(tmp_path):
    r, _, _ = solve_qp(options={"profile": str(tmp_path)})
    assert r["status"] == "optimal"
    _nested_in_root(_events(tmp_path), "qp")


def test_annotate_shows_a_batched_call_to_the_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.annotate():
            solve_batch()
    prof.export_chrome_trace(str(tmp_path / "batch.trace.json"))
    _nested_in_root(_events(tmp_path), "batched_qp")


def test_no_annotation_without_the_key(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for solve in ENTRIES.values():
        solve()
    with pytest.raises(AssertionError, match="record_function entered"):
        with trace.annotate():
            solve_qp()
