"""The per-layer metrics that read the program's own spans and counters
(benchmark/program_trace.py): on synthetic records, where they find
nothing, in a CPU run of the harness, and on the card against torch's
sync debug mode."""

import itertools
import sys
import time
import traceback
import warnings
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, program_trace

CPU = torch.device("cpu")
NEW = ["front_end_ms", "sync_wait_ms_per_iter", "kkt_host_ms_per_iter",
       "cone_host_ms_per_iter", "h2d_mb_per_call", "import_s",
       "first_call_s"]
WINDOWED = NEW[:5]
MS = 1_000_000


def rec(seq, ms, steps=10, ipm=None, sync=0, kkt=(0, 0), cone=0, h2d=0):
    """A record of a call of `ms` milliseconds: its `ipm` span (default
    ms - 1), the total of its sync spans, the self times of kkt.factor
    and kkt.solve and of cone, and its counters."""
    ipm = ms - 1 if ipm is None else ipm
    spans = {"qp": (1, ms * MS, (ms - ipm) * MS),
             "ipm": (1, ipm * MS, 0), "sync": (12, sync * MS, sync * MS),
             "kkt.factor": (3, kkt[0] * MS, kkt[0] * MS),
             "kkt.solve": (6, kkt[1] * MS + 5, kkt[1] * MS),
             "cone": (9, cone * MS, cone * MS)}
    counters = {"ipm.steps": steps}
    if h2d:
        counters["h2d_bytes"] = h2d
    return SimpleNamespace(seq=seq, name="qp", start_ns=7 * MS,
                           end_ns=(7 + ms) * MS, spans=spans,
                           counters=counters)


def run_of(seconds, trace=True, warm=2, trace_calls=3, sync_calls=2):
    cell = SimpleNamespace(traffic={"warm_calls": warm,
                                    "trace_calls": trace_calls,
                                    "sync_calls": sync_calls})
    return {"cell": cell, "calls": [{"seconds": s} for s in seconds],
            "readings": {} if trace else None}


def records(monkeypatch, recs):
    monkeypatch.setattr(program_trace, "records", lambda: recs)


def read(name, run):
    return harness.metric_reader(name).read(run)


def synthetic(monkeypatch):
    """Two warm calls, a window of two (20 and 40 ms), then the 6 calls
    of the traced stretches, each record 1 ms shorter than its call."""
    window = [rec(2, 19, steps=4, sync=2, kkt=(1, 2), cone=3, h2d=10 ** 6),
              rec(3, 39, steps=6, ipm=30, sync=8, kkt=(3, 4), cone=7,
                  h2d=3 * 10 ** 6)]
    tail = [rec(i, 500, steps=99, sync=400) for i in range(4, 10)]
    records(monkeypatch, [rec(0, 900), rec(1, 50)] + window + tail)
    return run_of([0.020, 0.040])


def test_readers_on_synthetic_records(monkeypatch):
    run = synthetic(monkeypatch)
    assert read("front_end_ms.single", run) == pytest.approx(
        ((19 - 18) + (39 - 30)) / 2)
    assert read("sync_wait_ms_per_iter.batch", run) == pytest.approx(1.0)
    assert read("kkt_host_ms_per_iter.single", run) == pytest.approx(1.0)
    assert read("cone_host_ms_per_iter.batch", run) == pytest.approx(1.0)
    assert read("h2d_mb_per_call.single", run) == pytest.approx(2.0)
    assert read("first_call_s", run) == pytest.approx(0.9)


def test_readers_count_the_window_from_the_end(monkeypatch):
    """Calls the process made before the run do not shift the window."""
    run = synthetic(monkeypatch)
    before = {m: read(m, run) for m in WINDOWED}
    recs = program_trace.records()
    records(monkeypatch, [rec(-5 + i, 70, steps=1, sync=60)
                          for i in range(5)] + recs)
    assert {m: read(m, run) for m in WINDOWED} == before


def test_untraced_run_has_no_tail(monkeypatch):
    records(monkeypatch, [rec(0, 9), rec(1, 19, steps=5, sync=5)])
    assert read("sync_wait_ms_per_iter", run_of([0.02], trace=False)) == 1.0


def test_nothing_to_read_without_a_recorder(monkeypatch):
    """A program without kvxopt_tpu_torch.trace, as before it had one."""
    import kvxopt_tpu_torch
    monkeypatch.delattr(kvxopt_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "kvxopt_tpu_torch.trace", None)
    assert program_trace.records() is None
    assert program_trace.import_ns() is None
    run = run_of([0.02, 0.04])
    for m in NEW:
        assert read(m, run) is None, m


def test_nothing_to_read_where_the_records_are_too_few(monkeypatch):
    synthetic(monkeypatch)
    # the window's 2 records and the tail's 6 are there, not 3 and 6
    records(monkeypatch, program_trace.records()[-8:])
    assert program_trace.window(run_of([0.02, 0.04])) is not None
    assert program_trace.window(run_of([0.02, 0.04, 0.01])) is None
    # the recorder was off for part of the window
    records(monkeypatch, program_trace.records()[-7:])
    for m in WINDOWED:
        assert read(m, run_of([0.02, 0.04])) is None, m


def test_nothing_to_read_where_a_root_outlasts_its_call(monkeypatch):
    run = synthetic(monkeypatch)
    run["calls"][1]["seconds"] = 0.0385
    for m in WINDOWED:
        assert read(m, run) is None, m


def test_nothing_to_read_without_steps(monkeypatch):
    records(monkeypatch, [rec(0, 9, steps=0)])
    run = run_of([0.01], trace=False)
    for m in ("sync_wait_ms_per_iter", "kkt_host_ms_per_iter",
              "cone_host_ms_per_iter"):
        assert read(m, run) is None, m
    assert read("front_end_ms", run) == pytest.approx(1.0)


def test_first_call_is_the_records_first(monkeypatch):
    records(monkeypatch, [rec(8193, 9), rec(8194, 9)])
    assert read("first_call_s", run_of([0.01])) is None


def test_import_span(monkeypatch):
    monkeypatch.setattr(program_trace, "import_ns",
                        lambda: (5 * MS, 1255 * MS))
    assert read("import_s", run_of([])) == pytest.approx(1.25)
    from kvxopt_tpu_torch import trace
    monkeypatch.undo()
    start, end = trace.IMPORT_NS
    assert read("import_s", run_of([])) == (end - start) / 1e9 > 0


@pytest.mark.parametrize("name", ["portfolio-b32", "portfolio-single"])
def test_cpu_trace_run_reads_every_new_metric(small_cell, name,
                                              monkeypatch):
    """harness.run with --trace 1 at SMALL size on the CPU, the device
    profile and the sync count replaced by stand-ins that make the same
    calls: every new metric of the cell reads a number."""
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
    # a fresh process's sequence, so that first_call_s finds its call
    monkeypatch.setattr(trace, "_seq", itertools.count())
    trace.clear()
    monkeypatch.setattr(trace, "_on_card", lambda device: True)
    cell = small_cell(name)
    try:
        line = harness.run(cell, 2 ** 31 + 13, 0.3, True,
                           time.perf_counter(), device=CPU)
    finally:
        trace.clear()
    assert line["correct"] is True
    ours = {m["name"] for m in cell.metrics("per_layer")
            if m["name"].split(".")[0] in NEW}
    assert len(ours) == (7 if name == "portfolio-single" else 6)
    for m in ours:
        assert line["metrics"][m]["value"] > 0, m
    if name == "portfolio-single":
        k, n = cell.cfg["shapes"]["p"], cell.cfg["shapes"]["n_var"]
        m = cell.cfg["shapes"]["m"]
        # P, q, G, h, A, b in float64
        assert line["metrics"]["h2d_mb_per_call.single"]["value"] == \
            pytest.approx(8 * (n * n + n + m * n + m + k * n + k) / 1e6)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["portfolio-b32", "portfolio-single"])
def test_every_wait_inside_ipm_is_a_sync_span(name):
    """On the card, under torch.cuda's sync debug mode, each synchronizing
    operation raised while `ipm` is open is raised inside a `sync` span,
    and there are as many as the call's `sync` spans."""
    from kvxopt_tpu_torch import config, trace
    card = _card()
    cell = harness.Cell(name)
    entry = harness.load_module(harness.BENCH / "entries" /
                                f"{cell.traffic['entry']}.py")
    with config.using_device(card):
        call, result = entry.prepare(cell.cfg["dims"])
        data = harness.make_inputs(cell, 2 ** 31 + 17, harness.WARM, 0, card)
        result(call(data))
        torch.cuda.synchronize()
        stacks = []

        def seen(message, *args, **kwargs):
            if "synchroniz" in str(message):
                where = [f"{f.filename.split('/')[-1]}:{f.lineno}"
                         for f in traceback.extract_stack()
                         if "kvxopt_tpu_torch" in f.filename]
                stacks.append((tuple(f[0] for f in trace._tls.stack),
                               where[-1:]))
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                raw = call(data)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    rec = trace.calls()[-1]
    assert result(raw)["optimal"] == [True] * cell.traffic["batch"]
    inside = [(s, w) for s, w in stacks if "ipm" in s]
    outside_sync = {w[0] if w else "?": s for s, w in inside
                    if s[-1] != "sync"}
    assert inside and not outside_sync, outside_sync
    assert len(inside) == rec.spans["sync"][0]
