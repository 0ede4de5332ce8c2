"""The program's own spans and counters, as the per-layer metrics read
them: kvxopt_tpu_torch.trace keeps one record per top-level call (its
root span, the spans inside it with their count, total and self
nanoseconds, and its counters), in the order of the calls.

A run calls the program in this order: the warm calls, the window's
calls, and in a --trace 1 run one untraced call, the profiled stretch
(trace_calls) and the counted stretch (sync_calls).  The window's
records are found by that place, counted from the end, so that calls a
process made before the run do not shift them.  Where the program has
no recorder, as before it had one, every reader finds nothing."""

from __future__ import annotations


def records():
    """The program's records, oldest first, or None where it keeps
    none."""
    try:
        from kvxopt_tpu_torch import trace
    except ImportError:
        return None
    return trace.calls()


def import_ns():
    """(start, end) of the program's import span, or None."""
    try:
        from kvxopt_tpu_torch import trace
    except ImportError:
        return None
    return getattr(trace, "IMPORT_NS", None)


def window(run):
    """The records of the window's calls, one per call of run["calls"],
    or None: where fewer records are kept than the run's calls after
    the warm-up, or where a root span is longer than its call's time
    (the record is not that call's)."""
    recs = records()
    if recs is None:
        return None
    t = run["cell"].traffic
    after = (1 + t["trace_calls"] + t["sync_calls"]
             if run["readings"] is not None else 0)
    n = len(run["calls"])
    if n == 0 or len(recs) < n + after:
        return None
    win = recs[len(recs) - after - n:len(recs) - after]
    for r, c in zip(win, run["calls"]):
        if (r.end_ns - r.start_ns) / 1e9 > c["seconds"]:
            return None
    return win


def per_step_ms(run, names, which):
    """The window's summed times of the spans `names` (which: 1 the
    total, 2 the self time) over its summed ipm.steps, in ms."""
    win = window(run)
    if win is None:
        return None
    steps = sum(r.counters.get("ipm.steps", 0) for r in win)
    if not steps:
        return None
    ns = sum(r.spans[k][which] for r in win for k in names if k in r.spans)
    return ns / steps / 1e6
