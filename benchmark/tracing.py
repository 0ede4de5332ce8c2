"""Device tracing for the benchmark: a profiled stretch of calls, the
union of device activity, idle gaps by what the host was doing, and the
host's synchronizing operations.

Frozen copies, so that a change to the repository's smoke script cannot
move the yardstick: `profiled` follows chip_smoke.py's `trace` (the spin
kernels that open the trace, and the check for kernels lost from it) and
`count_syncs` is chip_smoke.py's `count_syncs`.  Where chip_smoke.py's
`device_busy` summed kernel times, `profiled` takes the union of the
intervals, which is the busy time on any number of streams.
"""

from __future__ import annotations

import heapq
import time
import warnings
from types import SimpleNamespace

import torch

# spin kernels that open each trace: a trace that follows a large one can
# drop the records of its first few dozen kernels
PRIME = 256
SPAN = "benchmark.stretch"


def union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals, lo, hi):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def _innermost(events, times):
    """For each of the ascending `times`, the name of the innermost
    (latest starting) host event that covers it, else None."""
    events = sorted(events, key=lambda e: e.start)
    heap, out, i = [], [], 0
    for t in times:
        while i < len(events) and events[i].start <= t:
            heapq.heappush(heap, (-events[i].start, i))
            i += 1
        # an event that ended before t ends before every later time
        while heap and events[heap[0][1]].end < t:
            heapq.heappop(heap)
        out.append(events[heap[0][1]].name if heap else None)
    return out


def profiled(fn):
    """fn() once under torch.profiler (device and host activity).
    Returns a namespace: wall (s, the span around fn), busy (s, the union
    of device kernels and copies within it), why (None, or why the trace
    does not hold all of fn's device work: no device events, or kernels
    lost from it),
    device_ops [(name, s)] by total device time and idle_gaps [(what the
    host was doing, s)] by total idle time, each the first 10."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIME):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with record_function(SPAN):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = list(prof.events())
    span = [e for e in events if e.name == SPAN]
    if not span:
        return SimpleNamespace(wall=wall, busy=0.0, why="no span in trace",
                               device_ops=[], idle_gaps=[])
    lo, hi = span[0].time_range.start, span[0].time_range.end
    dev, host = [], []
    for e in events:
        r = e.time_range
        if r.end < lo or r.start > hi:
            continue
        if e.device_type == DeviceType.CUDA:
            # the span itself is also recorded as a device-side range
            if "spin_kernel" not in e.name and e.name != SPAN:
                dev.append(e)
        elif e.name != SPAN:
            host.append(SimpleNamespace(name=e.name, start=r.start,
                                        end=r.end))
    intervals = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
                 for e in dev]
    launches = sum(1 for e in host if "Launch" in e.name
                   and "Kernel" in e.name)
    kernels = sum(1 for e in dev
                  if not e.name.startswith(("Memcpy", "Memset")))
    why = ("no device events" if not dev else
           f"trace lost {launches - kernels} of {launches} kernels"
           if kernels < launches else None)
    by_op = {}
    for e in dev:
        by_op[e.name] = by_op.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    idle = gaps(intervals, lo, hi)
    by_gap = {}
    for (a, b), what in zip(idle, _innermost(host, [(a + b) / 2
                                                    for a, b in idle])):
        what = what or "host, outside any operator"
        by_gap[what] = by_gap.get(what, 0.0) + (b - a) / 1e6
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa
    return SimpleNamespace(wall=wall, busy=union(intervals) / 1e6, why=why,
                           device_ops=[list(kv) for kv in top(by_op)],
                           idle_gaps=[list(kv) for kv in top(by_gap)])


def count_syncs(fn):
    """The host's waits for the card in fn(): the synchronizing operations
    (a tensor read to the host, .item(), .tolist(), a data-dependent
    shape) that torch.cuda's sync debug mode reports."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)
