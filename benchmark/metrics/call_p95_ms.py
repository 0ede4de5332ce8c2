"""call_p95_ms: the 95th percentile of the window's call times, a call
timed from the call to its status and x read on the host."""

from benchmark.harness import percentile


def read(run):
    return 1e3 * percentile([c["seconds"] for c in run["calls"]], 95)
