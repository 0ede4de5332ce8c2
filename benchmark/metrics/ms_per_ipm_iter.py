"""ms_per_ipm_iter: the window's call time over the IPM iterations the
calls stepped, a call counting the largest iteration count of its lanes
(a batch steps until its last lane ends)."""


def read(run):
    calls = run["calls"]
    steps = sum(max(c["iterations"]) for c in calls)
    return 1e3 * sum(c["seconds"] for c in calls) / steps if steps else None
