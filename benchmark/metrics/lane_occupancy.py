"""lane_occupancy: the lanes' own share of the steps a batch takes: the
iterations the program returns, summed over the window's lanes, over
each call's lanes times its interior-point steps (the program's
ipm.steps), in percent.  A lane that has ended keeps its place in the
batch's work until the last lane ends, so the rest is device work on
lanes already done; 100% where every lane of a call ends at the same
step."""

from benchmark import program_trace


def read(run):
    win = program_trace.window(run)
    if win is None:
        return None
    calls = run["calls"]
    slots = sum(len(c["iterations"]) * r.counters.get("ipm.steps", 0)
                for r, c in zip(win, calls))
    own = sum(sum(c["iterations"]) for c in calls)
    return 100.0 * own / slots if slots else None
