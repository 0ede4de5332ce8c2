"""fallback_lane_share: the share of the lanes' steps that the KKT
strategy's fallback served: the program's kkt.fallback_lanes (the lanes
that chol2 handed to the augmented LDL' in each factorization) summed
over the window's calls, over the iterations the program returns summed
over the window's lanes, in percent.  None where the program keeps no
such counter (one without the fallback)."""

from benchmark import program_trace


def read(run):
    win = program_trace.window(run)
    if win is None or not any("kkt.fallback_lanes" in r.counters
                              for r in win):
        return None
    lanes = sum(r.counters.get("kkt.fallback_lanes", 0) for r in win)
    own = sum(sum(c["iterations"]) for c in run["calls"])
    return 100.0 * lanes / own if own else None
