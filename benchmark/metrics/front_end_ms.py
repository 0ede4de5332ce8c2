"""front_end_ms: the time a call spends in the program outside its IPM
loop (the root span less the `ipm` span: options, dispatch, the copy of
the inputs, the KKT strategy's set-up, the result), the mean over the
window's calls, from the program's own spans."""

from benchmark import program_trace


def read(run):
    win = program_trace.window(run)
    if win is None:
        return None
    ns = [r.end_ns - r.start_ns - r.spans.get("ipm", (0, 0, 0))[1]
          for r in win]
    return sum(ns) / len(ns) / 1e6
