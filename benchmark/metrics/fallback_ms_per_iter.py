"""fallback_ms_per_iter: the host's self time in the KKT strategy's
fallback (`kkt.fallback`: the augmented LDL' factor and solves of the
lanes chol2 hands over) over the window's calls, per interior-point step
(ipm.steps), from the program's own spans.  None where the program keeps
no kkt.fallback_lanes counter (one without the fallback)."""

from benchmark import program_trace


def read(run):
    win = program_trace.window(run)
    if win is None or not any("kkt.fallback_lanes" in r.counters
                              for r in win):
        return None
    return program_trace.per_step_ms(run, ("kkt.fallback",), 2)
