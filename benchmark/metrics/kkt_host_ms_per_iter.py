"""kkt_host_ms_per_iter: the host's self time in the KKT strategy's
factor and solves (`kkt.factor`, `kkt.solve`) over the window's calls,
per interior-point step (ipm.steps), from the program's own spans: the
time the host takes to enqueue the KKT work, waits inside it
included."""

from benchmark import program_trace


def read(run):
    return program_trace.per_step_ms(run, ("kkt.factor", "kkt.solve"), 2)
