"""cone_host_ms_per_iter: the host's self time in the cone algebra
(`cone` spans: the scaling, the Newton right-hand sides, ds and the step
lengths) over the window's calls, per interior-point step (ipm.steps),
from the program's own spans."""

from benchmark import program_trace


def read(run):
    return program_trace.per_step_ms(run, ("cone",), 2)
