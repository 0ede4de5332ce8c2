"""sync_wait_ms_per_iter: the host's time inside the IPM loop's waits for
the device (`sync` spans) over the window's calls, per interior-point
step (ipm.steps), from the program's own spans."""

from benchmark import program_trace


def read(run):
    return program_trace.per_step_ms(run, ("sync",), 1)
