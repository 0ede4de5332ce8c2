"""device_idle_share: 1 - the union of the device's activity (kernels and
copies) over the wall time of the profiled stretch of calls, in percent.
Not reported where the trace lost kernels."""


def read(run):
    prof = run["readings"]["profile"]
    if prof.why is not None or prof.wall <= 0:
        return None
    return 100.0 * (1.0 - prof.busy / prof.wall)
