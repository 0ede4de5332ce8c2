"""iters_per_solve: the IPM iterations the program returns, the mean over
the window's instances that ended optimal."""


def read(run):
    its = [it for c in run["calls"]
           for it, ok in zip(c["iterations"], c["optimal"]) if ok]
    return sum(its) / len(its) if its else None
