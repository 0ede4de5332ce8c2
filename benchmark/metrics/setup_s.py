"""setup_s: from the process's start to the first timed call: imports,
the CUDA context, the solver's construction and the warm calls at the
cell's own shapes, their inputs included."""


def read(run):
    return run["setup_s"]
