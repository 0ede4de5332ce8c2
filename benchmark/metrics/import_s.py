"""import_s: the program's import (`import kvxopt_tpu_torch`, torch
already loaded by the harness), from its own import span: a part of
setup_s."""

from benchmark import program_trace


def read(run):
    span = program_trace.import_ns()
    return None if span is None else (span[1] - span[0]) / 1e9
