"""first_call_s: the program's first call in the process (warm call 0),
its root span: the first cuBLAS and cuSOLVER handles and, where nothing
made it before, the CUDA context; a part of setup_s."""

from benchmark import program_trace


def read(run):
    first = [r for r in program_trace.records() or () if r.seq == 0]
    return (first[0].end_ns - first[0].start_ns) / 1e9 if first else None
