"""h2d_mb_per_call: the bytes the program copies from host memory to the
card in a call (its h2d_bytes counter), the mean over the window's
calls, in MB (1e6 bytes)."""

from benchmark import program_trace


def read(run):
    win = program_trace.window(run)
    if win is None:
        return None
    return sum(r.counters.get("h2d_bytes", 0) for r in win) / len(win) / 1e6
