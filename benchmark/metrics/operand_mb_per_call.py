"""operand_mb_per_call: the bytes of the distinct storages that a call's
P, q, G, h, A and b occupy on the card (the program's operand_bytes
counter, where a storage the lanes share counts once), the mean over
the window's calls, in MB (1e6 bytes).  Nothing where the program keeps
no such counter."""

from benchmark import program_trace


def read(run):
    win = program_trace.window(run)
    if win is None:
        return None
    got = [r.counters["operand_bytes"] for r in win
           if "operand_bytes" in r.counters]
    return sum(got) / len(got) / 1e6 if got else None
