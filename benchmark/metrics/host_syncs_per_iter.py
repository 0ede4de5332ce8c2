"""host_syncs_per_iter: the host's waits for the card (torch.cuda's sync
debug mode) over the counted stretch of calls, per IPM iteration (a call
counts its largest lane iteration count)."""


def read(run):
    r = run["readings"]
    steps = sum(max(its) for its in r["sync_iterations"])
    return r["syncs"] / steps if steps else None
