"""solves_per_s: instances that ended optimal in the window's calls, over
the window's seconds (the sum of the calls' times)."""


def read(run):
    calls = run["calls"]
    return (sum(sum(c["optimal"]) for c in calls)
            / sum(c["seconds"] for c in calls))
