"""kkt_roofline: the least time the chip needs for the KKT
factorizations the window's solves required, over the window's time, in
percent.  Each lane counts one factorization per returned iteration at
its shapes (roofline.kkt_work); the least time is the larger of the
total flops over the float64 tensor peak and the total bytes over the
memory rate.  The count comes from shapes and iterations alone, and the
divisor is the whole call time, so it cannot pass 100% while the program
does that work."""

from benchmark.roofline import bound_s, kkt_work


def read(run):
    cell = run["cell"]
    nb, fl = kkt_work(*cell.problem.shapes(cell.cfg))
    lanes = sum(sum(c["iterations"]) for c in run["calls"])
    wall = sum(c["seconds"] for c in run["calls"])
    return 100.0 * bound_s(nb * lanes, fl * lanes) / wall if lanes else None
