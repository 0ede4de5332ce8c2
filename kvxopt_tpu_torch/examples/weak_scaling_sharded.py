"""Weak-scaling measurement for the tensor-parallel KKT factor.

Runs the full-cone sharded kktsolver (parallel/sharded.py
sharded_kkt_solver) in worlds of 1/2/4/8 ranks started by
parallel.spawn, with FIXED WORK PER RANK (rows grow with the rank
count), timing one factor(W)+solve round trip — the per-IPM-iteration
unit of work.  Ideal weak scaling is constant time per step as ranks
are added.

The ranks run on the card by default (NCCL where each rank has a card
of its own, gloo where several share one) or, with --cpu, on the CPU
over gloo.  Ranks that share one card or the host's cores validate the
collective structure and measure overhead, not the interconnect's
bandwidth.  Nothing is set at import.

Usage: python -m kvxopt_tpu_torch.examples.weak_scaling_sharded
           [rows_per_dev] [n] [--cpu]
"""

import sys
import time

import numpy as np
import torch


def problem(rows, n):
    """The seeded data of one world: G (rows, n), s and z (rows,) in
    (0.5, 2), bx (n,) and bz (rows,)."""
    rng = np.random.default_rng(0)
    G = rng.standard_normal((rows, n))
    s = rng.uniform(0.5, 2.0, rows)
    z = rng.uniform(0.5, 2.0, rows)
    bx = rng.standard_normal(n)
    bz = rng.standard_normal(rows)
    return G, s, z, bx, bz


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank(rank, world, dev, rows_per_dev, n, reps):
    """One rank: the sharded factor over a mesh of `world` ranks, one
    untimed step, then `reps` timed steps on fresh scalings -> (median
    seconds, ux of the first step) on rank 0."""
    from kvxopt_tpu_torch import config
    from kvxopt_tpu_torch.cones import ConeDims, compute_scaling
    from kvxopt_tpu_torch.convert import scaling_instance
    from kvxopt_tpu_torch.parallel import make_mesh, sharded_kkt_solver

    config.set_default_device(dev)
    rows = rows_per_dev * world
    dims = ConeDims(l=rows)
    G, s, z, bx, bz = (torch.as_tensor(a, device=dev)
                       for a in problem(rows, n))
    W = scaling_instance(dims, compute_scaling(dims, s[None], z[None])[0])
    mesh = make_mesh(world, ("kkt",))
    factor = sharded_kkt_solver(mesh, "kkt", dims, G,
                                Pmat=torch.eye(n, dtype=G.dtype, device=dev))
    by = G.new_zeros((0,))

    def step(d_l):
        solve = factor(W._replace(d=d_l))
        return solve(bx, by, bz)[0]

    ux = step(W.d)
    _sync(dev)
    ts = []
    for i in range(reps):
        d_i = W.d + 1e-6 * i  # fresh data each rep
        _sync(dev)
        t0 = time.perf_counter()
        step(d_i)
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ux.cpu().numpy()


def run(ndev, rows_per_dev, n, reps=5, device=None, backend=None):
    """A world of ndev ranks (parallel.spawn: device None is the card,
    backend None its default) -> (median seconds of a factor+solve step,
    ux of the first step, numpy)."""
    from kvxopt_tpu_torch.parallel import spawn
    return spawn(_rank, ndev, backend, device,
                 args=(rows_per_dev, n, reps))


def measure(ndev, rows_per_dev, n, reps=5, device=None, backend=None):
    """Median seconds of one factor(W)+solve step in a world of ndev
    ranks."""
    return run(ndev, rows_per_dev, n, reps, device, backend)[0]


def main():
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    device = "cpu" if "--cpu" in sys.argv[1:] else None
    rows_per_dev = int(args[0]) if len(args) > 0 else 2048
    n = int(args[1]) if len(args) > 1 else 256
    t1 = None
    print(f"rows/device={rows_per_dev} n={n}")
    print("ndev  rows    factor+solve ms   weak-scaling eff")
    for ndev in (1, 2, 4, 8):
        t = measure(ndev, rows_per_dev, n, device=device)
        if t1 is None:
            t1 = t
        print(f"{ndev:4d}  {rows_per_dev*ndev:6d}  {t*1e3:12.2f}      "
              f"{t1/t:.2f}")


if __name__ == "__main__":
    main()
