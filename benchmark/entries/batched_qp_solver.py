"""Entry: kvxopt_tpu_torch.parallel.batched_qp_solver on a batch of
dense cone QPs, with the solver's defaults (no options)."""

from __future__ import annotations


def prepare(dims):
    """Returns (call, result).  call(data) solves the batch in `data` (P,
    q, G, h, A, b, each with the batch first) and reads the status and x
    to the host; it is what the window times.  result(raw) gives, outside
    the clock, the lanes' `optimal` (list of bool) and `iterations` (list
    of int), and x, y, s and z as the program left them."""
    from kvxopt_tpu_torch import ConeDims, parallel
    from kvxopt_tpu_torch.solvers.coneprog import OPTIMAL

    solve = parallel.batched_qp_solver(ConeDims(**dims))

    def call(data):
        out = solve(data["P"], data["q"], data["G"], data["h"], data["A"],
                    data["b"])
        return out, out[5].cpu(), out[0].cpu()

    def result(raw):
        out, status, _ = raw
        # the batched state counts the last convergence test as a step;
        # the front ends report one fewer, the reference's count
        iterations = (out[4] - 1).tolist()
        return {"optimal": (status == OPTIMAL).tolist(),
                "iterations": iterations, "x": out[0], "y": out[1],
                "s": out[2], "z": out[3]}

    return call, result
