"""Entry: kvxopt_tpu_torch.solvers.qp, the CVXOPT-compatible front end,
on one dense QP given as numpy arrays, with the solver's defaults."""

from __future__ import annotations


def prepare(dims):
    """Returns (call, result) as batched_qp_solver.prepare does, for a
    batch of one: data holds one instance's numpy arrays."""
    from kvxopt_tpu_torch import solvers

    def call(data):
        r = solvers.qp(data["P"], data["q"], data["G"], data["h"],
                       data["A"], data["b"])
        return r, r["x"].cpu()

    def result(raw):
        r = raw[0]
        return {"optimal": [r["status"] == "optimal"],
                "iterations": [r["iterations"]],
                **{k: r[k][None] for k in ("x", "y", "s", "z")}}

    return call, result
