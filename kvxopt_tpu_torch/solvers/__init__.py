"""The solvers (reference src/python/solvers.py): the cone programs
coneqp, qp, conelp, lp, socp and sdp, the nonlinear cpl, cp and gp, and
the shared mutable `options` dict."""

options = {}

from .coneprog import Options, coneqp, qp  # noqa: E402,F401
from ._conelp import conelp, lp, sdp, socp  # noqa: E402,F401
from .cvxprog import cp, cpl, gp  # noqa: E402,F401

__all__ = ["conelp", "coneqp", "cp", "cpl", "gp", "lp", "qp", "socp",
           "sdp", "options", "Options"]
