"""The cone-program solvers (reference src/python/solvers.py): coneqp,
qp, conelp, lp, socp and sdp, and the shared mutable `options` dict."""

options = {}

from .coneprog import Options, coneqp, qp  # noqa: E402,F401
from ._conelp import conelp, lp, sdp, socp  # noqa: E402,F401

__all__ = ["conelp", "coneqp", "lp", "qp", "socp", "sdp", "options",
           "Options"]
