"""Scenario-batched solve drivers."""

from .batch import (batched_lp_solver, batched_qp_solver,  # noqa: F401
                    batched_qp_solver_mixed, make_lp_solver, make_qp_solver)
