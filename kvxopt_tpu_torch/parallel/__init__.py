"""Scenario-batched solve drivers."""

from .batch import (batched_qp_solver, batched_qp_solver_mixed,  # noqa: F401
                    make_qp_solver)
