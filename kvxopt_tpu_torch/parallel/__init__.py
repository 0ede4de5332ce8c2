"""Scenario-batched solve drivers: make_qp_solver and make_lp_solver,
the vmapped-style masked batches (batched_qp_solver, batched_lp_solver),
the two-pass mixed-precision driver (batched_qp_solver_mixed) and the
sequential one (batched_qp_solver_seq).  The sharded KKT modules
(sharded, arrow, dist_chol) and make_mesh are not ported yet (ROADMAP.md,
Queue 1 item 9)."""

from .batch import (batched_lp_solver, batched_qp_solver,  # noqa: F401
                    batched_qp_solver_mixed, batched_qp_solver_seq,
                    make_lp_solver, make_qp_solver)
