"""Parallel scale-out over torch.distributed.

Counterpart of kvxopt_tpu/parallel.  Scenario batching: make_qp_solver
and make_lp_solver, the masked batches (batched_qp_solver,
batched_lp_solver), the two-pass mixed-precision driver
(batched_qp_solver_mixed) and the sequential one
(batched_qp_solver_seq); with mesh= the batch is dealt over a mesh's
'batch' axis.  Over a mesh of ranks (make_mesh, started by spawn): the
tensor-parallel KKT factor (sharded_kkt_solver, sharded_kkt_factor),
the arrow factorization (arrow_kkt_factor) and the block-cyclic
distributed Cholesky (dist_chol_factory, dist_cholesky, cyclic_pack,
cyclic_unpack); dryrun.dryrun_multichip drives them all on a spawned
world.
"""

from .batch import (batched_lp_solver, batched_qp_solver,  # noqa: F401
                    batched_qp_solver_mixed, batched_qp_solver_seq,
                    make_lp_solver, make_qp_solver)
from .mesh import make_mesh, spawn  # noqa: F401
from .sharded import sharded_kkt_factor, sharded_kkt_solver  # noqa: F401
from .arrow import arrow_kkt_factor  # noqa: F401
from .dist_chol import (  # noqa: F401
    cyclic_pack, cyclic_unpack, dist_chol_factory, dist_cholesky)
