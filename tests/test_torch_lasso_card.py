"""The OSQP suite's lasso on the card, at the cell lasso-b32's size: a
batch that holds lanes on which chol2's K breaks down ends all optimal,
within the tolerances by the plain reference's judge
(benchmark/reference/qp_orthant.py), and the fallback to the augmented
LDL' ran on the card (tests/test_torch_lasso.py holds the CPU side).
Run on a machine with a CUDA device:

    python -m pytest --noconftest -m cuda tests/test_torch_lasso_card.py
"""

import pytest
import torch

from benchmark.problems import lasso
from benchmark.reference import qp_orthant as ref
from kvxopt_tpu_torch import ConeDims, parallel, trace
from kvxopt_tpu_torch.kkt import _ldl_solver, _qd_solver
from kvxopt_tpu_torch.solvers.coneprog import OPTIMAL

SEED = 1618033988
TOL = {"abstol": 1e-7, "reltol": 1e-6, "feastol": 1e-7}
KEYS = ("P", "q", "G", "h", "A", "b")


def quasidefinite(B, n, m, reg=1e-9):
    """[[H + reg I, C'], [C, -reg I]] with H positive definite of order n
    and C (m, n), m < n: the shape of ldl's regularized KKT matrix."""
    g = torch.Generator().manual_seed(7 * B + n)
    X = torch.randn((B, n, n), generator=g, dtype=torch.float64)
    C = torch.randn((B, m, n), generator=g, dtype=torch.float64) / n ** 0.5
    M = torch.zeros((B, n + m, n + m), dtype=torch.float64)
    M[:, :n, :n] = X @ X.mT / n + (0.5 + reg) * torch.eye(n)
    M[:, n:, :n] = C
    M[:, :n, n:] = C.mT
    M[:, n:, n:] = -reg * torch.eye(m)
    return M, n


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_lasso_batch_with_breakdown_lanes_on_card(cuda):
    """(10, 1000), 32 lanes made on the card: chol2 on K7, K6 and K5 with
    the Schur complement over 1000 equalities, and the breakdown lanes on
    the fallback."""
    gen = torch.Generator(device=cuda).manual_seed(SEED)
    d = lasso.make({"n": 10, "m": 1000, "density": 0.15}, gen, 32, cuda,
                   torch.float64)
    out = parallel.batched_qp_solver(ConeDims(l=20))(*(d[k] for k in KEYS))
    assert out[0].device.type == "cuda"
    assert (out[5] == OPTIMAL).all(), torch.nonzero(out[5] != OPTIMAL)
    assert trace.calls()[-1].counters["kkt.fallback_lanes"] > 0
    j = ref.judge(d, dict(zip(("x", "y", "s", "z"), out[:4])), TOL)
    assert max(j["residual"]) <= TOL["feastol"], j["residual"]
    assert max(j["gap"]) <= 1.0, j["gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
def test_quasidefinite_split_on_card_matches_ldl_nopiv(cuda, B):
    """ldl's factor on the card (two Cholesky factors of the quasidefinite
    split) solves as ldl_nopiv's column loop does on the CPU, at the
    lasso's order 2040 with its 1e-9 regularization."""
    M, n = quasidefinite(B, 1020, 1000)
    b = torch.randn((B, 2020), generator=torch.Generator().manual_seed(B),
                    dtype=torch.float64)
    u = _qd_solver(M.to(cuda), n)(b.to(cuda)).cpu()
    ref_u = _ldl_solver(M)(b)
    assert float((u - ref_u).norm() / ref_u.norm()) < 1e-9
