"""parallel.batched_qp_solver_seq of kvxopt_tpu_torch against the JAX
package's, on the inputs of tests/test_parallel.py's two sequential
driver tests (B=3 and B=4, n=12, m=20 orthant QPs).

Both run on the CPU in f64.  Status and iterations agree lane by lane; x
to 1e-7 with chol2 and 1e-6 with the mixed strategy (its f32 factor and
PCG solve, the f64 fallback where a lane's refinement does not
contract).  One case on the card (skipped without CUDA) holds the
driver at B=2 n=256 against the same call on CPU tensors; the card has
no JAX, so the file imports it only where a test compares with it:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_seq.py
"""

import numpy as np
import pytest
import torch

from kvxopt_tpu_torch import ConeDims as TDims
from kvxopt_tpu_torch.parallel import (batched_qp_solver,
                                       batched_qp_solver_seq)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def qps(B, n, m, seed, p=0):
    """B random strictly convex QPs, as tests/test_parallel.py builds
    them; with p > 0 also A (B, p, n) and b = A x0."""
    rng = np.random.default_rng(seed)
    Ps = np.zeros((B, n, n)); qs = np.zeros((B, n))
    Gs = np.zeros((B, m, n)); hs = np.zeros((B, m))
    As = np.zeros((B, p, n)); bs = np.zeros((B, p))
    for i in range(B):
        M = rng.standard_normal((n, n))
        Ps[i] = M @ M.T + n * np.eye(n)
        qs[i] = rng.standard_normal(n)
        Gs[i] = rng.standard_normal((m, n))
        x0 = rng.standard_normal(n)
        hs[i] = Gs[i] @ x0 + rng.uniform(0.5, 1.5, m)
        As[i] = rng.standard_normal((p, n))
        bs[i] = As[i] @ x0
    return (Ps, qs, Gs, hs) + ((As, bs) if p else ())


def agree(out_t, out_j, tol):
    st, sj = out_t[5].numpy(), np.asarray(out_j[5])
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
    assert (st == 1).all()
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               atol=tol)
    for a, b in zip(out_t[6], out_j[6]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   rtol=tol)


def run_both(data, m, kktsolver, group=1, with_eq=False):
    import jax.numpy as jnp
    from kvxopt_tpu import ConeDims as JDims
    from kvxopt_tpu.parallel import batched_qp_solver_seq as jseq
    out_j = jseq(JDims(l=m), kktsolver, with_eq=with_eq, group=group)(
        *(jnp.asarray(a) for a in data))
    out_t = batched_qp_solver_seq(TDims(l=m), kktsolver, with_eq=with_eq,
                                  group=group)(
        *(torch.from_numpy(a) for a in data))
    assert out_t[0].shape == np.asarray(out_j[0]).shape
    return out_t, out_j


@pytest.mark.parametrize("kktsolver,tol", [("chol2", 1e-7),
                                           ("chol2_mixed", 1e-6)])
def test_seq_matches_jax(kktsolver, tol):
    data = qps(3, 12, 20, 11)
    out_t, out_j = run_both(data, 20, kktsolver)
    agree(out_t, out_j, tol)
    # the sequential driver solves what the masked batch solves
    ref = batched_qp_solver(TDims(l=20), "chol2")(
        *(torch.from_numpy(a) for a in data))
    np.testing.assert_allclose(out_t[0].numpy(), ref[0].numpy(), atol=tol)


@pytest.mark.parametrize("group", [2, 4])
def test_seq_grouped_matches_jax(group):
    data = qps(4, 12, 20, 21)
    out_t, out_j = run_both(data, 20, "chol2_mixed", group=group)
    agree(out_t, out_j, 1e-6)


def test_seq_with_eq_matches_jax():
    data = qps(3, 12, 20, 31, p=3)
    out_t, out_j = run_both(data, 20, "chol2_mixed", with_eq=True)
    agree(out_t, out_j, 1e-6)
    x, A, b = out_t[0].numpy(), data[4], data[5]
    assert np.abs(np.einsum("bij,bj->bi", A, x) - b).max() < 1e-6


def test_cond_any_runs_one_branch_where_every_lane_agrees():
    """In a slice whose every lane takes the f64 fallback only the true
    branch runs, as under the JAX package's real lax.cond in lax.map."""
    from kvxopt_tpu_torch.kkt import cond_any
    calls = []

    def branch(tag, d):
        def fn(v):
            calls.append(tag)
            return v + d
        return fn

    x = torch.zeros((2, 3))
    out = cond_any(torch.tensor([True, True]), branch("t", 1.0),
                   branch("f", -1.0), x)
    assert calls == ["t"] and bool((out == 1.0).all())


def test_seq_batch_not_divisible_by_group():
    data = tuple(torch.from_numpy(a) for a in qps(3, 12, 20, 11))
    with pytest.raises(ValueError, match="batch 3 not divisible by group 2"):
        batched_qp_solver_seq(TDims(l=20), group=2)(*data)


@pytest.mark.cuda
def test_seq_on_the_card_matches_cpu(cuda):
    """B=2, n=256, m=512 through chol2_mixed on the card (kernels K1-K3
    and the f64 fallback) against the same driver on CPU tensors."""
    data = qps(2, 256, 512, 41)
    solve = batched_qp_solver_seq(TDims(l=512))
    gpu = solve(*(torch.tensor(a, device=cuda) for a in data))
    cpu = solve(*(torch.from_numpy(a) for a in data))
    assert (gpu[5].cpu() == 1).all() and (cpu[5] == 1).all()
    assert (gpu[4].cpu() - cpu[4]).abs().max() <= 1
    x, xc = gpu[0].cpu().numpy(), cpu[0].numpy()
    assert np.abs(x - xc).max() <= 1e-6 * (1 + np.abs(xc).max())
