"""The batched LP driver and the front ends' edges: batched_lp_solver
against the JAX package's on the scenario batch of chip_smoke's phase 11
(chip_smoke.grid_scenarios, at small k) and on the batched SDP of
tests/test_parallel.py; the solver= routes against the JAX package's;
with no device named and no card, a front end raises.

Per lane of the 9-tuple (x, y, s, z, tau, kappa, iterations, status,
metrics): the same status, iterations within 1, x/tau within
1e-6 (1 + |x/tau|), and the primal objective within 1e-7 (1 + |pcost|).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import grid_scenarios
from kvxopt_tpu.cones import ConeDims as JaxDims
from kvxopt_tpu.parallel import batched_lp_solver as jax_batched_lp_solver
from kvxopt_tpu_torch import ConeDims, config, solvers
from kvxopt_tpu_torch.convert import lp_state_to_numpy, problem_to_torch
from kvxopt_tpu_torch.parallel import batched_lp_solver, make_lp_solver

OPTIMAL = 1


def compare_lp(port, ref):
    x, tau, it, st, m = (port[i] for i in (0, 4, 6, 7, 8))
    xj, tauj, itj, stj = (np.asarray(ref[i]) for i in (0, 4, 6, 7))
    np.testing.assert_array_equal(st, stj)
    assert (np.abs(it - itj) <= 1).all(), (it, itj)
    xs, xsj = x / tau[:, None], xj / tauj[:, None]
    dx = np.linalg.norm(xs - xsj, axis=-1) / (
        1 + np.linalg.norm(xsj, axis=-1))
    assert dx.max() <= 1e-6, dx
    pcj = np.asarray(ref[8]["pcost"])
    assert (np.abs(m["pcost"] - pcj) <= 1e-7 * (1 + np.abs(pcj))).all()
    assert set(m) == set(ref[8])


@functools.lru_cache(maxsize=None)
def grid(B, k):
    return grid_scenarios(k, range(B))


@pytest.mark.parametrize("B,k", [(3, 8), (2, 64)])
def test_batched_lp_solver_matches_jax(B, k):
    data = grid(B, k)
    port = lp_state_to_numpy(batched_lp_solver(ConeDims(l=2 * k))(
        *problem_to_torch(*data, device="cpu")))
    ref = jax_batched_lp_solver(JaxDims(l=2 * k))(
        *(jnp.asarray(a) for a in data))
    compare_lp(port, ref)
    assert (port[7] == OPTIMAL).all()


@pytest.mark.parametrize("B,k", [(3, 8)])
def test_numpy_data_go_to_the_default_device(B, k):
    """numpy inputs land on config.default_device; a single instance is a
    batch of one, returned without the batch axis."""
    data = grid(B, k)
    solve = make_lp_solver(ConeDims(l=2 * k))
    with config.using_device("cpu"):
        out = solve(*data)
        one = solve(*(a[1] for a in data))
    assert out[0].device.type == "cpu" and out[0].shape == (B, k)
    assert one[0].shape == (k,) and set(one[8]) == set(out[8])
    np.testing.assert_allclose(one[0].numpy(), out[0][1].numpy(),
                               rtol=1e-12, atol=1e-12)


def test_batched_sdp():
    """B = 3 SDPs x1 x2 >= off^2 through the conelp core (tests/
    test_parallel.py): x = (off, off) on each lane, as in JAX."""
    B, n, m = 3, 2, 2
    cs = np.tile([1.0, 1.0], (B, 1))
    Gs = np.zeros((B, m * m, n))
    hs = np.zeros((B, m * m))
    offs = 1.0 + 0.5 * np.arange(B)
    for i, off in enumerate(offs):
        Gs[i] = np.column_stack([np.diag([-1.0, 0.0]).ravel(),
                                 np.diag([0.0, -1.0]).ravel()])
        hs[i] = np.array([[0.0, -off], [-off, 0.0]]).ravel()
    port = lp_state_to_numpy(batched_lp_solver(ConeDims(s=(m,)))(
        *problem_to_torch(cs, Gs, hs, device="cpu")))
    ref = jax_batched_lp_solver(JaxDims(l=0, s=(m,)))(
        jnp.asarray(cs), jnp.asarray(Gs), jnp.asarray(hs))
    compare_lp(port, ref)
    assert (port[7] == OPTIMAL).all()
    np.testing.assert_allclose(port[0] / port[4][:, None],
                               np.stack([offs, offs], 1), atol=1e-5)


LP = (np.array([-4.0, -5.0]),
      np.array([[2.0, 1.0], [1.0, 2.0], [-1.0, 0.0], [0.0, -1.0]]),
      np.array([3.0, 3.0, 0.0, 0.0]))

ROUTES = {
    "lp glpk": lambda s: s.lp(*LP, solver="glpk"),
    "qp osqp": lambda s: s.qp(np.eye(2), LP[0], *LP[1:], solver="osqp"),
    "sdp dsdp": lambda s: s.sdp(
        np.ones(2), Gs=[-np.eye(4)[:, [0, 3]]], hs=[np.eye(2)],
        solver="dsdp"),
    "socp mosek": lambda s: s.socp(LP[0], LP[1], LP[2], solver="mosek"),
}


@pytest.mark.parametrize("call", sorted(ROUTES))
def test_solver_routes_do_what_jax_does(call):
    """The solver= routes: glpk, osqp and dsdp return an optimal result
    equal to the JAX package's (glpk and dsdp to 1e-10, osqp to 1e-9);
    mosek without the package raises ImportError in both."""
    from kvxopt_tpu import solvers as jax_solvers
    from tests.test_torch_bridges import same
    if call == "socp mosek":
        for s in (solvers, jax_solvers):
            with config.using_device("cpu"), pytest.raises(ImportError):
                ROUTES[call](s)
        return
    with config.using_device("cpu"):
        port = ROUTES[call](solvers)
    ref = ROUTES[call](jax_solvers)
    assert port["status"] == ref["status"] == "optimal"
    same(port, ref, tol=1e-9 if "osqp" in call else 1e-10)


@pytest.mark.parametrize("entry", ["lp", "qp", "batched_lp_solver"])
def test_no_card_and_no_device_named_raises(entry, monkeypatch):
    """The default device is the card; where there is none the call
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert config.default_device.type == "cuda"
    call = {"lp": lambda: solvers.lp(*LP),
            "qp": lambda: solvers.qp(np.eye(2), *LP),
            "batched_lp_solver": lambda: batched_lp_solver(ConeDims(l=4))(
                *(a[None] for a in LP))}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
