"""The port's slice end to end: batched_qp_solver_mixed (the two-pass
mixed-precision driver) and batched_qp_solver(dims, "chol2"), against the
JAX package's drivers vmapped on the CPU with x64.

Per lane: the same status, iterations within 1, x within
1e-6 (1 + |x|) and the primal objective to 1e-6 relative.  Both sides
stop at abstol/feastol 1e-7, so their iterates may differ by about that
much where one side stops an iteration earlier.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from kvxopt_tpu.cones import ConeDims as JaxDims
from kvxopt_tpu.parallel import batch as jb
from kvxopt_tpu_torch import ConeDims
from kvxopt_tpu_torch.convert import (dims_from, options_from,
                                      problem_to_torch, state_to_numpy)
from kvxopt_tpu_torch.parallel import batch as tb


def problems(B, n, m, seed0=0):
    """The generator of bench._large_problem, one seed per lane."""
    out = []
    for seed in range(seed0, seed0 + B):
        rng = np.random.default_rng(seed)
        Mx = rng.standard_normal((n, n))
        P = Mx @ Mx.T + n * np.eye(n)
        q = rng.standard_normal(n)
        G = rng.standard_normal((m, n))
        h = G @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
        out.append((P, q, G, h))
    return tuple(np.stack(a) for a in zip(*out))


def compare(port, ref):
    x, it, st, pc = port[0], port[4], port[5], port[6].pcost
    xj, itj, stj = (np.asarray(ref[i]) for i in (0, 4, 5))
    pcj = np.asarray(ref[6].pcost)
    np.testing.assert_array_equal(st, stj)
    assert (np.abs(it - itj) <= 1).all(), (it, itj)
    dx = np.linalg.norm(x - xj, axis=-1) / (1 + np.linalg.norm(xj, axis=-1))
    assert dx.max() <= 1e-6, dx
    assert (np.abs(pc - pcj) <= 1e-6 * np.abs(pcj)).all()


SHAPES = [(4, 16, 32), (2, 130, 260), (2, 256, 512)]


@pytest.mark.parametrize("B,n,m", SHAPES)
def test_mixed_driver_matches_jax(B, n, m):
    data = problems(B, n, m)
    solve = tb.batched_qp_solver_mixed(ConeDims(l=m))
    port = state_to_numpy(solve(*problem_to_torch(*data, device="cpu")))
    ref = jb.batched_qp_solver_mixed(JaxDims(l=m))(
        *(jnp.asarray(a) for a in data))
    compare(port, ref)
    assert (port[5] == 1).all()
    assert 0 <= solve.stats["pass2_lanes"] <= B


@pytest.mark.parametrize("B,n,m", SHAPES)
def test_chol2_driver_matches_jax(B, n, m):
    data = problems(B, n, m, seed0=10)
    port = state_to_numpy(tb.batched_qp_solver(ConeDims(l=m), "chol2")(
        *problem_to_torch(*data, device="cpu")))
    ref = jb.batched_qp_solver(JaxDims(l=m), "chol2")(
        *(jnp.asarray(a) for a in data))
    compare(port, ref)


@pytest.mark.parametrize("B,n,m", SHAPES)
def test_pass1_with_factor_refinement_matches_jax(B, n, m):
    """Pass 1 alone as the card runs it, factor refinement on (on the CPU
    the drivers' "vmap" default turns it off on both sides), including
    the lanes that end 'singular' and go to pass 2."""
    from kvxopt_tpu.solvers.coneprog import Options as JaxOptions
    from kvxopt_tpu_torch.solvers.coneprog import Options
    data = problems(B, n, m)
    port = state_to_numpy(tb.batched_qp_solver(
        ConeDims(l=m), "chol2_mixed_nofb", Options(ozaki=True, facref=True))(
            *problem_to_torch(*data, device="cpu")))
    ref = jb.batched_qp_solver(
        JaxDims(l=m), "chol2_mixed_nofb",
        JaxOptions(ozaki=True, facref=True))(*(jnp.asarray(a) for a in data))
    compare(port, ref)


def test_entry_problem_single_instance_mixed():
    """__graft_entry__'s n=8 m=12 QP, one instance, chol2_mixed."""
    P, q, G, h = (np.asarray(a)[0] for a in graft._example_qp(
        1, 8, 12, jnp.float64))
    port = tb.make_qp_solver(ConeDims(l=12), "chol2_mixed")(
        *problem_to_torch(P, q, G, h, device="cpu"))
    ref = jb.make_qp_solver(JaxDims(l=12), "chol2_mixed")(
        *(jnp.asarray(a) for a in (P, q, G, h)))
    port = state_to_numpy(port)
    assert port[0].shape == (8,) and int(port[5]) == 1
    compare(tuple(a[None] for a in port[:6]) + (
        type(port[6])(*(a[None] for a in port[6])),),
        tuple(np.asarray(a)[None] for a in ref[:6]) + (
            type(ref[6])(*(np.asarray(a)[None] for a in ref[6])),))


def test_conversions_from_jax_objects():
    from kvxopt_tpu.solvers.coneprog import Options as JaxOptions
    assert dims_from(JaxDims(l=5)) == ConeDims(l=5)
    assert dims_from({"l": 3}) == ConeDims(l=3)
    o = options_from(JaxOptions(abstol=1e-8, refinement=2))
    assert o.abstol == 1e-8 and o.refinement == 2
    with pytest.raises(ValueError):
        options_from({"bogus": 1})


def test_unported_inputs_raise():
    """q cones and equality constraints (tests/test_torch_slice_eq.py), s
    cones and the ldl strategies (tests/test_torch_slice_s.py) are ported
    (mesh=: tests/test_torch_parallel_mesh.py)."""
    tb.make_qp_solver(ConeDims(l=3, q=(3,)), with_eq=True)
    # min |x|^2 / 2 + x0 + x1 with diag(x0, x1) in S^2_+ and x0 + x1 = 1
    P, q = torch.eye(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64)
    G = torch.zeros((4, 2), dtype=torch.float64)
    G[0, 0] = G[3, 1] = -1.0
    h = torch.zeros(4, dtype=torch.float64)
    A, b = torch.ones((1, 2), dtype=torch.float64), torch.ones(
        1, dtype=torch.float64)
    for name in (None, "ldl", "ldl2"):
        out = tb.make_qp_solver(ConeDims(s=(2,)), name)(P, q, G, h, A, b)
        assert int(out[5]) == 1, name
        np.testing.assert_allclose(out[0].numpy(), [0.5, 0.5], atol=1e-6)


def test_problem_to_torch_defaults_to_the_card():
    """A caller who names no device gets the card: where there is none,
    the conversion raises instead of handing back CPU tensors."""
    from kvxopt_tpu_torch.convert import problem_to_torch, scaling_from_jax
    P = np.eye(3)
    if torch.cuda.is_available():
        assert problem_to_torch(P)[0].device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        problem_to_torch(P)
    with pytest.raises((RuntimeError, AssertionError)):
        scaling_from_jax(ConeDims(l=2), np.ones((1, 2)), (), ())
    assert problem_to_torch(P, device="cpu")[0].device.type == "cpu"
