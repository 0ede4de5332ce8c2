"""The port's multi-device layer against kvxopt_tpu.parallel, at small
size on the CPU.

The port side runs in gloo worlds of 2 and 4 ranks (parallel.spawn, one
spawn per world size for the whole module: every rank pays the package's
import once); tests/torch_mesh_ranks.py holds the data, built from the
seeds of tests/test_parallel.py, and the calls each rank makes.  The JAX
side runs the same data on the conftest's virtual CPU devices.  The bars:
a KKT solve, sharded_kkt_factor, arrow_kkt_factor and dist_cholesky to
1e-10; coneqp, conelp and cpl through the sharded factor the same
status, iterations within 1 and x to 1e-7 (cpl: as JAX's dense cpl); the
batch drivers with mesh=
lane by lane equal to the port without a mesh (1e-12) and as the JAX
drivers (status, iterations within 1, x to 1e-6).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from kvxopt_tpu import cones as jcones
from kvxopt_tpu import kkt as jkkt
from kvxopt_tpu import parallel as jpar
from kvxopt_tpu import solvers as jsolvers
from kvxopt_tpu.cones import ConeDims as JaxDims
from kvxopt_tpu.solvers.cvxprog import oracle_from_function
from kvxopt_tpu_torch import ConeDims, config
from kvxopt_tpu_torch.parallel import (batched_lp_solver, batched_qp_solver,
                                       batched_qp_solver_mixed, cyclic_pack,
                                       cyclic_unpack, make_mesh, spawn)
from kvxopt_tpu_torch.parallel.dryrun import dryrun_multichip
from kvxopt_tpu_torch.parallel.mesh import _default_backend

from . import torch_mesh_ranks as R

SPAWN_S = 300.0   # each spawn's join timeout


def jdims(d):
    return JaxDims(l=d.l, q=tuple(d.q), s=tuple(d.s))


def jmesh(axes=("kkt",), shape=(8,)):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, axes)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    """(world size, rank 0's results of torch_mesh_ranks.work)."""
    n = request.param
    return n, spawn(R.work, n, device="cpu", timeout=SPAWN_S)


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=0)


def same_solve(port, ref, tol=1e-7):
    assert port["status"] == ref["status"] == "optimal"
    assert abs(port["iterations"] - ref["iterations"]) <= 1
    close(port["x"], ref["x"], tol)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


def test_make_mesh_refuses_a_wrong_world_size(world):
    assert world[1]["make_mesh_errors"] == [True, True, True]


def test_sharded_kkt_solver_matches_chol2(world):
    """test_parallel.py:290's l + q + s solve against JAX's chol2."""
    d = R.solver_data()
    dims = jdims(d["dims"])
    W, _ = jcones.compute_scaling(dims, jnp.asarray(d["s"]),
                                  jnp.asarray(d["z"]))
    ref = jkkt.make_kkt_solver("chol2", dims, jnp.asarray(d["G"]),
                               jnp.asarray(d["A"]), jnp.asarray(d["P"]))(W)
    for u, r in zip(world[1]["solver"], ref(*(jnp.asarray(d[k])
                                              for k in ("bx", "by", "bz")))):
        close(u, r, 1e-10)


def test_sharded_over_the_axis_tuple(world):
    """test_parallel.py:450 over ('dcn', 'ici') at world 4: the residuals
    of [0 G'; G -W'W] and JAX's sharded solve over the same tuple."""
    n, out = world
    if n % 4:
        assert "hier" not in out
        return
    d = R.hier_data()
    dims = jdims(d["dims"])
    W, _ = jcones.compute_scaling(dims, jnp.asarray(d["s"]),
                                  jnp.asarray(d["z"]))
    ref = jpar.sharded_kkt_solver(jmesh(("dcn", "ici"), (2, 4)),
                                  ("dcn", "ici"), dims, d["G"])(W)(
        jnp.asarray(d["bx"]), jnp.zeros((0,)), jnp.asarray(d["bz"]))
    ux, _, uz = out["hier"]
    d2 = np.asarray(W.d) ** 2
    assert np.linalg.norm(d["G"].T @ uz - d["bx"]) < 1e-8
    assert np.linalg.norm(d["G"] @ ux - d2 * uz - d["bz"]) < 1e-8
    close(ux, ref[0], 1e-10)
    close(uz, ref[2], 1e-10)


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX package's coneqp, conelp and coneqp(dist_nb) through its
    sharded_kkt_solver on 8 virtual devices."""
    mesh = jmesh()
    d = R.coneqp_data()
    f = jpar.sharded_kkt_solver(mesh, "kkt", jdims(d["dims"]), d["G"],
                                A=d["A"], Pmat=d["P"])
    out = {"coneqp": jsolvers.coneqp(d["P"], d["q"], d["G"], d["h"],
                                     jdims(d["dims"]), d["A"], d["b"],
                                     kktsolver=f)}
    d = R.conelp_data()
    f = jpar.sharded_kkt_solver(mesh, "kkt", jdims(d["dims"]), d["G"])
    out["conelp"] = jsolvers.conelp(d["c"], d["G"], d["h"], jdims(d["dims"]),
                                    kktsolver=f)
    d = R.dist_qp_data()
    f = jpar.sharded_kkt_solver(jmesh(), "kkt", jdims(d["dims"]), d["G"],
                                Pmat=d["P"], dist_nb=d["nb"])
    out["dist_qp"] = jsolvers.coneqp(d["P"], d["q"], d["G"], d["h"],
                                     jdims(d["dims"]), kktsolver=f)
    d = R.cpl_data()
    F = oracle_from_function(
        lambda x: jnp.atleast_1d(jnp.sum(x ** 2) - 1.0), np.zeros(4))
    out["cpl"] = jsolvers.cpl(d["c"], F, d["G"], d["h"], jdims(d["dims"]))
    return out


@pytest.mark.parametrize("call", ["coneqp", "conelp", "dist_qp"])
def test_solves_through_the_sharded_factor(world, jax_solves, call):
    """coneqp (l + q + s, A, P), conelp and coneqp through dist_nb=2 (over
    ('dcn', 'ici') at world 4) through sharded_kkt_solver: JAX's status,
    iterations within 1, x to 1e-7."""
    same_solve(world[1][call], jax_solves[call])


def test_cpl_through_the_sharded_factor(world, jax_solves):
    """test_parallel.py:384: cpl with its nonlinear row kept whole on
    every rank, and the port's cpl with its default factor, each as
    JAX's dense cpl on the same data (the same optimum)."""
    sharded, dense = world[1]["cpl"]
    same_solve(sharded, jax_solves["cpl"])
    same_solve(dense, jax_solves["cpl"])


def test_sharded_kkt_factor(world):
    """test_parallel.py:72: K, ux and uz as JAX's sharded_kkt_factor's."""
    d = R.factor_data()
    mesh = jmesh()
    solve, K = jpar.sharded_kkt_factor(mesh, "kkt", jnp.asarray(d["G"]),
                                       jnp.asarray(d["d"]),
                                       Pmat=jnp.asarray(d["P"]))
    ux, uz = solve(jnp.asarray(d["bx"]), jnp.asarray(d["bz"]))
    Kp, uxp, uzp = world[1]["factor"]
    close(Kp, K, 1e-10)
    close(uxp, ux, 1e-10)
    close(uzp, uz, 1e-10)


@pytest.mark.parametrize("case", ["plain False", "mesh False", "mesh True"])
def test_arrow_kkt_factor(world, case):
    """test_parallel.py:117's arrow data (B=5, and B=8 with and without a
    mesh): S, xblk and xbrd as JAX's, to 1e-10; K x = b."""
    name, with_mesh = case.split()
    B, nb, nc, seed = R.ARROW[name]
    D, C, E, K, bblk, bbrd = R.arrow_data(B, nb, nc, seed)
    mesh = jmesh() if with_mesh == "True" else None
    solve, S = jpar.arrow_kkt_factor(jnp.asarray(D), jnp.asarray(C),
                                     jnp.asarray(E), mesh=mesh)
    xblk, xbrd = solve(jnp.asarray(bblk), jnp.asarray(bbrd))
    Sp, xb, xc = world[1][f"arrow {case}"]
    close(Sp, S, 1e-10)
    close(xb, xblk, 1e-10)
    close(xc, xbrd, 1e-10)
    x = np.concatenate([xb.reshape(-1), xc])
    close(K @ x, np.concatenate([bblk.reshape(-1), bbrd]), 1e-8)


@pytest.mark.parametrize("n, nb, ndev", [(12, 3, 2), (16, 2, 4), (8, 4, 1)])
def test_cyclic_pack_round_trip(n, nb, ndev):
    """cyclic_pack as JAX's, and cyclic_unpack its inverse."""
    K = np.random.default_rng(n).standard_normal((n, n))
    st, nloc = cyclic_pack(torch.as_tensor(K), nb, ndev)
    jst, jnloc = jpar.cyclic_pack(jnp.asarray(K), nb, ndev)
    assert nloc == jnloc
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(cyclic_unpack(st, nb, ndev).numpy(), K)
    with pytest.raises(ValueError):
        cyclic_pack(torch.as_tensor(K), nb, 5)


def test_dist_cholesky(world):
    """test_parallel.py:411 (n=256, nb=16) on a 2 x 2 ('dcn', 'ici') mesh
    at world 4 (a 1-D one at world 2): L and the solve as JAX's on the
    same mesh shape, to 1e-10; L lower triangular."""
    n, out = world
    d = R.dist_chol_data()
    mesh, ax = ((jmesh(("dcn", "ici"), (2, 2)), ("dcn", "ici")) if n == 4
                else (jmesh(("kkt",), (2,)), "kkt"))
    Lst, solve = jpar.dist_cholesky(mesh, ax, d["K"], d["nb"])
    L = np.asarray(jpar.cyclic_unpack(Lst, d["nb"], n))
    Lp, xp = out["dist_chol"]
    assert np.array_equal(np.tril(Lp), Lp)
    close(Lp, L, 1e-10)
    close(xp, solve(Lst, jnp.asarray(d["b"])), 1e-10)


@pytest.fixture(scope="module")
def no_mesh():
    """The port's batch drivers without a mesh and the JAX package's
    vmapped drivers on the same data (CPU)."""
    with config.using_device("cpu"):
        qb = [torch.as_tensor(a) for a in R.qp_batch(*R.QP_BATCH)]
        lb = [torch.as_tensor(a) for a in R.lp_batch(*R.LP_BATCH)]
        dq, dl = ConeDims(l=R.QP_BATCH[2]), ConeDims(l=R.LP_BATCH[2])
        port = {"batch_qp": batched_qp_solver(dq)(*qb),
                "batch_mixed": batched_qp_solver_mixed(dq)(*qb),
                "batch_lp": batched_lp_solver(dl)(*lb)}
    jq = [jnp.asarray(a) for a in R.qp_batch(*R.QP_BATCH)]
    jl = [jnp.asarray(a) for a in R.lp_batch(*R.LP_BATCH)]
    ref = {"batch_qp": jpar.batched_qp_solver(jdims(dq))(*jq),
           "batch_mixed": jpar.batched_qp_solver_mixed(jdims(dq))(*jq),
           "batch_lp": jpar.batched_lp_solver(jdims(dl))(*jl)}
    return R.numpy_of(port), R.numpy_of(ref)


@pytest.mark.parametrize("driver", ["batch_qp", "batch_mixed", "batch_lp"])
def test_batch_drivers_with_a_mesh(world, no_mesh, driver):
    """mesh= on the three batch drivers: every leaf lane by lane as the
    port without a mesh (1e-12), and as JAX's: status, iterations within
    1, x (x/tau for the LP) to 1e-6."""
    out = world[1][driver]
    port, ref = no_mesh[0][driver], no_mesh[1][driver]
    flat = jax.tree_util.tree_leaves
    for a, b in zip(flat(out), flat(port)):
        assert a.shape == b.shape
        close(a, b, 1e-12)
    lp = driver == "batch_lp"
    st, it = (7, 6) if lp else (5, 4)
    assert (out[st] == 1).all()
    np.testing.assert_array_equal(out[st], np.asarray(ref[st]))
    assert (np.abs(out[it] - np.asarray(ref[it])) <= 1).all()
    x = out[0] / (out[4][:, None] if lp else 1.0)
    xj = np.asarray(ref[0]) / (np.asarray(ref[4])[:, None] if lp else 1.0)
    close(x, xj, 1e-6)


@pytest.mark.parametrize("driver", ["batch_qp_shared", "batch_lp_shared"])
def test_batch_drivers_with_shared_operands_and_a_mesh(world, driver):
    """mesh= with G and h (and the QP's P) shared by the lanes: every
    rank gets them whole; status and iterations are lane by lane as the
    port's without a mesh, and every leaf within 1e-10 (the QP) or 1e-8
    (the LP, x, s and z over tau): a shared operand's product is one
    GEMM over the rank's lanes, whose rounding depends on how many lanes
    it holds (the batched drivers' products are per lane, and match to
    1e-12)."""
    lp = driver == "batch_lp_shared"
    with config.using_device("cpu"):
        data = R.lp_shared(*R.LP_BATCH) if lp else R.qp_shared(*R.QP_BATCH)
        drv = (batched_lp_solver(ConeDims(l=R.LP_BATCH[2])) if lp
               else batched_qp_solver(ConeDims(l=R.QP_BATCH[2])))
        port = R.numpy_of(drv(*(torch.as_tensor(a) for a in data)))
    out = world[1][driver]
    st, it = (7, 6) if lp else (5, 4)
    assert (out[st] == 1).all()
    np.testing.assert_array_equal(out[st], port[st])
    np.testing.assert_array_equal(out[it], port[it])
    if lp:
        for a, b in zip(out[:4], port[:4]):
            assert a.shape == b.shape
            close(a / out[4][:, None], b / port[4][:, None], 1e-8)
        return
    flat = jax.tree_util.tree_leaves
    for a, b in zip(flat(out), flat(port)):
        assert a.shape == b.shape
        close(a, b, 1e-10)


def test_dryrun_multichip():
    """dryrun_multichip(4): __graft_entry__'s five parts on a gloo world of
    4 CPU ranks; every check inside the ranks holds."""
    out = dryrun_multichip(4, device="cpu", timeout=SPAWN_S)
    assert (out["batch"]["status"] == 1).all()
    assert set(out) == {"batch", "sharded", "arrow", "dist_chol", "dist"}


def test_spawn_fails_on_a_failing_or_hanging_rank():
    """A rank that raises fails the call with its traceback; one that
    hangs fails it at the timeout; no rank is left running."""
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        spawn(R.raises, 2, device="cpu", timeout=SPAWN_S)
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\]"):
        spawn(R.hangs, 2, device="cpu", timeout=10.0)


def test_spawn_defaults_to_the_card(monkeypatch):
    """With no device named the ranks go to the card, and with no card
    spawn raises before it starts a process: nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(config, "default_device", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(R.raises, 2, timeout=SPAWN_S)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2, timeout=SPAWN_S)


@pytest.mark.parametrize("device, world, cards, backend", [
    ("cpu", 2, 0, "gloo"), ("cuda:0", 1, 1, "nccl"), ("cuda", 1, 1, "nccl"),
    ("cuda:0", 2, 1, "gloo"), ("cuda", 4, 4, "nccl"), ("cuda", 4, 1, "gloo")])
def test_spawn_default_backend(monkeypatch, device, world, cards, backend):
    """NCCL where every rank has a card of its own, gloo otherwise."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert _default_backend(torch.device(device), world) == backend
