"""The rank side of tests/test_torch_parallel_mesh.py: the numpy data of
tests/test_parallel.py's multi-device cases, built from their seeds, and
the port's calls on them in each rank of a spawned gloo world (work).

Every rank imports this module, so it imports torch and the port and
never jax; the test module computes the JAX side from the same data.
"""

import numpy as np
import torch

from kvxopt_tpu_torch import ConeDims, config


def cone_interior(dims, seed):
    """tests/test_parallel.py's _cone_interior: a strictly interior point
    of the product cone."""
    r = np.random.default_rng(seed)
    u = np.zeros(dims.size)
    u[:dims.l] = r.uniform(0.5, 2.0, dims.l)
    for ofs, m in zip(dims.qofs, dims.q):
        t = r.standard_normal(m) * 0.1
        t[0] = 1.0 + np.linalg.norm(t[1:])
        u[ofs:ofs + m] = t
    for ofs, m in zip(dims.sofs, dims.s):
        M = r.standard_normal((m, m)) * 0.2
        u[ofs:ofs + m * m] = (M @ M.T + np.eye(m)).ravel()
    return u


def symmetrize_sblocks(dims, G):
    G = np.asarray(G).copy()
    for ofs, m in zip(dims.sofs, dims.s):
        for j in range(G.shape[1]):
            X = G[ofs:ofs + m * m, j].reshape(m, m)
            G[ofs:ofs + m * m, j] = (0.5 * (X + X.T)).ravel()
    return G


def solver_data():
    """test_parallel.py:290: l + q + s cones with A and P, one KKT solve."""
    rng = np.random.default_rng(0)
    dims = ConeDims(l=7, q=(3, 4, 3), s=(3, 2))
    n, p = 6, 2
    G = rng.standard_normal((dims.size, n))
    A = rng.standard_normal((p, n))
    return dict(dims=dims, G=G, A=A, P=np.eye(n) * 2.0,
                s=cone_interior(dims, 1), z=cone_interior(dims, 2),
                bx=rng.standard_normal(n), by=rng.standard_normal(p),
                bz=cone_interior(dims, 3))


def coneqp_data():
    """test_parallel.py:335: coneqp on l + q + s cones with A and P."""
    rng = np.random.default_rng(5)
    dims = ConeDims(l=6, q=(3, 3), s=(2,))
    n, p = 5, 2
    G = symmetrize_sblocks(dims, rng.standard_normal((dims.size, n)))
    A = rng.standard_normal((p, n))
    x0 = rng.standard_normal(n)
    h = G @ x0 + cone_interior(dims, 6)
    return dict(dims=dims, P=np.eye(n) * 2.0, q=rng.standard_normal(n),
                G=G, h=h, A=A, b=A @ x0)


def conelp_data():
    """test_parallel.py:363: an LP through conelp."""
    rng = np.random.default_rng(7)
    n, m = 4, 16
    G = np.vstack([rng.standard_normal((m - 2 * n, n)), np.eye(n),
                   -np.eye(n)])
    h = np.concatenate([rng.uniform(1, 2, m - 2 * n), np.full(2 * n, 5.0)])
    return dict(dims=ConeDims(l=m), c=rng.standard_normal(n), G=G, h=h)


def dist_qp_data():
    """test_parallel.py:480: coneqp through the distributed factor."""
    rng = np.random.default_rng(13)
    n, m = 24, 64
    G = rng.standard_normal((m, n))
    x0 = rng.standard_normal(n)
    h = G @ x0 + rng.uniform(0.5, 1.5, m)
    return dict(dims=ConeDims(l=m), P=np.eye(n) * 2.0, G=G, h=h,
                q=rng.standard_normal(n), nb=2)


def cpl_data():
    """test_parallel.py:384: cpl with |x|^2 <= 1 over a box."""
    rng = np.random.default_rng(21)
    n, m = 4, 8
    return dict(dims=ConeDims(l=m), G=np.vstack([np.eye(n), -np.eye(n)]),
                h=np.full(m, 2.0), c=rng.standard_normal(n))


def factor_data():
    """test_parallel.py:72: the l-cone sharded_kkt_factor."""
    rng = np.random.default_rng(3)
    n, m = 16, 64
    G = rng.standard_normal((m, n))
    d = rng.uniform(0.5, 2.0, m)
    return dict(G=G, d=d, P=np.eye(n), bx=rng.standard_normal(n),
                bz=rng.standard_normal(m))


def arrow_data(B, nb, nc, seed):
    """test_parallel.py:117's _arrow_data with the right-hand sides of
    its two tests: (D, C, E, K, bblk, bbrd)."""
    rng = np.random.default_rng(seed)
    D = np.zeros((B, nb, nb))
    C = rng.standard_normal((B, nb, nc))
    for i in range(B):
        M = rng.standard_normal((nb, nb))
        D[i] = M @ M.T + nb * np.eye(nb)
    E = np.eye(nc) * (nc + 10.0)
    n = B * nb + nc
    K = np.zeros((n, n))
    for i in range(B):
        K[i * nb:(i + 1) * nb, i * nb:(i + 1) * nb] = D[i]
        K[i * nb:(i + 1) * nb, B * nb:] = C[i]
        K[B * nb:, i * nb:(i + 1) * nb] = C[i].T
    K[B * nb:, B * nb:] = E
    r = np.random.default_rng(seed + 1)
    return D, C, E, K, r.standard_normal((B, nb)), r.standard_normal(nc)


ARROW = {"plain": (5, 8, 4, 5), "mesh": (8, 8, 4, 7)}


def dist_chol_data():
    """test_parallel.py:411: K (256 x 256) with nb = 16, and b."""
    rng = np.random.default_rng(11)
    n = 256
    M = rng.standard_normal((n, n))
    return dict(K=M @ M.T + n * np.eye(n), b=rng.standard_normal(n), nb=16)


def hier_data():
    """test_parallel.py:450: the sharded factor over ('dcn', 'ici')."""
    rng = np.random.default_rng(12)
    n, m = 24, 64
    G = rng.standard_normal((m, n))
    s = np.abs(rng.standard_normal(m)) + 0.5
    z = np.abs(rng.standard_normal(m)) + 0.5
    return dict(dims=ConeDims(l=m), G=G, s=s, z=z,
                bx=rng.standard_normal(n), bz=rng.standard_normal(m))


def qp_batch(B, n, m, seed):
    """test_parallel.py's _random_qp_batch, numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        M = rng.standard_normal((n, n))
        q = rng.standard_normal(n)
        G = rng.standard_normal((m, n))
        h = G @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
        out.append((M @ M.T + n * np.eye(n), q, G, h))
    return tuple(np.stack(a) for a in zip(*out))


def qp_shared(B, n, m, seed):
    """qp_batch's q over its lane 0's P, G and h, which every lane
    shares (unbatched)."""
    P, q, G, h = qp_batch(B, n, m, seed)
    return P[0], q, G[0], h[0]


def lp_batch(B, n, m, seed):
    """test_parallel.py:89's LP scenarios, numpy."""
    rng = np.random.default_rng(seed)
    cs, Gs, hs = [], [], []
    for _ in range(B):
        cs.append(rng.standard_normal(n))
        Gs.append(np.vstack([rng.standard_normal((m - 2 * n, n)),
                             np.eye(n), -np.eye(n)]))
        hs.append(np.concatenate([rng.uniform(1, 2, m - 2 * n),
                                  np.full(2 * n, 5.0)]))
    return np.stack(cs), np.stack(Gs), np.stack(hs)


def lp_shared(B, n, m, seed):
    """lp_batch's c over its lane 0's G and h, shared by every lane."""
    c, G, h = lp_batch(B, n, m, seed)
    return c, G[0], h[0]


QP_BATCH = (8, 6, 9, 2)     # test_parallel.py:57
LP_BATCH = (4, 5, 12, 4)    # test_parallel.py:89, B a multiple of 4


def numpy_of(out):
    """A solver's output with numpy leaves."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if isinstance(out, dict):
        return {k: numpy_of(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return tuple(numpy_of(v) for v in out)
    return out


def _solve_result(sol, keys=("x", "y", "z")):
    return {k: numpy_of(sol[k]) for k in ("status", "iterations") + keys}


def work(rank, world, device):
    """The port's side of every case, in one rank of a world of `world`
    gloo ranks on the CPU; rank 0's results are returned (numpy)."""
    from kvxopt_tpu_torch import solvers
    from kvxopt_tpu_torch.cones import compute_scaling
    from kvxopt_tpu_torch.convert import scaling_instance
    from kvxopt_tpu_torch.parallel import (
        arrow_kkt_factor, batched_lp_solver, batched_qp_solver,
        batched_qp_solver_mixed, cyclic_unpack, dist_cholesky, make_mesh,
        sharded_kkt_factor, sharded_kkt_solver)
    from kvxopt_tpu_torch.parallel.dist_chol import gather_stack
    from kvxopt_tpu_torch.solvers.cvxprog import oracle_from_function

    config.set_default_device(device)

    def T(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64)
    out = {}
    kkt = make_mesh(world, ("kkt",))
    batch = make_mesh(world)
    if world % 4 == 0:
        hier, hax = make_mesh(world, ("dcn", "ici"),
                              shape=(2, world // 2)), ("dcn", "ici")
    else:
        hier, hax = kkt, "kkt"
    errors = []
    for bad in (dict(n_devices=world + 1), dict(shape=(world + 1,)),
                dict(axis_names=("a", "b"))):
        try:
            make_mesh(**bad)
            errors.append(False)
        except ValueError:
            errors.append(True)
    out["make_mesh_errors"] = errors

    d = solver_data()
    W, _ = compute_scaling(d["dims"], T(d["s"])[None], T(d["z"])[None])
    solve = sharded_kkt_solver(kkt, "kkt", d["dims"], T(d["G"]), A=T(d["A"]),
                               Pmat=T(d["P"]))(scaling_instance(d["dims"], W))
    out["solver"] = numpy_of(solve(T(d["bx"]), T(d["by"]), T(d["bz"])))

    d = coneqp_data()
    f = sharded_kkt_solver(kkt, "kkt", d["dims"], T(d["G"]), A=T(d["A"]),
                           Pmat=T(d["P"]))
    out["coneqp"] = _solve_result(solvers.coneqp(
        d["P"], d["q"], d["G"], d["h"], d["dims"], d["A"], d["b"],
        kktsolver=f))

    d = conelp_data()
    f = sharded_kkt_solver(kkt, "kkt", d["dims"], T(d["G"]))
    out["conelp"] = _solve_result(solvers.conelp(d["c"], d["G"], d["h"],
                                                 d["dims"], kktsolver=f))

    d = dist_qp_data()
    f = sharded_kkt_solver(hier, hax, d["dims"], T(d["G"]), Pmat=T(d["P"]),
                           dist_nb=d["nb"])
    out["dist_qp"] = _solve_result(solvers.coneqp(
        d["P"], d["q"], d["G"], d["h"], d["dims"], kktsolver=f))

    d = cpl_data()
    F = oracle_from_function(lambda x: torch.sum(x ** 2) - 1.0,
                             np.zeros(4))
    f = sharded_kkt_solver(kkt, "kkt", d["dims"], T(d["G"]))
    out["cpl"] = [_solve_result(solvers.cpl(
        d["c"], F, d["G"], d["h"], d["dims"], kktsolver=kt), ("x",))
        for kt in (f, None)]

    d = factor_data()
    fsolve, K = sharded_kkt_factor(kkt, "kkt", T(d["G"]), T(d["d"]),
                                   Pmat=T(d["P"]))
    out["factor"] = (numpy_of(K),
                     *numpy_of(fsolve(T(d["bx"]), T(d["bz"]))))

    for name, (B, nb, nc, seed) in ARROW.items():
        D, C, E, _, bblk, bbrd = arrow_data(B, nb, nc, seed)
        for mesh in (None, kkt) if name == "mesh" else (None,):
            asolve, S = arrow_kkt_factor(T(D), T(C), T(E), mesh=mesh)
            out[f"arrow {name} {mesh is not None}"] = (
                numpy_of(S), *numpy_of(asolve(T(bblk), T(bbrd))))

    d = dist_chol_data()
    Ll, dsolve = dist_cholesky(hier, hax, T(d["K"]), d["nb"])
    L = cyclic_unpack(gather_stack(hier, hax, Ll), d["nb"], world)
    out["dist_chol"] = (numpy_of(L), numpy_of(dsolve(Ll, T(d["b"]))))

    if world % 4 == 0:
        d = hier_data()
        W, _ = compute_scaling(d["dims"], T(d["s"])[None], T(d["z"])[None])
        solve = sharded_kkt_solver(hier, hax, d["dims"], T(d["G"]))(
            scaling_instance(d["dims"], W))
        out["hier"] = numpy_of(solve(T(d["bx"]), T(np.zeros(0)),
                                     T(d["bz"])))

    qb = [T(a) for a in qp_batch(*QP_BATCH)]
    dims = ConeDims(l=QP_BATCH[2])
    out["batch_qp"] = numpy_of(batched_qp_solver(dims, mesh=batch)(*qb))
    out["batch_mixed"] = numpy_of(batched_qp_solver_mixed(dims,
                                                          mesh=batch)(*qb))
    out["batch_qp_shared"] = numpy_of(batched_qp_solver(dims, mesh=batch)(
        *(T(a) for a in qp_shared(*QP_BATCH))))
    lb = [T(a) for a in lp_batch(*LP_BATCH)]
    out["batch_lp"] = numpy_of(batched_lp_solver(
        ConeDims(l=LP_BATCH[2]), mesh=batch)(*lb))
    out["batch_lp_shared"] = numpy_of(batched_lp_solver(
        ConeDims(l=LP_BATCH[2]), mesh=batch)(
            *(T(a) for a in lp_shared(*LP_BATCH))))
    return out


def raises(rank, world, device):
    """A rank function whose rank 1 fails."""
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def hangs(rank, world, device):
    """A rank function whose rank 1 never returns."""
    import time
    if rank == 1:
        time.sleep(3600)
    return rank
