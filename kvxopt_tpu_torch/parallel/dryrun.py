"""dryrun_multichip: the multi-device layer end to end on a spawned world.

Counterpart of __graft_entry__.dryrun_multichip, its five parts on
n_devices ranks at the same small shapes:

  1. a scenario batch of QPs over the 'batch' axis of a (n/2, 2)
     ('batch', 'kkt') mesh: every lane optimal, its KKT residuals small;
  2. coneqp on l + q + s cones through sharded_kkt_solver over 'kkt';
  3. arrow_kkt_factor with the blocks dealt over 'kkt': the residual of
     the whole arrow system small;
  4. (n_devices a multiple of 4) a 2 x n/2 ('dcn', 'ici') mesh:
     dist_cholesky over both axes (L L' = K) and sharded_kkt_solver over
     the axis tuple;
  5. (the same) coneqp through sharded_kkt_solver(dist_nb=...), K two
     block-column cycles wide.

Every check raises on failure, in the rank that fails; spawn then fails
the call.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config


def _example_qp(B, n, m, seed=0):
    """__graft_entry__._example_qp's problems, numpy f64."""
    rng = np.random.default_rng(seed)
    Ps = np.zeros((B, n, n))
    qs = np.zeros((B, n))
    Gs = np.zeros((B, m, n))
    hs = np.zeros((B, m))
    for i in range(B):
        M = rng.standard_normal((n, n))
        Ps[i] = M @ M.T + n * np.eye(n)
        qs[i] = rng.standard_normal(n)
        Gs[i] = rng.standard_normal((m, n))
        hs[i] = Gs[i] @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
    return Ps, qs, Gs, hs


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _rank(rank, world, device):
    """The five parts on one rank; returns a summary of rank 0's results
    (numpy and Python numbers)."""
    from ..cones import ConeDims
    from ..solvers import coneqp
    from .arrow import arrow_kkt_factor
    from .batch import batched_qp_solver
    from .dist_chol import cyclic_unpack, dist_cholesky, gather_stack
    from .mesh import make_mesh
    from .sharded import sharded_kkt_solver

    config.set_default_device(device)
    dt = config.default_dtype

    def T(a):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    out = {}
    shape = (world // 2, 2) if world % 2 == 0 else (world, 1)
    mesh = make_mesh(world, ("batch", "kkt"), shape=shape)

    # 1) scenario batch over 'batch'
    nbt = shape[0]
    B, n, m = 2 * nbt, 4, 6
    Ps, qs, Gs, hs = _example_qp(B, n, m, seed=1)
    x, y, s, z, it, status, _ = batched_qp_solver(
        ConeDims(l=m), mesh=mesh)(*(T(a) for a in (Ps, qs, Gs, hs)))
    status = status.cpu().numpy()
    _check((status == 1).all(), f"batch: status {status}")
    xh, zh, sh = (a.cpu().numpy() for a in (x, z, s))
    for i in range(B):
        rdual = Ps[i] @ xh[i] + qs[i] + Gs[i].T @ zh[i]
        rpri = Gs[i] @ xh[i] + sh[i] - hs[i]
        _check(np.linalg.norm(rdual) / (1 + np.linalg.norm(qs[i])) < 1e-4
               and np.linalg.norm(rpri) / (1 + np.linalg.norm(hs[i])) < 1e-4,
               f"batch: lane {i} residuals")
    out["batch"] = dict(status=status, iterations=it.cpu().numpy(), x=xh)

    # 2) coneqp through the tensor-parallel factor over 'kkt'
    nk = shape[1]
    rng = np.random.default_rng(2)
    dims2 = ConeDims(l=2 * nk, q=(3,) * nk, s=(2,) * nk)
    ncols = 5
    Gm = rng.standard_normal((dims2.size, ncols))
    for ofs, mm in zip(dims2.sofs, dims2.s):
        for j in range(ncols):
            X = Gm[ofs:ofs + mm * mm, j].reshape(mm, mm)
            Gm[ofs:ofs + mm * mm, j] = (0.5 * (X + X.T)).ravel()
    x0 = rng.standard_normal(ncols)
    s0 = np.zeros(dims2.size)
    s0[:dims2.l] = rng.uniform(0.5, 1.5, dims2.l)
    for ofs in dims2.qofs:
        s0[ofs] = 1.0
    for ofs, mm in zip(dims2.sofs, dims2.s):
        s0[ofs:ofs + mm * mm] = np.eye(mm).ravel()
    h2, q2, P2 = Gm @ x0 + s0, rng.standard_normal(ncols), np.eye(ncols) * 2
    factor = sharded_kkt_solver(mesh, "kkt", dims2, T(Gm), Pmat=T(P2))
    sol = coneqp(T(P2), T(q2), T(Gm), T(h2), dims2, kktsolver=factor)
    _check(sol["status"] == "optimal", f"sharded coneqp: {sol['status']}")
    _check(bool(torch.isfinite(sol["x"]).all()), "sharded coneqp: x")
    out["sharded"] = dict(x=sol["x"].cpu().numpy(),
                          iterations=sol["iterations"])

    # 3) arrow blocks dealt over 'kkt'
    Bb, nbk, ncb = 2 * nk, 8, 4
    Dm = np.stack([np.eye(nbk) * (i + 2.0) for i in range(Bb)])
    Cm = rng.standard_normal((Bb, nbk, ncb)) * 0.1
    Em = np.eye(ncb) * 5.0
    asolve, _ = arrow_kkt_factor(T(Dm), T(Cm), T(Em), mesh=mesh)
    bblk, bbrd = rng.standard_normal((Bb, nbk)), rng.standard_normal(ncb)
    xb, xc = (a.cpu().numpy() for a in asolve(T(bblk), T(bbrd)))
    r_blk = np.einsum("bij,bj->bi", Dm, xb) + Cm @ xc - bblk
    r_brd = np.einsum("bij,bi->j", Cm, xb) + Em @ xc - bbrd
    nrm = 1.0 + np.linalg.norm(bblk) + np.linalg.norm(bbrd)
    _check(np.linalg.norm(r_blk) / nrm < 1e-4 and
           np.linalg.norm(r_brd) / nrm < 1e-4, "arrow: residual")
    out["arrow"] = dict(xblk=xb, xbrd=xc)

    if world % 4:
        return out if rank == 0 else None
    # 4) a hierarchical mesh: dist_cholesky and the sharded factor over
    # ('dcn', 'ici')
    ax2 = ("dcn", "ici")
    hmesh = make_mesh(world, ax2, shape=(2, world // 2))
    nbig, nb = 16 * world, 4
    Mx = rng.standard_normal((nbig, nbig))
    Kbig = Mx @ Mx.T + nbig * np.eye(nbig)
    Ll, dsolve = dist_cholesky(hmesh, ax2, T(Kbig), nb)
    L = cyclic_unpack(gather_stack(hmesh, ax2, Ll), nb, world).cpu().numpy()
    _check(np.allclose(L @ L.T, Kbig, atol=1e-6 * nbig), "dist_cholesky")
    xx = dsolve(Ll, T(rng.standard_normal(nbig)))
    _check(bool(torch.isfinite(xx).all()), "dist_cholesky: solve")
    from ..cones import compute_scaling
    from ..convert import scaling_instance
    dims4 = ConeDims(l=4 * world)
    G4 = rng.standard_normal((dims4.l, 3))
    fac4 = sharded_kkt_solver(hmesh, ax2, dims4, T(G4), Pmat=T(np.eye(3) * 2))
    W4, _ = compute_scaling(dims4, T(rng.uniform(0.5, 1.5, dims4.l))[None],
                            T(rng.uniform(0.5, 1.5, dims4.l))[None])
    ux, _, _ = fac4(scaling_instance(dims4, W4))(
        T(rng.standard_normal(3)), T(np.zeros(0)),
        T(rng.standard_normal(dims4.l)))
    _check(bool(torch.isfinite(ux).all()), "sharded over ('dcn', 'ici')")
    out["dist_chol"] = dict(L=L)

    # 5) coneqp through the distributed factor, two block-column cycles
    nkkt = 32 * world
    nb5 = nkkt // (2 * world)
    rng5 = np.random.default_rng(5)
    A5 = rng5.standard_normal((nkkt, nkkt)) / np.sqrt(nkkt)
    K5 = A5 @ A5.T + np.eye(nkkt)
    Ll5, _ = dist_cholesky(hmesh, ax2, T(K5), nb5)
    L5 = cyclic_unpack(gather_stack(hmesh, ax2, Ll5), nb5, world)
    L5 = L5.cpu().numpy()
    _check(np.allclose(L5 @ L5.T, K5, atol=1e-8 * nkkt), "dist_cholesky 5")
    m5 = nkkt + nkkt // 2
    G5 = rng5.standard_normal((m5, nkkt)) / np.sqrt(nkkt)
    h5 = G5 @ rng5.standard_normal(nkkt) + rng5.uniform(0.5, 1.5, m5)
    q5, P5 = rng5.standard_normal(nkkt), np.eye(nkkt) * 2.0
    dims5 = ConeDims(l=m5)
    fac5 = sharded_kkt_solver(hmesh, ax2, dims5, T(G5), Pmat=T(P5),
                              dist_nb=nb5)
    sol5 = coneqp(T(P5), T(q5), T(G5), T(h5), dims5, kktsolver=fac5,
                  options={"maxiters": 50})
    _check(sol5["status"] == "optimal", f"dist coneqp: {sol5['status']}")
    _check(bool(torch.isfinite(sol5["x"]).all()), "dist coneqp: x")
    out["dist"] = dict(x=sol5["x"].cpu().numpy(),
                       iterations=sol5["iterations"])
    return out if rank == 0 else None


def dryrun_multichip(n_devices: int, backend=None, device=None,
                     timeout=600.0):
    """Run the five parts on a world of n_devices spawned ranks and
    return rank 0's results (a dict of numpy arrays per part).  device
    and backend as spawn takes them: None is the card, NCCL where each
    rank has a card of its own."""
    from .mesh import spawn
    return spawn(_rank, n_devices, backend, device, timeout=timeout)
