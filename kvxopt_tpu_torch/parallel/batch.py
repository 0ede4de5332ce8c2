"""Scenario batching: solve many cone QPs at once.

Counterpart of kvxopt_tpu/parallel/batch.py.  The JAX package vmapped a
single-instance solve; here the solve itself carries the batch
dimension, with a per-lane status mask in place of vmap's lockstep.
Mesh sharding and the host-dispatch wrapper are not ported (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

import torch

from .. import kkt
from ..cones import ConeDims
from ..kkt import _mv, _tmv
from ..solvers.coneprog import OPTIMAL, Options, _coneqp_core


def _options(options):
    return options if isinstance(options, Options) else Options(
        **(options or {}))


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError("mesh sharding is not ported yet "
                                  "(ROADMAP.md, Queue 1)")


def make_qp_solver(dims, kktsolver=None, options=None, with_eq=False):
    """Returns solve(P, q, G, h[, A, b]) -> state tuple
    (x, y, s, z, iterations, status, metrics).

    The inputs carry a leading batch dimension (P (B,n,n), q (B,n),
    G (B,m,n), h (B,m), A (B,p,n), b (B,p)), in place of the JAX
    package's vmap; a single instance (q of shape (n,)) is solved as a
    batch of one and returned without the batch dimension, as the JAX
    function returns it.  A and b are optional at every call, as in the
    JAX function, which takes with_eq only for its signature.  The KKT
    strategy defaults to 'chol' with q or s cones and 'chol2' otherwise
    (the reference coneqp default)."""
    dims = ConeDims.from_dict(dims)
    o = _options(options)
    if kktsolver is None:
        kktsolver = "chol" if (dims.q or dims.s) else "chol2"
    o = o.resolve_refinement(dims, kktsolver)

    def solve(P, q, G, h, A=None, b=None):
        if q.ndim == 1:
            ab = () if A is None else (A[None], b[None])
            out = solve(P[None], q[None], G[None], h[None], *ab)
            return (*(a[0] for a in out[:6]),
                    type(out[6])(*(a[0] for a in out[6])))
        dtype, dev = q.dtype, q.device
        # cast everything to q's dtype and device
        P, G, h = (a.to(dtype=dtype, device=dev) for a in (P, G, h))
        if A is None:
            A = torch.zeros((q.shape[0], 0, q.shape[1]), dtype=dtype,
                            device=dev)
            b = torch.zeros((q.shape[0], 0), dtype=dtype, device=dev)
        else:
            A, b = (a.to(dtype=dtype, device=dev) for a in (A, b))
        factor = kkt.make_kkt_solver(kktsolver, dims, G, A, P,
                                     reg=o.kktreg, ozaki=o.ozaki,
                                     facref=o.facref)

        def gmv(v, trans=False):
            return _tmv(G, v) if trans else _mv(G, v)

        def amv(v, trans=False):
            return _tmv(A, v) if trans else _mv(A, v)

        def pmv(v):
            return _mv(P, v)

        return _coneqp_core(q, h, b, dims, o, factor, gmv, amv, pmv)

    return solve


def _vmap_facref(options):
    """Factor refinement for batched drivers: the 'vmap' sentinel makes
    the mixed strategies refine exactly when the factor reaches kernel K3
    (a CUDA batch in f32).  Explicit True/False still wins."""
    o = _options(options)
    return o._replace(facref="vmap") if o.facref is None else o


def batched_qp_solver(dims, kktsolver=None, options=None, mesh=None,
                      with_eq=False):
    """solve(P[B], q[B], G[B], h[B][, A[B], b[B]]) -> batched state."""
    _no_mesh(mesh)
    return make_qp_solver(dims, kktsolver, _vmap_facref(options), with_eq)


def batched_qp_solver_mixed(dims, options=None, mesh=None, with_eq=False):
    """Two-pass batched mixed-precision QP driver.

    Pass 1 solves every lane with the 'chol2_mixed_nofb' KKT strategy:
    float32 factorizations on kernel K1 plus float64 operator-form
    refinement (exact-split matvecs unless options say otherwise), with
    no per-lane f64 fallback.  Pass 2 re-solves exactly the lanes whose
    pass-1 status is not 'optimal' with the all-f64 'chol2' path.

    Returns solve(P, q, G, h[, A, b]) -> (x, y, s, z, iterations,
    status, metrics) as tensors on the inputs' device.  solve.stats holds the
    last call's pass-1 status per lane ("pass1_status") and the number
    of lanes pass 2 re-solved ("pass2_lanes")."""
    _no_mesh(mesh)
    o = _options(options)
    if o.ozaki is None:
        o = o._replace(ozaki=True)
    fast = batched_qp_solver(dims, "chol2_mixed_nofb", o, None, with_eq)
    slow = batched_qp_solver(dims, "chol2", options, None, with_eq)

    def solve(P, q, G, h, *ab):
        out = fast(P, q, G, h, *ab)
        bad = torch.nonzero(out[5] != OPTIMAL).flatten()
        solve.stats["pass1_status"] = out[5].tolist()
        solve.stats["pass2_lanes"] = int(bad.numel())
        if bad.numel() == 0:
            return out
        sout = slow(*(a[bad] for a in (P, q, G, h, *ab)))

        def merge(a, s):
            a = a.clone()
            a[bad] = s
            return a
        return (*map(merge, out[:6], sout[:6]),
                type(out[6])(*map(merge, out[6], sout[6])))

    solve.stats = {"pass1_status": [], "pass2_lanes": 0}
    return solve
