"""Scenario batching: solve many cone QPs at once.

Counterpart of kvxopt_tpu/parallel/batch.py.  The JAX package vmapped a
single-instance solve; here the solve itself carries the batch
dimension, with a per-lane status mask in place of vmap's lockstep.
Both IPMs are here: the cone QP (make_qp_solver) and the self-dual
cone LP (make_lp_solver), with the two-pass mixed driver and the
sequential one (batched_qp_solver_seq).  With mesh= the batch drivers
deal the batch over the mesh's 'batch' axis (mesh.py): each rank solves
its slice on its device and every rank gets the whole batch back.
Without a mesh, batched_qp_solver and batched_lp_solver go through
_dispatched_batch: array-like inputs whose per-instance KKT system has
an order n + m + p below config.host_dispatch_threshold_batched are
placed on the CPU and solved there; tensors keep their device, and the
mixed strategies are never routed.  Each QP driver's call is one root
span, `batched_qp` (trace.py).  The drivers take each operand but q (c)
either with the batch dimension or without it, shared by every lane
(one market's risk model across a sweep of q, say): a shared operand is
held once, never copied per lane, and `chol2` keeps it unbatched down
to its GEMMs and kernel K5 (kkt.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config, kkt, trace
from ..cones import ConeDims
from ..solvers._conelp import _conelp_core
from ..solvers.coneprog import (OPTIMAL, Options, _coneqp_core, _matrix_ops,
                                _solve_device, _tree_map)


def _options(options):
    return options if isinstance(options, Options) else Options(
        **(options or {}))


def _tensors(*arrays):
    """The inputs as tensors: tensors as they are, array-likes (numpy)
    on the first tensor's device, else on config.default_device, which
    raises where that is the card and there is none.  A copy to the card
    counts in the call's h2d_bytes."""
    dev = _solve_device(*arrays)
    out = []
    for a in arrays:
        if a is not None and not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a), device=dev)
            trace.count_h2d(a)
        out.append(a)
    return tuple(out)


def _cast(lead, mats, A, b):
    """mats, A and b cast to lead's dtype and device, each keeping its
    shape (a shared operand stays unbatched); A (B, 0, n) and b (B, 0) of
    zeros where A is None."""
    B, n = lead.shape
    mats = tuple(a.to(dtype=lead.dtype, device=lead.device) for a in mats)
    if A is None:
        return mats, lead.new_zeros((B, 0, n)), lead.new_zeros((B, 0))
    A, b = (a.to(dtype=lead.dtype, device=lead.device) for a in (A, b))
    return mats, A, b


# the ranks of one QP instance's P, q, G, h, A and b, and of one LP
# instance's c, G, h, A and b: an operand of one more dimension carries
# the batch, one of this rank is shared by every lane
QP_RANKS = (2, 1, 2, 1, 2, 1)
LP_RANKS = (1, 2, 1, 2, 1)


def _lanes_of(args, ranks, index):
    """args with each batched operand indexed by `index` along its batch;
    shared operands and None as they are."""
    return tuple(a if a is None or np.ndim(a) == r else a[index]
                 for a, r in zip(args, ranks))


def _batch_of(args, ranks, lead):
    """The batch size B (the lanes of args[lead]), after checking that
    every batched operand of args has B lanes and counting the operands'
    bytes in the call's record (trace.count_operands)."""
    B = args[lead].shape[0]
    for i, (a, r) in enumerate(zip(args, ranks)):
        if a is not None and a.ndim == r + 1 and a.shape[0] != B:
            raise ValueError(f"operand {i} has {a.shape[0]} lanes, the "
                             f"batch has {B}")
    trace.count_operands(*args)
    return B


def _kkt_view(kktsolver, B, *mats):
    """The matrices as the KKT strategy takes them: `chol2` reads shared
    ones as they are; the other strategies get a view of each shared one
    with a batch dimension of stride 0 (no copy)."""
    return tuple(M if M is None or M.ndim == 3 or kktsolver == "chol2"
                 else M.expand(B, *M.shape) for M in mats)


def _on_mesh(solve, mesh, ranks, lead):
    """solve(*args) over the 'batch' axis of `mesh` (None: solve itself):
    each rank, called with the whole batch, solves its consecutive slice
    of it (the axis's rank count must divide B, the lanes of args[lead]),
    and the results are gathered, so every rank returns the whole batch,
    lane by lane as solve gives it.  Operands shared by the lanes (of
    their instance's rank in `ranks`) go to every rank whole.  The JAX
    package's pjit over P('batch')."""
    if mesh is None:
        return solve
    from .mesh import Axis
    ax = Axis(mesh, "batch")

    def sharded(*args):
        args = _tensors(*args)
        B = args[lead].shape[0]
        out = solve(*_lanes_of(args, ranks, ax.part(B)))
        return _tree_map(lambda t: ax.gather(t, B), out)
    return sharded


def make_qp_solver(dims, kktsolver=None, options=None, with_eq=False):
    """Returns solve(P, q, G, h[, A, b]) -> state tuple
    (x, y, s, z, iterations, status, metrics).

    q carries a leading batch dimension, q (B,n), in place of the JAX
    package's vmap; each of P, G, h, A and b either carries it too
    (P (B,n,n), G (B,m,n), h (B,m), A (B,p,n), b (B,p)) or is one
    instance's (P (n,n), G (m,n), h (m,), A (p,n), b (p,)), shared by
    every lane and held once: no copy per lane is made.  `chol2` reads a
    shared P, G and A as they are; the other strategies get views of
    them with a batch dimension of stride 0.  A batched operand whose
    lanes differ from q's raises ValueError.  Numpy inputs go to
    config.default_device (the card).  A single instance (q of shape
    (n,)) is solved as a batch of one and returned without the batch
    dimension, as the JAX function returns it.  A and b are optional at
    every call, as in the JAX function, which takes with_eq only for its
    signature.  The call counts its operands' bytes in the record's
    operand_bytes (trace.count_operands).  The KKT strategy defaults to
    'chol' with q or s cones and 'chol2' otherwise (the reference coneqp
    default)."""
    dims = ConeDims.from_dict(dims)
    o = _options(options)
    if kktsolver is None:
        kktsolver = "chol" if (dims.q or dims.s) else "chol2"
    o = o.resolve_refinement(dims, kktsolver)

    def solve(P, q, G, h, A=None, b=None):
        with trace.root("batched_qp"):
            P, q, G, h, A, b = _tensors(P, q, G, h, A, b)
            if q.ndim == 1:
                ab = () if A is None else (A[None], b[None])
                out = solve(P[None], q[None], G[None], h[None], *ab)
                return (*(a[0] for a in out[:6]),
                        type(out[6])(*(a[0] for a in out[6])))
            (P, G, h), A, b = _cast(q, (P, G, h), A, b)
            B = _batch_of((P, q, G, h, A, b), QP_RANKS, 1)
            factor = kkt.make_kkt_solver(
                kktsolver, dims, *_kkt_view(kktsolver, B, G, A, P),
                reg=o.kktreg, ozaki=o.ozaki, facref=o.facref)
            h, b = (v.expand(B, -1) for v in (h, b))
            return _coneqp_core(q, h, b, dims, o, factor,
                                *_matrix_ops(G, A, P))

    return solve


def make_lp_solver(dims, kktsolver=None, options=None):
    """Returns solve(c, G, h[, A, b]) -> conelp state tuple
    (x, y, s, z, tau, kappa, iterations, status, metrics), metrics a dict
    of pcost, dcost, gap, relgap, pres, dres, pinfres and dinfres: the
    conelp counterpart of make_qp_solver, batched the same way (c (B, n),
    G (B, m, n), h (B, m), A (B, p, n), b (B, p), each of G, h, A and b
    batched or shared by the lanes; a single instance is a batch of
    one).  The data are taken as given: s-block rows are not
    symmetrized.  The KKT strategy defaults to 'qr' with q or s cones and
    'chol2' otherwise (the reference conelp default)."""
    dims = ConeDims.from_dict(dims)
    o = _options(options)
    if kktsolver is None:
        kktsolver = "qr" if (dims.q or dims.s) else "chol2"
    o = o.resolve_refinement(dims, kktsolver)

    def solve(c, G, h, A=None, b=None):
        c, G, h, A, b = _tensors(c, G, h, A, b)
        if c.ndim == 1:
            ab = () if A is None else (A[None], b[None])
            out = solve(c[None], G[None], h[None], *ab)
            return (*(a[0] for a in out[:8]),
                    {k: v[0] for k, v in out[8].items()})
        (G, h), A, b = _cast(c, (G, h), A, b)
        B = _batch_of((c, G, h, A, b), LP_RANKS, 0)
        factor = kkt.make_kkt_solver(
            kktsolver, dims, *_kkt_view(kktsolver, B, G, A), None,
            reg=o.kktreg, ozaki=o.ozaki, facref=o.facref)
        h, b = (v.expand(B, -1) for v in (h, b))
        gmv, amv, _ = _matrix_ops(G, A, None)
        return _conelp_core(c, h, b, dims, o, factor, gmv, amv)

    return solve


def _vmap_facref(options):
    """Factor refinement for batched drivers: the 'vmap' sentinel makes
    the mixed strategies refine exactly when the factor reaches kernel K3
    (a CUDA batch in f32).  Explicit True/False still wins."""
    o = _options(options)
    return o._replace(facref="vmap") if o.facref is None else o


def _dispatched_batch(solve, nargs_for_n, kktsolver=None):
    """solve(*args) with executor dispatch at call time, as the front
    ends' coneprog._dispatch_ctx: where the per-instance KKT order
    n + m + p (n the last dimension of args[nargs_for_n], m the rows of
    G, the argument after it, p the rows of A, three after it) is below
    config.host_dispatch_threshold_batched, the call runs under
    config.using_device(config.host_device()), so array-like inputs are
    placed on the CPU and the results stay there.  Tensors keep their
    device: a batch of CUDA tensors stays on the card at every size.

    A mixed-precision strategy ("mixed" in kktsolver) is never routed:
    its f32 factorizations exist to run K1-K3 on the card."""
    mixed = isinstance(kktsolver, str) and "mixed" in kktsolver

    def dispatched(*args, **kwargs):
        A = (args[nargs_for_n + 3] if len(args) > nargs_for_n + 3
             else kwargs.get("A"))
        order = (np.shape(args[nargs_for_n])[-1]
                 + np.shape(args[nargs_for_n + 1])[-2]
                 + (0 if A is None else np.shape(A)[-2]))
        dev = None if mixed else config.dispatch_device_batched(int(order))
        if dev is None:
            return solve(*args, **kwargs)
        with config.using_device(dev):
            return solve(*args, **kwargs)

    return dispatched


def batched_qp_solver(dims, kktsolver=None, options=None, mesh=None,
                      with_eq=False):
    """solve(P[B], q[B], G[B], h[B][, A[B], b[B]]) -> batched state,
    each of P, G, h, A and b batched or shared by the lanes and held
    once (make_qp_solver); with `mesh`, dealt over its 'batch' axis
    (_on_mesh), else routed by the KKT order of q, G and A
    (_dispatched_batch)."""
    solve = make_qp_solver(dims, kktsolver, _vmap_facref(options), with_eq)
    run = (_dispatched_batch(solve, 1, kktsolver) if mesh is None
           else _on_mesh(solve, mesh, QP_RANKS, 1))

    def batched(*args, **kwargs):
        with trace.root("batched_qp"):
            return run(*args, **kwargs)
    return batched


def batched_lp_solver(dims, kktsolver=None, options=None, mesh=None):
    """solve(c[B], G[B], h[B][, A[B], b[B]]) -> batched conelp state,
    each of G, h, A and b batched or shared by the lanes (make_lp_solver);
    with `mesh`, dealt over its 'batch' axis (_on_mesh), else routed by
    the KKT order of c, G and A (_dispatched_batch)."""
    solve = make_lp_solver(dims, kktsolver, _vmap_facref(options))
    if mesh is None:
        return _dispatched_batch(solve, 0, kktsolver)
    return _on_mesh(solve, mesh, LP_RANKS, 0)


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
    of lanes pass 2 re-solved ("pass2_lanes").  With `mesh`, pass 1 is
    dealt over its 'batch' axis (_on_mesh) and every rank runs pass 2 on
    the whole batch's failed lanes, as the JAX function does.  Pass 1
    stays where its inputs are; pass 2 is a batched_qp_solver with
    'chol2' on the failed lanes of the inputs as given, routed as
    _dispatched_batch routes them (array-like inputs below
    config.host_dispatch_threshold_batched to the CPU), and its lanes
    come back to pass 1's device."""
    o = _options(options)
    if o.ozaki is None:
        o = o._replace(ozaki=True)
    fast = batched_qp_solver(dims, "chol2_mixed_nofb", o, mesh, with_eq)
    slow = batched_qp_solver(dims, "chol2", options, None, with_eq)

    def solve(P, q, G, h, *ab):
        with trace.root("batched_qp"):
            out = fast(P, q, G, h, *ab)
            bad = torch.nonzero(out[5] != OPTIMAL).flatten()
            solve.stats["pass1_status"] = out[5].tolist()
            solve.stats["pass2_lanes"] = int(bad.numel())
            if bad.numel() == 0:
                return out

            def lanes(a):
                if isinstance(a, torch.Tensor):
                    return a[bad.to(a.device)]
                return np.asarray(a)[bad.cpu().numpy()]
            sout = slow(*(a if np.ndim(a) == r else lanes(a)
                          for a, r in zip((P, q, G, h, *ab), QP_RANKS)))

            def merge(a, s):
                a = a.clone()
                a[bad] = s.to(a.device)
                return a
            return (*map(merge, out[:6], sout[:6]),
                    type(out[6])(*map(merge, out[6], sout[6])))

    solve.stats = {"pass1_status": [], "pass2_lanes": 0}
    return solve


def batched_qp_solver_seq(dims, kktsolver="chol2_mixed", options=None,
                          with_eq=False, group=1):
    """Sequential batch driver: solve(P, q, G, h[, A, b]) solves the
    batch `group` lanes at a time, one slice after the other, and
    returns the state tuple (x, y, s, z, iterations, status, metrics)
    of batched_qp_solver.

    The JAX package's lax.map of the single-instance solve: each slice
    keeps its own trip counts, and the per-lane f64-factor fallback of
    plain 'chol2_mixed' (kkt.cond_any) runs only where a lane of the
    slice needs it, so no second pass re-solves failed lanes.  A lane
    that ends 'singular' stays so.  With group > 1 the exact-split
    (ozaki) refinement matvecs default to on, as in the JAX function.
    Factor refinement follows options (None: config.factor_refine): the
    driver is not vmapped, so the "vmap" sentinel does not apply.  The
    batch must divide into groups."""
    if group > 1:
        o = _options(options)
        if o.ozaki is None:
            options = o._replace(ozaki=True)
    solve_slice = make_qp_solver(dims, kktsolver, options, with_eq)

    def solve(P, q, G, h, *ab):
        with trace.root("batched_qp"):
            args = _tensors(P, q, G, h, *ab)
            B = args[1].shape[0]
            if B % group:
                raise ValueError(f"batch {B} not divisible by group {group}")
            outs = [solve_slice(*_lanes_of(args, QP_RANKS,
                                           slice(i, i + group)))
                    for i in range(0, B, group)]
            return (*(torch.cat(f) for f in list(zip(*outs))[:6]),
                    type(outs[0][6])(*(torch.cat(f) for f in
                                       zip(*(o[6] for o in outs)))))

    return solve
