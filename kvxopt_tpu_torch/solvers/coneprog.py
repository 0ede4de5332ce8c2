"""Cone QPs: the batched interior-point core and the coneqp/qp front ends.

Counterpart of kvxopt_tpu/solvers/coneprog.py.  The core is the
primal-dual Mehrotra predictor-corrector with Nesterov-Todd scaling,
run as a Python loop over tensors that hold a whole batch of problems,
one lane per problem.  A lane whose status is no longer RUNNING keeps
its state, its iteration count and its metrics while the other lanes
iterate, as under the JAX package's vmapped lax.while_loop.

The front ends take plain arrays (or tensors), solve one instance as a
batch of one, and return the reference's result dictionary.  Array-like
inputs go to config.default_device (the card); tensors keep their own
device.  The vector-space operations of custom x and y spaces (VecOps)
live here; coneqp, conelp, cpl and cp take them, and the batched cores
reach a space only through _LaneSpace (dense lanes) or _UserSpace (a
custom space, a batch of one).  options['profile'] = <directory> runs a
coneqp or conelp solve under torch.profiler and writes its Chrome trace
there (trace._profile_ctx); qp and coneqp open the root span of their
call, and the core its spans (trace.py).  Executor dispatch: before any
array is placed, a front end sizes its solve from shape metadata alone
(_veclen): the
order n + m + p of its KKT system (_kkt_order).  Below
config.host_dispatch_threshold it runs the solve under
config.using_device(config.host_device()) (_dispatch_ctx), so array-like
inputs go to the CPU; tensors passed in keep their device.  The
`solver=` routes (osqp, gurobi, mosek) live beside the conelp ones in
_conelp.py and are not routed, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import cones, config, kkt, trace
from ..cones import ConeDims
from ..kkt import _mv, _tmv

# status codes
RUNNING, OPTIMAL, UNKNOWN, PRIMAL_INFEASIBLE, DUAL_INFEASIBLE, SINGULAR = (
    0, 1, 2, 3, 4, 5)

_STATUS_STR = {
    OPTIMAL: "optimal",
    UNKNOWN: "unknown",
    PRIMAL_INFEASIBLE: "primal infeasible",
    DUAL_INFEASIBLE: "dual infeasible",
    SINGULAR: "unknown",
}

STEP = 0.99   # fraction-to-boundary (reference coneprog.py:424)
EXPON = 3     # sigma exponent (reference coneprog.py:423)


class Options(NamedTuple):
    maxiters: int = 100
    abstol: float = 1e-7
    reltol: float = 1e-6
    feastol: float = 1e-7
    refinement: int = -1   # -1 = auto: 1 with q/s cones else 0
    show_progress: bool = False
    kktreg: float = 0.0
    sscaling: str = "eigh"  # s-block NT construction, 'eigh' or 'svd';
                            # the coneqp core uses the default, as the
                            # JAX package's does
    facref: object = None   # factor refinement of the mixed strategies:
                            # None = config.factor_refine, True/False force
    ozaki: object = None    # exact-split refinement matvecs of the mixed
                            # strategies: None = config.ozaki_refine

    def resolve_refinement(self, dims, kktsolver=None):
        """-1 (auto) resolves to the reference default (1 with q/s cones
        else 0), and to at least 1 with a mixed-precision KKT strategy:
        without an outer refinement step the f32 factor + PCG solve
        leaves lanes stalled at status 'unknown' at 1e-7 tolerances."""
        if self.refinement >= 0:
            return self
        auto = 1 if (dims.q or dims.s) else 0
        if isinstance(kktsolver, str) and "mixed" in kktsolver:
            auto = max(auto, 1)
        return self._replace(refinement=auto)


def _merged_options(options):
    """The global solvers.options with the per-call options over them."""
    from . import options as global_options
    merged = dict(global_options)
    if options:
        merged.update(options)
    return merged


def _resolve_options(options):
    """(Options, dtype) of _merged_options(options); the 'dtype' key picks
    the solve's dtype (default config.default_dtype)."""
    merged = _merged_options(options)
    o = Options(
        maxiters=int(merged.get("maxiters", 100)),
        abstol=float(merged.get("abstol", 1e-7)),
        reltol=float(merged.get("reltol", 1e-6)),
        feastol=float(merged.get("feastol", 1e-7)),
        refinement=int(merged.get("refinement", -1)),
        show_progress=bool(merged.get("show_progress", False)),
        kktreg=float(merged.get("kktreg", 0.0) or 0.0),
        sscaling=str(merged.get("sscaling", "eigh")),
        ozaki=bool(merged.get("ozaki", config.ozaki_refine)),
        facref=bool(merged.get("facref", config.factor_refine)),
    )
    dtype = config._torch_dtype(merged.get("dtype", None) or
                                config.default_dtype)
    return o, dtype


def _solve_device(*args):
    """The device of a front-end solve: that of the first tensor among
    args, else config.default_device.  Raises where that is the card and
    there is none: nothing falls back to the CPU."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    dev = config.default_device
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass tensors on another device, or name one "
            "with kvxopt_tpu_torch.config.set_default_device('cpu')")
    return dev


def _asarray(x, dtype, device, shape=None, name="argument"):
    """x as a tensor of `dtype` on `device`; (n, 1) becomes (n,) where a
    vector is expected, and `shape` is checked.  A copy from host memory
    to the card counts in the call's h2d_bytes."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        a = x.to(device=device, dtype=dtype)
        if x.device.type == "cpu":
            trace.count_h2d(a)
    else:
        a = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        trace.count_h2d(a)
    if a.ndim == 2 and a.shape[1] == 1 and (shape is None or len(shape) == 1):
        a = a[:, 0]
    if shape is not None and tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                         f"{tuple(shape)}")
    return a


def _veclen(x):
    """Element count of a vector-like argument from its shape metadata
    alone (numpy arrays, tensors, matrix/spmatrix through their .size
    tuple, lists and tuples by len); None where it cannot be read."""
    if x is None:
        return None
    try:
        shp = getattr(x, "shape", None)
        if shp is not None and not callable(shp):
            return int(np.prod([int(d) for d in shp])) if len(shp) else 1
        sz = getattr(x, "size", None)
        if isinstance(sz, tuple):
            return int(sz[0]) * int(sz[1])
        return len(x)
    except Exception:
        return None


def _kkt_order(n, *rows):
    """The order of a solve's KKT system from the element counts of its
    variable (n) and of its constraint blocks (h, b, the nonlinear rows),
    each from _veclen: n + m + p.  None where n is unknown; an unknown
    block counts 0."""
    if n is None:
        return None
    return n + sum(r for r in rows if r is not None)


def _dispatch_ctx(*sizes):
    """The executor context of a solve whose KKT system has order
    ~max(sizes) (_kkt_order; None entries are unknown sizes): the host
    (config.using_device(config.host_device())) below
    config.host_dispatch_threshold, else a null context.  See
    config.dispatch_device."""
    known = [s for s in sizes if s is not None]
    if not known:
        return contextlib.nullcontext()
    dev = config.dispatch_device(max(known))
    if dev is None:
        return contextlib.nullcontext()
    return config.using_device(dev)


def _numel(x):
    return x.numel() if isinstance(x, torch.Tensor) else np.asarray(x).size


# ---------------------------------------------------------------------------
# Custom vector spaces (the reference's third customization level,
# coneprog.py:378-402: xnewcopy/xdot/xscal/xaxpy and the y* variants), as
# kvxopt_tpu/solvers/coneprog.py renders them: an element is a tensor, or
# a dict, list or tuple of them, nested; the hooks are pure functions
# (xscal returns the scaled element, xaxpy returns alpha*u + v).
# ---------------------------------------------------------------------------

def _tree_leaves(u):
    """The tensors of an element, dict entries in key order (as JAX
    orders a pytree's leaves); None is an empty node."""
    if isinstance(u, dict):
        return [a for k in sorted(u) for a in _tree_leaves(u[k])]
    if isinstance(u, (list, tuple)):
        return [a for v in u for a in _tree_leaves(v)]
    return [] if u is None else [u]


def _tree_map(fn, u, *rest):
    """fn over the leaves of u and of the elements in rest, which have
    u's structure."""
    if isinstance(u, dict):
        return {k: _tree_map(fn, u[k], *(r[k] for r in rest)) for k in u}
    if isinstance(u, (list, tuple)):
        items = [_tree_map(fn, *vs) for vs in zip(u, *rest)]
        return type(u)(*items) if hasattr(u, "_fields") else type(u)(items)
    return None if u is None else fn(u, *rest)


def _tree_dot(u, v):
    s = 0.0
    for a, b in zip(_tree_leaves(u), _tree_leaves(v)):
        s = s + torch.sum(a * b)
    return s


def _tree_scal(alpha, u):
    return _tree_map(lambda a: alpha * a, u)


def _tree_axpy(u, v, alpha=1.0):
    return _tree_map(lambda a, b: alpha * a + b, u, v)


class VecOps(NamedTuple):
    """Inner-product-space operations for one variable block (x or y):
    the functional form of the reference's xnewcopy/xdot/xscal/xaxpy
    contract (reference coneprog.py:378-402); the defaults handle any
    nesting of tensors."""

    dot: object = _tree_dot
    scal: object = _tree_scal
    axpy: object = _tree_axpy
    copy: object = lambda u: u  # the hooks never write in place

    def norm(self, u):
        return torch.sqrt(torch.clamp(torch.as_tensor(self.dot(u, u)),
                                      min=0.0))

    def zero(self, like):
        return _tree_map(torch.zeros_like, like)


def _make_vecops(newcopy, dot, scal, axpy):
    kw = {}
    if dot is not None:
        kw["dot"] = dot
    if scal is not None:
        kw["scal"] = scal
    if axpy is not None:
        kw["axpy"] = axpy
    if newcopy is not None:
        kw["copy"] = newcopy
    return VecOps(**kw)


DEFAULT_VECOPS = VecOps()


class _Lanes:
    """How a solve keeps the elements of a dense space: as a batch of
    one, (1, k) tensors of `dtype` on `device`; the user's callables see
    and return one instance's (k,) vectors."""

    def __init__(self, dtype, device):
        self.dtype, self.device = dtype, device

    def to_user(self, u):
        return u[0]

    def from_user(self, w):
        return torch.as_tensor(w, dtype=self.dtype,
                               device=self.device).reshape(-1)[None]


class _AsGiven:
    """A custom vector space: the solve keeps the user's elements as they
    are."""

    @staticmethod
    def to_user(u):
        return u

    @staticmethod
    def from_user(w):
        return w


class _LaneSpace:
    """The batched cores' operations on a dense space: elements are
    (B, k) tensors, one lane per problem, and a scalar is one per lane,
    (B,); alpha is a float or such a tensor.  dot1, scal1 and lane work
    on one lane's (k,) vector."""

    @staticmethod
    def size(u):
        return u.shape[-1]

    @staticmethod
    def dot(u, v):
        return torch.sum(u * v, dim=-1)

    @staticmethod
    def norm(u):
        return torch.linalg.vector_norm(u, dim=-1)

    @staticmethod
    def scal(alpha, u):
        return (alpha[:, None] if isinstance(alpha, torch.Tensor)
                else alpha) * u

    @staticmethod
    def axpy(u, v, alpha=1.0):
        """alpha u + v (v - u for alpha = -1, as bits go the same)."""
        if isinstance(alpha, torch.Tensor):
            return alpha[:, None] * u + v
        if alpha == 1.0:
            return u + v
        if alpha == -1.0:
            return v - u
        return alpha * u + v

    @staticmethod
    def where(mask, a, b):
        return _where(mask, a, b)

    zero = staticmethod(torch.zeros_like)

    @staticmethod
    def lane(u, i):
        return u[i]

    dot1 = staticmethod(torch.dot)

    @staticmethod
    def scal1(alpha, u):
        return u * alpha


LANES = _LaneSpace()


class _UserSpace:
    """The batched cores' operations on a custom space (VecOps `ops`) in
    a solve of one problem: elements are the user's, as given, and a
    scalar is a (1,) tensor of `dtype` on `device`; the hooks get alpha
    as a float or a 0-d tensor.  A select on the lane maps torch.where
    over the element's leaves."""

    def __init__(self, ops, dtype, device):
        self.ops, self.dtype, self.device = ops, dtype, device

    def _lanes(self, a):
        return torch.as_tensor(a, dtype=self.dtype,
                               device=self.device).reshape(1)

    @staticmethod
    def _scalar(alpha):
        return alpha.reshape(()) if isinstance(alpha, torch.Tensor) else alpha

    @staticmethod
    def size(u):
        return 1

    def dot(self, u, v):
        return self._lanes(self.ops.dot(u, v))

    def norm(self, u):
        return self._lanes(self.ops.norm(u))

    def scal(self, alpha, u):
        return self.ops.scal(self._scalar(alpha), u)

    def axpy(self, u, v, alpha=1.0):
        return self.ops.axpy(u, v, self._scalar(alpha))

    @staticmethod
    def where(mask, a, b):
        return _tree_map(lambda u, v: torch.where(mask[0], u, v), a, b)

    def zero(self, u):
        return self.ops.zero(u)

    @staticmethod
    def lane(u, i):
        return u

    def dot1(self, u, v):
        return self.ops.dot(u, v)

    def scal1(self, alpha, u):
        return self.ops.scal(alpha, u)


def _spaces(dtype, device, xops, yops):
    """(xs, ys, zs, xsp, ysp) of a front-end solve: how the solve hands
    x, y and cone vectors to the user (_Lanes, or _AsGiven for a custom
    space) and the cores' operations on x and y (LANES or a _UserSpace);
    xops and yops are the VecOps of custom spaces, else None."""
    lanes = _Lanes(dtype, device)
    return ((lanes if xops is None else _AsGiven),
            (lanes if yops is None else _AsGiven), lanes,
            (LANES if xops is None else _UserSpace(xops, dtype, device)),
            (LANES if yops is None else _UserSpace(yops, dtype, device)))


def _start(space, v, dtype, device, name):
    """A starting point's vector: the user's element as given in a custom
    space (_AsGiven), else a batch of one of `dtype` on `device`."""
    return v if space is _AsGiven else _asarray(v, dtype, device,
                                                name=name)[None]


def _custom_ops(newcopy, dot, scal, axpy):
    """The VecOps of a custom space where any of its hooks is given, else
    None."""
    if all(f is None for f in (newcopy, dot, scal, axpy)):
        return None
    return _make_vecops(newcopy, dot, scal, axpy)


def _matrix_ops(G, A, P):
    """gmv, amv and pmv of batched matrices G (B, m, n), A (B, p, n) and
    P (B, n, n); gmv and amv take trans=True for G' and A'."""
    def gmv(v, trans=False):
        return _tmv(G, v) if trans else _mv(G, v)

    def amv(v, trans=False):
        return _tmv(A, v) if trans else _mv(A, v)

    def pmv(v):
        return _mv(P, v)

    return gmv, amv, pmv


def _instance_op(f, dom=None, cod=None):
    """A user operator on one instance's elements, f(u) from dom to cod
    and f(v, trans=True) back, as an operator on the solve's elements:
    each space a _Lanes or _AsGiven, by default _Lanes of the argument's
    dtype and device (a batch of one, (1, k) tensors)."""
    def op(v, trans=False):
        src, dst = (cod, dom) if trans else (dom, cod)
        if src is None or dst is None:
            lanes = _Lanes(v.dtype, v.device)
            src, dst = src or lanes, dst or lanes
        u = src.to_user(v)
        return dst.from_user(f(u, trans=True) if trans else f(u))
    return op


def _instance_factor(kktsolver, dims, xspace=None, yspace=None):
    """A user kktsolver(W) -> solve(bx, by, bz) on one instance as a KKT
    strategy over a batch of one: W reaches it in the JAX package's
    layout (convert.scaling_instance).  Where the caller passes H and Df
    (cpl's oracle: matrices or operators of one instance), the user's
    kktsolver(W, H=H, Df=Df) gets them as they are.  solve works on
    unbatched vectors: xspace and yspace carry bx, by and their results
    between the solve and the user (default: _Lanes, lane 0 of a (1, k)
    tensor; _AsGiven for a custom space)."""
    from ..convert import scaling_instance

    def factor(W, H=None, Df=None):
        Wi = scaling_instance(dims, W)
        solve1 = (kktsolver(Wi) if H is None and Df is None
                  else kktsolver(Wi, H=H, Df=Df))

        def solve(bx, by, bz):
            lanes = _Lanes(bz.dtype, bz.device)
            xs, ys = xspace or lanes, yspace or lanes
            ux, uy, uz = solve1(xs.to_user(bx), ys.to_user(by), bz[0])
            return xs.from_user(ux), ys.from_user(uy), lanes.from_user(uz)
        return solve
    return factor


def _constraints(G, h, dims, A, b, n, dtype, dev, custom_y=False):
    """The front ends' constraint data as batches of one: (dims, h (1, m),
    b (1, p), G (1, m, n), A (1, p, n)), G and A None where they are
    operators, A None where it is missing in a custom x space (n None),
    b as given in a custom y space.  The s blocks of G and h are made
    symmetric from their lower triangle (column-major storage)."""
    if dims is None:
        dims = ConeDims(l=int(_numel(h)))
    dims = ConeDims.from_dict(dims)
    if dims.degree == 0:
        raise ValueError("the cone must be nonempty")
    h = cones.sym_from_lower(dims, _asarray(
        h, dtype, dev, shape=(dims.size,), name="h")[None])
    if not custom_y:
        b = (_asarray(b, dtype, dev, name="b") if b is not None
             else torch.zeros((0,), dtype=dtype, device=dev))[None]
    Ga = None if callable(G) else cones.sym_from_lower_cols(dims, _asarray(
        G, dtype, dev, shape=(dims.size, n), name="G")[None])
    Aa = None if callable(A) or (A is None and n is None) else (
        torch.zeros((1, 0, n), dtype=dtype, device=dev) if A is None
        else _asarray(A, dtype, dev, shape=(b.shape[1], n), name="A")[None])
    return dims, h, b, Ga, Aa


def _front_end_ops(dims, o, kktsolver, given, batched, xs, ys, zs):
    """(factor, gmv, amv, pmv) of a front-end solve: `given` the caller's
    (G, A, P), `batched` their batch-of-one tensors (None for an
    operator); xs, ys and zs carry x, y and cone vectors between the
    solve and the user (_spaces).  A named strategy factors the tensors;
    operators need the caller's own kktsolver."""
    if isinstance(kktsolver, str):
        if any(callable(M) for M in given):
            raise ValueError("operator-form P/G/A require a custom kktsolver")
        factor = kkt.make_kkt_solver(kktsolver, dims, *batched, reg=o.kktreg,
                                     ozaki=o.ozaki, facref=o.facref)
    else:
        factor = _instance_factor(kktsolver, dims, xs, ys)
    domains = ((xs, zs), (xs, ys), (xs, xs))   # G, A, P
    return (factor, *(_instance_op(M, *dc) if callable(M) else op
                      for M, op, dc in zip(given, _matrix_ops(*batched),
                                           domains)))


class Metrics(NamedTuple):
    pcost: torch.Tensor
    dcost: torch.Tensor
    gap: torch.Tensor
    relgap: torch.Tensor
    pres: torch.Tensor
    dres: torch.Tensor


def _relgap(gap, pcost, dcost):
    inf = torch.full_like(gap, math.inf)
    return torch.where(pcost < 0.0, gap / (-pcost),
                       torch.where(dcost > 0.0, gap / dcost, inf))


def _result_dict(status, x, y, s, z, dims, metrics, iterations):
    """Result dictionary of one lane (scalars and per-lane vectors)."""
    res = {
        "status": _STATUS_STR.get(int(status), "unknown"),
        "x": x, "y": y, "s": s, "z": z,
        "iterations": int(iterations),
    }
    res.update(metrics)
    return res


def _where(mask, a, b):
    """Per-lane select: mask (B,), a and b (B, ...)."""
    return torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def _qp_metrics_dict(dims, m: Metrics, s, z):
    """The metrics of one lane's result dictionary: m holds 0-d tensors,
    s and z are (size,)."""
    relgap = float(m.relgap)
    ts, tz = cones.max_step2(dims, s[None], z[None])
    return {
        "primal objective": float(m.pcost),
        "dual objective": float(m.dcost),
        "gap": float(m.gap),
        "relative gap": None if not math.isfinite(relgap) else relgap,
        "primal infeasibility": float(m.pres),
        "dual infeasibility": float(m.dres),
        "primal slack": -float(ts[0]),
        "dual slack": -float(tz[0]),
    }


def _coneqp_core(q, h, b, dims: ConeDims, o: Options, factor, gmv, amv,
                 pmv, init=None, xsp=LANES, ysp=LANES):
    """Batched coneqp driver: q (B, n), h (B, m), b (B, p), `factor(W)` a
    KKT strategy over the batch, gmv/amv/pmv batched operator products
    (gmv and amv take trans=True for G' and A'); init, if given, the
    starting (x, y, s, z), each (B, .).  xsp and ysp are the operations
    on the x and y spaces (LANES, or a _UserSpace with q or b and the
    iterates the user's elements, B = 1).  Returns the final state
    (x, y, s, z, iterations, status, metrics)."""
    B, dtype, dev = h.shape[0], h.dtype, h.device
    p = ysp.size(b)
    deg = dims.degree

    def dot(u, v):
        return torch.sum(u * v, dim=-1)

    def newton(solve, lmbda, W, rx, ry, rz, d_target):
        """Solve the Newton system for a given complementarity target."""
        with trace.span("cone"):
            tmp = cones.sinv(dims, lmbda, d_target)
            bz = -rz - cones.scale(dims, W, tmp, trans=True)
        bx, by = xsp.scal(-1.0, rx), ysp.scal(-1.0, ry)
        with trace.span("kkt.solve"):
            dx, dy, dz = solve(bx, by, bz)
        for _ in range(o.refinement):
            # residuals of the full (unscaled) Newton system
            t = pmv(dx)
            if p:
                t = xsp.axpy(amv(dy, trans=True), t)
            r1 = xsp.axpy(xsp.axpy(gmv(dz, trans=True), t), bx, -1.0)
            r2 = ysp.axpy(amv(dx), by, -1.0) if p else by
            wtwdz = cones.scale(dims, W, cones.scale(dims, W, dz),
                                trans=True)
            r3 = bz - (gmv(dx) - wtwdz)
            with trace.span("kkt.solve"):
                ex, ey, ez = solve(r1, r2, r3)
            dx = xsp.axpy(ex, dx)
            dy = ysp.axpy(ey, dy) if p else dy
            dz = dz + ez
        with trace.span("cone"):
            ds = cones.scale(dims, W, tmp - cones.scale(dims, W, dz),
                             trans=True)
        return dx, dy, dz, ds

    def initial_point():
        if init is not None:
            return init
        W0 = cones.identity_scaling(dims, B, dtype, dev)
        with trace.span("kkt.factor"):
            solve0 = factor(W0)
        with trace.span("kkt.solve"):
            x0, y0, z0 = solve0(xsp.scal(-1.0, q), b, h)
        s0 = -z0
        ts, tz = cones.max_step2(dims, s0, z0)
        s0 = _where(ts >= -1e-8 * torch.clamp(torch.abs(ts), min=1.0),
                    s0 + (1.0 + ts)[:, None] * e, s0)
        z0 = _where(tz >= -1e-8 * torch.clamp(torch.abs(tz), min=1.0),
                    z0 + (1.0 + tz)[:, None] * e, z0)
        return x0, y0, s0, z0

    def metrics_of(x, y, s, z):
        rx = xsp.axpy(pmv(x), xsp.axpy(gmv(z, trans=True), q))
        if p:
            rx = xsp.axpy(amv(y, trans=True), rx)
        ry = ysp.axpy(b, amv(x), -1.0) if p else b
        rz = gmv(x) + s - h
        gap = cones.sdot(dims, s, z)
        pcost = 0.5 * xsp.dot(x, pmv(x)) + xsp.dot(q, x)
        dcost = pcost + (ysp.dot(y, ry) if p else 0.0) + \
            cones.sdot(dims, z, rz) - gap
        pres = torch.clamp(cones.snrm2(dims, rz) / resz0, min=0.0)
        if p:
            pres = torch.maximum(ysp.norm(ry) / resy0, pres)
        dres = xsp.norm(rx) / resx0
        return rx, ry, rz, Metrics(pcost, dcost, gap,
                                   _relgap(gap, pcost, dcost), pres, dres)

    def do_step(x, y, s, z, rx, ry, rz, m, lanes):
        trace.count("ipm.steps")
        with trace.span("cone"):
            W, lmbda = cones.compute_scaling(dims, s, z)
            lmbdasq = cones.ssqr(dims, lmbda)
        with trace.span("kkt.factor"):
            solve = factor(W) if lanes is None else factor(W, fallback=lanes)
        weak = getattr(solve, "weak", None)
        mu = m.gap / deg

        # Mehrotra predictor, then corrector
        dx, dy, dz, ds = newton(solve, lmbda, W, rx, ry, rz, -lmbdasq)
        tinv = None
        for phase in range(2):
            if phase:
                stp = torch.where(tinv <= 0.0, torch.ones_like(tinv),
                                  torch.clamp(1.0 / tinv, max=1.0))
                mu_aff = cones.sdot(dims, s + stp[:, None] * ds,
                                    z + stp[:, None] * dz) / deg
                sigma = torch.clamp(mu_aff / mu, 0.0, 1.0) ** EXPON
                with trace.span("cone"):
                    combined = (-lmbdasq - cones.sprod(dims, ds_w, dz_w) +
                                (sigma * mu)[:, None] * e)
                dx, dy, dz, ds = newton(solve, lmbda, W, rx, ry, rz,
                                        combined)
            with trace.span("cone"):
                ds_w = cones.scale(dims, W, ds, trans=True, inverse=True)
                dz_w = cones.scale(dims, W, dz)
                ts, tz = cones.max_step2(dims,
                                         cones.scale2(dims, lmbda, ds_w),
                                         cones.scale2(dims, lmbda, dz_w))
            tinv = torch.clamp(torch.maximum(ts, tz), min=0.0)
        step = torch.clamp(STEP * torch.where(
            tinv <= 0.0, torch.full_like(tinv, 1.0 / STEP),
            torch.clamp(1.0 / tinv, max=1.0 / STEP)), max=1.0)

        xn = xsp.axpy(dx, x, step)
        yn = ysp.axpy(dy, y, step) if p else y
        sn = s + step[:, None] * ds
        zn = z + step[:, None] * dz
        bad = ~torch.isfinite(xsp.dot(xn, xn) + dot(sn, sn) + dot(zn, zn))
        return (xsp.where(bad, x, xn), ysp.where(bad, y, yn),
                _where(bad, s, sn), _where(bad, z, zn), bad, weak)

    # A lane whose step is not finite keeps its iterate.  Where the KKT
    # strategy can serve lanes on a fallback (kkt.make_kkt_solver's
    # lane_fallback: chol2 on ldl), the lane is flagged and steps again
    # from it on the fallback until it ends; it ends SINGULAR where a step
    # on the fallback is not finite too.  Elsewhere it ends SINGULAR.  A
    # lane whose factor the strategy reads as about to break down (the
    # solve's `weak`) keeps its step and is flagged too.
    can_fall_back = getattr(factor, "lane_fallback", False)

    with trace.span("ipm"):
        with trace.span("sync"):
            # its index list is copied to the device: the host waits
            e = cones.cone_e(dims, dtype, dev)
        resx0 = torch.clamp(xsp.norm(q), min=1.0)
        resy0 = torch.clamp(ysp.norm(b), min=1.0)
        resz0 = torch.clamp(cones.snrm2(dims, h), min=1.0)
        x, y, s, z = initial_point()
        m = metrics_of(x, y, s, z)[3]
        it = torch.zeros((B,), dtype=torch.int32, device=dev)
        status = torch.full((B,), RUNNING, dtype=torch.int32, device=dev)
        if can_fall_back:
            flagged = torch.zeros((B,), dtype=torch.bool, device=dev)
            # the record says the call could fall back, on 0 lanes so far
            trace.count("kkt.fallback_lanes", 0)
        if o.show_progress:
            print("     pcost       dcost       gap    pres   dres")
        while _any(status == RUNNING):
            live = status == RUNNING
            rx, ry, rz, mm = metrics_of(x, y, s, z)
            if o.show_progress:
                with trace.span("sync"):
                    for i in torch.nonzero(live).flatten().tolist():
                        print(f"{int(it[i]):2d}: {float(mm.pcost[i]): .4e} "
                              f"{float(mm.dcost[i]): .4e} "
                              f"{float(mm.gap[i]): .0e} "
                              f"{float(mm.pres[i]): .0e} "
                              f"{float(mm.dres[i]): .0e}")
            converged = (mm.pres <= o.feastol) & (mm.dres <= o.feastol) & (
                (mm.gap <= o.abstol) | (torch.isfinite(mm.relgap) &
                                        (mm.relgap <= o.reltol)))
            new_status = torch.where(
                converged, OPTIMAL,
                torch.where(it >= o.maxiters, UNKNOWN, RUNNING)).to(
                    torch.int32)
            stepping = live & (new_status == RUNNING)
            go, lanes = (_any_flagged(stepping, flagged) if can_fall_back
                         else (_any(stepping), None))
            if go:
                xn, yn, sn, zn, bad, weak = do_step(x, y, s, z, rx, ry, rz,
                                                    mm, lanes)
                x = xsp.where(stepping, xn, x)
                y = ysp.where(stepping, yn, y)
                s = _where(stepping, sn, s)
                z = _where(stepping, zn, z)
                if can_fall_back:
                    # no `stepping &`: a lane that does not step now never
                    # steps again, and _any_flagged names stepping lanes
                    bad, flagged = bad & flagged, flagged | bad
                    if weak is not None:
                        flagged = flagged | weak
                new_status = torch.where(stepping & bad, SINGULAR,
                                         new_status)
            status = torch.where(live, new_status, status)
            it = torch.where(live, it + 1, it)
            m = Metrics(*(torch.where(live, a, b_) for a, b_ in zip(mm, m)))
        return x, y, s, z, it, status, m


def _any(mask):
    """bool(mask.any()): the loop's wait for the device."""
    with trace.span("sync"):
        return bool(mask.any())


def _any_flagged(stepping, flagged):
    """(bool(stepping.any()), the indices of the lanes that step and are
    flagged, a host array, or None where there are none), read in the one
    wait for the device that _any(stepping) makes."""
    with trace.span("sync"):
        v = torch.stack([stepping, flagged]).cpu().numpy()
    lanes = np.flatnonzero(v[0] & v[1])
    return bool(v[0].any()), (lanes if lanes.size else None)


def coneqp(P, q, G=None, h=None, dims=None, A=None, b=None, initvals=None,
           kktsolver=None, options=None, xnewcopy=None, xdot=None,
           xscal=None, xaxpy=None, ynewcopy=None, ydot=None, yscal=None,
           yaxpy=None):
    """Solve the cone QP

        minimize    (1/2) x'Px + q'x
        subject to  G x + s = h,  s in K
                    A x = b

    (reference coneprog.py:1440) and return the reference's result
    dictionary: status, x/y/s/z (tensors on the solve's device), primal
    and dual objective, gap, relative gap, primal and dual infeasibility,
    primal and dual slack, iterations.

    The s blocks of G and h are read from their lower triangle
    (column-major storage).  P, G and A may be operators, P(v) and
    G(v, trans=False) on one instance's vectors, with a custom
    kktsolver(W) -> solve(bx, by, bz): W holds d, and beta, v, r and rti
    one entry per q or s block (convert.scaling_instance).  initvals
    may be partial: x and y default to zero, s and z to the cone's
    identity.  options['profile'] = <directory> writes the solve's
    torch.profiler trace there (trace._profile_ctx).

    Custom vector spaces (reference coneprog.py:378-402): passing any of
    xnewcopy/xdot/xscal/xaxpy makes x and q elements of the user's
    space, as given (tensors, or dicts, lists or tuples of them, nested);
    P and G must then be operators and kktsolver the user's, whose solve
    gets and returns x elements.  The y* hooks do the same for y and b,
    with an operator A.  The hooks are functional: xscal(alpha, u) ->
    alpha u, xaxpy(u, v, alpha) -> alpha u + v, xdot(u, v) -> a scalar;
    unset hooks default to the elementwise ones over the leaves.  initvals,
    where given, must then hold x and y.

    Where the KKT system's order len(q) + len(h) + len(b) is below
    config.host_dispatch_threshold (unknown with custom spaces or operator
    P or G), array-like inputs go to the CPU (_dispatch_ctx)."""
    xops = _custom_ops(xnewcopy, xdot, xscal, xaxpy)
    yops = _custom_ops(ynewcopy, ydot, yscal, yaxpy)
    custom = xops is not None or yops is not None
    order = None if (custom or callable(G) or callable(P)) else _kkt_order(
        _veclen(q), _veclen(h), _veclen(b))
    with trace.root("coneqp"), _dispatch_ctx(order):
        dev = _solve_device(*_tree_leaves(q), h, G, P, A, *_tree_leaves(b))
        with trace._profile_ctx(options, dev):
            return _coneqp_impl(P, q, G, h, dims, A, b, initvals, kktsolver,
                                options, dev, xops, yops)


def _coneqp_impl(P, q, G, h, dims, A, b, initvals, kktsolver, options, dev,
                 xops=None, yops=None):
    """coneqp on the device `dev`; xops and yops the VecOps of custom x
    and y spaces, else None."""
    o, dtype = _resolve_options(options)
    custom = xops is not None or yops is not None
    if xops is not None:
        if not (callable(G) and callable(P)):
            raise ValueError("custom x vector space requires operator-form "
                             "P and G")
        if not callable(kktsolver):
            raise ValueError("custom x vector space requires a custom "
                             "kktsolver")
    if yops is not None:
        if A is None:
            raise ValueError("custom y vector space requires A")
        if not callable(A):
            raise ValueError("custom y vector space requires operator-form A")
    xs, ys, zs, xsp, ysp = _spaces(dtype, dev, xops, yops)
    n = None
    if xops is None:
        q = _asarray(q, dtype, dev, name="q")[None]
        n = q.shape[1]
    if G is None and dims is None:
        raise ValueError("G and dims required (use a pure QP via A only is "
                         "not supported without inequalities)")
    dims, h, b, Ga, Aa = _constraints(G, h, dims, A, b, n, dtype, dev,
                                      custom_y=yops is not None)
    Pa = None if callable(P) else (
        torch.zeros((1, n, n), dtype=dtype, device=dev) if P is None
        else _asarray(P, dtype, dev, shape=(n, n), name="P")[None])
    if kktsolver is None:
        kktsolver = "chol" if (dims.q or dims.s) else "chol2"
    o = o.resolve_refinement(dims, kktsolver)
    factor, gmv, amv, pmv = _front_end_ops(dims, o, kktsolver, (G, A, P),
                                           (Ga, Aa, Pa), xs, ys, zs)

    init = None
    if initvals is not None:
        e0 = cones.cone_e(dims, dtype, dev)
        if custom and any(initvals.get(k) is None for k in ("x", "y")):
            raise ValueError("custom vector spaces require complete "
                             "initvals")
        defaults = {"x": torch.zeros((n or 0,), dtype=dtype, device=dev),
                    "y": torch.zeros((ysp.size(b),), dtype=dtype,
                                     device=dev),
                    "s": e0, "z": e0}
        spaces = {"x": xs, "y": ys, "s": zs, "z": zs}
        init = tuple(
            _start(spaces[k], initvals[k], dtype, dev, k)
            if initvals.get(k) is not None else defaults[k][None]
            for k in ("x", "y", "s", "z"))
    if yops is not None and b is None:
        raise ValueError("custom y vector space requires b")

    x, y, s, z, it, status, m = _coneqp_core(
        q, h, b, dims, o, factor, gmv, amv, pmv, init=init, xsp=xsp,
        ysp=ysp)
    m = Metrics(*(a[0] for a in m))
    return _result_dict(int(status[0]), xsp.lane(x, 0), ysp.lane(y, 0),
                        s[0], z[0], dims,
                        _qp_metrics_dict(dims, m, s[0], z[0]),
                        int(it[0]) - 1)


def qp(P, q, G=None, h=None, A=None, b=None, solver=None, initvals=None,
       kktsolver=None, options=None):
    """Natural-form QP (reference coneprog.py:4187): minimize
    (1/2)x'Px + q'x s.t. Gx <= h, Ax = b.  solver in (None, 'osqp',
    'mosek', 'gurobi') per the reference's dispatch
    (coneprog.py:4374-4426): None is coneqp; 'osqp' the ADMM of osqp.py
    on the data's device; 'mosek' and 'gurobi' their bridges (requiring
    their packages).  The routes other than the native one take their
    data to the host and return its numpy result dictionary."""
    if solver in ("osqp", "gurobi", "mosek"):
        from ._conelp import _qp_route
        return _qp_route(solver, P, q, G, h, A, b, options)
    if G is None and h is None:
        raise ValueError("qp requires inequality constraints G, h")
    with trace.root("qp"):
        return coneqp(P, q, G, h, {"l": int(_numel(h))}, A, b,
                      initvals=initvals, kktsolver=kktsolver,
                      options=options)
