"""MOSEK bridge — full Task-API translation layer.

Implements the reference's five entry points (src/python/msk.py): ``lp``
(:38), ``conelp`` (:192), ``socp`` (:482), ``qp`` (:670), ``ilp`` (:839),
with the same problem encodings and return conventions:

* ``lp``/``qp``/``ilp`` pose the *primal* problem directly: rows of G are
  upper-bounded constraints at h, rows of A are fixed at b, variables are
  free; duals come back as ``z = suc`` on the G rows and ``y = suc - slc``
  on the A rows.
* ``conelp``/``socp`` pose the *dual*: one MOSEK variable per cone entry
  of z (l-entries lower-bounded at 0, q-entries free inside quadratic
  cones, s-blocks as semidefinite barvars), the n rows ``G'z = -c`` fixed,
  objective ``maximize -h'z``; the primal x is recovered from the
  constraint duals ``suc - slc``.

Like the reference, this module requires the commercial ``mosek`` package;
importing it without MOSEK installed raises ImportError and callers treat
MOSEK as unavailable (the skip-on-ImportError contract of the reference's
tests/test_mosek.py:5-9).  Options are MOSEK parameter enums in the
module-level ``options`` dict, overridable per call with ``options=``.
Copy of kvxopt_tpu/msk.py: numpy and scipy on the host.
"""

import sys

import mosek  # noqa: F401  (ImportError here == MOSEK not available)
import numpy as np
import scipy.sparse as _sp

from .base import matrix, spmatrix

options = {}

inf = 0.0  # MOSEK ignores the magnitude of infinite bounds


def _log(text):
    sys.stdout.write(text)
    sys.stdout.flush()


def _configure(task, opts):
    """Attach the log stream and push iparam/dparam/sparam options
    (reference msk.py options loop, e.g. :136-146)."""
    task.set_Stream(mosek.streamtype.log, _log)
    for param, val in opts.items():
        tag = str(param)[:6]
        if tag == "iparam":
            task.putintparam(param, val)
        elif tag == "dparam":
            task.putdouparam(param, val)
        elif tag == "sparam":
            task.putstrparam(param, val)
        else:
            raise ValueError("invalid MOSEK parameter: " + str(param))


def _opts(kwargs):
    return kwargs.get("options") or options


def _csc(M, rows, cols, name):
    """matrix/spmatrix → scipy CSC with shape checking."""
    if isinstance(M, spmatrix):
        S = M.to_scipy().tocsc()
    elif isinstance(M, matrix):
        S = _sp.csc_matrix(np.asarray(M, dtype=float).reshape(
            M.size, order="F"))
    else:
        S = _sp.csc_matrix(np.asarray(M, dtype=float))
    if S.shape != (rows, cols):
        raise TypeError("'%s' must have size (%d,%d)" % (name, rows, cols))
    S.sort_indices()
    return S


def _vec(v, name, m=None):
    a = np.asarray(v, dtype=float).reshape(-1)
    if m is not None and a.size != m:
        raise TypeError("'%s' must have %d rows" % (name, m))
    return a


def _rows(M):
    # matrix/spmatrix expose cvxopt's `.size` tuple; numpy's `.size` is a
    # scalar element count, so only trust tuple-valued sizes.
    if M is None:
        return 0
    size = getattr(M, "size", None)
    if isinstance(size, tuple):
        return size[0]
    return np.asarray(M).shape[0]


def _input_columns(task, S):
    """Feed a CSC matrix's columns as the task's linear-constraint
    columns (the role of inputdata's aptrb/aptre/asub/acof)."""
    ptr, idx, val = S.indptr, S.indices, S.data
    for j in range(S.shape[1]):
        lo, hi = ptr[j], ptr[j + 1]
        task.putacol(j, idx[lo:hi].tolist(), val[lo:hi].tolist())


def _primal_task(env, cv, G, hv, A, bv, opts):
    """Build the shared lp/qp/ilp primal task: min c'x, Gx≤h, Ax=b."""
    n, m, p = cv.size, hv.size, bv.size
    task = env.Task(0, 0)
    _configure(task, opts)
    task.appendvars(n)
    task.appendcons(m + p)
    for j in range(n):
        task.putcj(j, cv[j])
        task.putvarbound(j, mosek.boundkey.fr, -inf, +inf)
    stacked = _sp.vstack([G, A]).tocsr() if p else G.tocsr()
    for i in range(m + p):
        lo, hi = stacked.indptr[i], stacked.indptr[i + 1]
        task.putarow(i, stacked.indices[lo:hi].tolist(),
                     stacked.data[lo:hi].tolist())
        if i < m:
            task.putconbound(i, mosek.boundkey.up, -inf, hv[i])
        else:
            task.putconbound(i, mosek.boundkey.fx, bv[i - m], bv[i - m])
    task.putobjsense(mosek.objsense.minimize)
    return task


def _primal_duals(task, soltype, m, p):
    """z = suc on G rows; y = suc - slc on A rows (msk.py:176-184)."""
    if m:
        z = m * [0.0]
        task.getsolutionslice(soltype, mosek.solitem.suc, 0, m, z)
        z = matrix(z)
    else:
        z = matrix(0.0, (0, 1))
    if p:
        yu, yl = p * [0.0], p * [0.0]
        task.getsolutionslice(soltype, mosek.solitem.suc, m, m + p, yu)
        task.getsolutionslice(soltype, mosek.solitem.slc, m, m + p, yl)
        y = matrix(np.asarray(yu) - np.asarray(yl))
    else:
        y = matrix(0.0, (0, 1))
    return z, y


def lp(c, G, h, A=None, b=None, taskfile=None, **kwargs):
    """Solves an LP through the MOSEK Task API (reference msk.py:38).

    minimize c'x  s.t.  Gx <= h,  Ax = b.
    Returns (solsta, x, z, y); (solsta, None, None, None) when unknown.
    """
    cv = _vec(c, "c")
    n = cv.size
    if n < 1:
        raise ValueError("number of variables must be at least 1")
    m = _rows(G)
    if m == 0:
        raise ValueError("m cannot be 0")
    Gs = _csc(G, m, n, "G")
    hv = _vec(h, "h", m)
    p = _rows(A)
    As = _csc(A, p, n, "A") if A is not None else _sp.csc_matrix((0, n))
    bv = _vec(b, "b", p) if b is not None else np.zeros(0)

    with mosek.Env() as env:
        with _primal_task(env, cv, Gs, hv, As, bv, _opts(kwargs)) as task:
            if taskfile:
                task.writetask(taskfile)
            task.optimize()
            task.solutionsummary(mosek.streamtype.msg)
            solsta = task.getsolsta(mosek.soltype.bas)
            xx = n * [0.0]
            task.getsolutionslice(mosek.soltype.bas, mosek.solitem.xx,
                                  0, n, xx)
            x = matrix(xx)
            z, y = _primal_duals(task, mosek.soltype.bas, m, p)

    if solsta is mosek.solsta.unknown:
        return (solsta, None, None, None)
    return (solsta, x, z, y)


def qp(P, q, G=None, h=None, A=None, b=None, taskfile=None, **kwargs):
    """Solves a QP through the MOSEK Task API (reference msk.py:670).

    minimize (1/2) x'Px + q'x  s.t.  Gx <= h,  Ax = b.
    Returns (solsta, x, z, y); (solsta, None, None, None) when unknown.
    """
    qv = _vec(q, "q")
    n = qv.size
    if n < 1:
        raise ValueError("number of variables must be at least 1")
    m = _rows(G)
    Gs = _csc(G, m, n, "G") if G is not None else _sp.csc_matrix((0, n))
    hv = _vec(h, "h", m) if h is not None else np.zeros(0)
    p = _rows(A)
    As = _csc(A, p, n, "A") if A is not None else _sp.csc_matrix((0, n))
    bv = _vec(b, "b", p) if b is not None else np.zeros(0)
    if m + p == 0:
        raise ValueError("m + p must be greater than 0")
    Pc = _csc(P, n, n, "P").tocoo()

    with mosek.Env() as env:
        with _primal_task(env, qv, Gs, hv, As, bv, _opts(kwargs)) as task:
            keep = Pc.row >= Pc.col  # MOSEK wants the lower triangle
            task.putqobj(Pc.row[keep].tolist(), Pc.col[keep].tolist(),
                         Pc.data[keep].tolist())
            if taskfile:
                task.writetask(taskfile)
            task.optimize()
            task.solutionsummary(mosek.streamtype.msg)
            solsta = task.getsolsta(mosek.soltype.itr)
            xx = n * [0.0]
            task.getsolutionslice(mosek.soltype.itr, mosek.solitem.xx,
                                  0, n, xx)
            x = matrix(xx)
            z, y = _primal_duals(task, mosek.soltype.itr, m, p)

    if solsta is mosek.solsta.unknown:
        return (solsta, None, None, None)
    return (solsta, x, z, y)


def ilp(c, G, h, A=None, b=None, I=None, taskfile=None, **kwargs):
    """Solves a mixed-integer LP (reference msk.py:839).

    minimize c'x  s.t.  Gx <= h,  Ax = b,  x[k] integer for k in I.
    I defaults to all variables.  Returns (solsta, x) or (solsta, None).
    """
    cv = _vec(c, "c")
    n = cv.size
    if n < 1:
        raise ValueError("number of variables must be at least 1")
    m = _rows(G)
    if m == 0:
        raise ValueError("m cannot be 0")
    Gs = _csc(G, m, n, "G")
    hv = _vec(h, "h", m)
    p = _rows(A)
    As = _csc(A, p, n, "A") if A is not None else _sp.csc_matrix((0, n))
    bv = _vec(b, "b", p) if b is not None else np.zeros(0)
    if I is None:
        I = set(range(n))
    if not isinstance(I, set):
        raise TypeError("invalid argument for integer index set")
    if I and (min(I) < 0 or max(I) > n - 1):
        raise IndexError("integer index set I out of range")

    with mosek.Env() as env:
        with _primal_task(env, cv, Gs, hv, As, bv, _opts(kwargs)) as task:
            if I:
                task.putvartypelist(
                    sorted(I), len(I) * [mosek.variabletype.type_int])
            task.putintparam(mosek.iparam.mio_mode, mosek.miomode.satisfied)
            if taskfile:
                task.writetask(taskfile)
            task.optimize()
            task.solutionsummary(mosek.streamtype.msg)
            soltype = mosek.soltype.itg if I else mosek.soltype.bas
            solsta = task.getsolsta(soltype)
            xx = n * [0.0]
            task.getsolutionslice(soltype, mosek.solitem.xx, 0, n, xx)
            x = matrix(xx)

    if solsta is mosek.solsta.unknown:
        return (solsta, None)
    return (solsta, x)


def _dual_cone_task(env, cv, Gl, hl, ml, mq, opts):
    """Shared conelp/socp dual task over the l/q part.

    Variables: one per z entry (l lower-bounded at 0, q free).
    Constraints: Gl'z fixed at -c.  Objective: maximize -hl'z.
    Quadratic cones appended per q block."""
    n = cv.size
    dimx = ml + int(np.sum(mq))
    task = env.Task(0, 0)
    _configure(task, opts)
    task.appendvars(dimx)
    task.appendcons(n)
    for j in range(ml):
        task.putcj(j, -hl[j])
        task.putvarbound(j, mosek.boundkey.lo, 0.0, +inf)
    for j in range(ml, dimx):
        task.putcj(j, -hl[j])
        task.putvarbound(j, mosek.boundkey.fr, -inf, +inf)
    GlT = Gl.T.tocsr()  # row i of Gl' = column i of Gl
    for i in range(n):
        lo, hi = GlT.indptr[i], GlT.indptr[i + 1]
        task.putarow(i, GlT.indices[lo:hi].tolist(),
                     GlT.data[lo:hi].tolist())
        task.putconbound(i, mosek.boundkey.fx, -cv[i], -cv[i])
    ofs = ml
    for k in mq:
        task.appendcone(mosek.conetype.quad, 0.0, list(range(ofs, ofs + k)))
        ofs += k
    task.putobjsense(mosek.objsense.maximize)
    return task


def _dual_x(task, n):
    """Primal x from the fixed-constraint duals (msk.py:461-465)."""
    xu, xl = n * [0.0], n * [0.0]
    task.getsolutionslice(mosek.soltype.itr, mosek.solitem.suc, 0, n, xu)
    task.getsolutionslice(mosek.soltype.itr, mosek.solitem.slc, 0, n, xl)
    return matrix(np.asarray(xu) - np.asarray(xl))


def conelp(c, G, h, dims=None, taskfile=None, **kwargs):
    """Solves a cone LP with l/q/s cones (reference msk.py:192).

    minimize c'x s.t. Gx + s = h, s in C, with C = R^l_+ x Q^q x S^s_+
    in the conelp row layout ('s' blocks stored as full n_k^2 columns).
    Returns (solsta, x, z); (solsta, None, None) when unknown.
    """
    cv = _vec(c, "c")
    n = cv.size
    if dims is None:
        dims = {"l": _rows(G), "q": [], "s": []}
    ml = dims.get("l", 0)
    mq = list(dims.get("q", []))
    ms = list(dims.get("s", []))
    if mq and min(mq) < 1:
        raise TypeError("dimensions of quadratic cones must be positive")
    if ms and min(ms) < 1:
        raise TypeError("dimensions of semidefinite cones must be positive")
    dimx = ml + int(np.sum(mq, dtype=int))
    sdim = int(np.sum([k * k for k in ms], dtype=int))
    cdim = dimx + sdim
    if cdim == 0:
        raise ValueError("ml+mq+ms cannot be 0")
    Gall = _csc(G, cdim, n, "G")
    hv = _vec(h, "h", cdim)
    Gl, Gs = Gall[:dimx, :], Gall[dimx:, :].tocsr()

    with mosek.Env() as env:
        with _dual_cone_task(env, cv, Gl.tocsc(), hv[:dimx], ml, mq,
                             _opts(kwargs)) as task:
            if ms:
                task.appendbarvars(ms)
                # barC: objective coefficients -h on the s blocks
                # (lower triangle only; barvars are symmetric)
                bj, bk, bl, bv_ = [], [], [], []
                base = 0
                for s_i, k_s in enumerate(ms):
                    blk = hv[dimx + base: dimx + base + k_s * k_s]
                    for col in range(k_s):
                        for row in range(col, k_s):
                            bj.append(s_i)
                            bk.append(row)
                            bl.append(col)
                            bv_.append(-blk[col * k_s + row])
                    base += k_s * k_s
                task.putbarcblocktriplet(len(bj), bj, bk, bl, bv_)
                # barA: constraint row i gets <Gs-block_i, Zs>
                ai, aj, ak, al, av = [], [], [], [], []
                base = 0
                for s_i, k_s in enumerate(ms):
                    blk = Gs[base: base + k_s * k_s, :].tocoo()
                    for r, ccol, v in zip(blk.row, blk.col, blk.data):
                        row, col = r % k_s, r // k_s  # column-major block
                        if row < col:
                            continue
                        ai.append(int(ccol))
                        aj.append(s_i)
                        ak.append(int(row))
                        al.append(int(col))
                        av.append(float(v))
                    base += k_s * k_s
                task.putbarablocktriplet(len(ai), ai, aj, ak, al, av)
            if taskfile:
                task.writetask(taskfile)
            task.optimize()
            task.solutionsummary(mosek.streamtype.msg)
            solsta = task.getsolsta(mosek.soltype.itr)
            x = _dual_x(task, n)
            zz = dimx * [0.0]
            task.getsolutionslice(mosek.soltype.itr, mosek.solitem.xx,
                                  0, dimx, zz)
            zparts = [np.asarray(zz)]
            for s_i, k_s in enumerate(ms):
                packed = (k_s * (k_s + 1) // 2) * [0.0]
                task.getbarxj(mosek.soltype.itr, s_i, packed)
                Zs = np.zeros((k_s, k_s))
                idx = 0
                for col in range(k_s):
                    for row in range(col, k_s):
                        Zs[row, col] = packed[idx]
                        Zs[col, row] = packed[idx]
                        idx += 1
                zparts.append(Zs.reshape(-1, order="F"))
            z = matrix(np.concatenate(zparts)) if zparts else \
                matrix(0.0, (0, 1))

    if solsta is mosek.solsta.unknown:
        return (solsta, None, None)
    return (solsta, x, z)


def socp(c, Gl=None, hl=None, Gq=None, hq=None, taskfile=None, **kwargs):
    """Solves an SOCP in natural form (reference msk.py:482).

    minimize c'x s.t. Gl x <= hl, ||Gq[k][1:] x - hq[k][1:]|| <=
    hq[k][0] - Gq[k][0] x.  Returns (solsta, x, zl, zq) with zq a list;
    (solsta, None, None, None) when unknown.
    """
    cv = _vec(c, "c")
    n = cv.size
    ml = _rows(Gl)
    Gls = _csc(Gl, ml, n, "Gl") if Gl is not None else \
        _sp.csc_matrix((0, n))
    hlv = _vec(hl, "hl", ml) if hl is not None else np.zeros(0)
    Gq = Gq or []
    hq = hq or []
    mq = [_rows(Gk) for Gk in Gq]
    if any(k == 0 for k in mq):
        raise TypeError("the number of rows of a Gq block is zero")
    if len(hq) != len(mq):
        raise TypeError("'hq' must be a list of %d matrices" % len(mq))
    blocks = [Gls] + [_csc(Gk, mk, n, "Gq") for Gk, mk in zip(Gq, mq)]
    hv = np.concatenate([hlv] + [_vec(hk, "hq", mk)
                                 for hk, mk in zip(hq, mq)]) \
        if (ml or mq) else np.zeros(0)
    Gstack = _sp.vstack(blocks).tocsc()

    with mosek.Env() as env:
        with _dual_cone_task(env, cv, Gstack, hv, ml, mq,
                             _opts(kwargs)) as task:
            if taskfile:
                task.writetask(taskfile)
            task.optimize()
            task.solutionsummary(mosek.streamtype.msg)
            solsta = task.getsolsta(mosek.soltype.itr)
            x = _dual_x(task, n)
            dimx = ml + int(np.sum(mq, dtype=int))
            zz = dimx * [0.0]
            task.getsolutionslice(mosek.soltype.itr, mosek.solitem.xx,
                                  0, dimx, zz)
            zz = np.asarray(zz)
            zl = matrix(zz[:ml]) if ml else matrix(0.0, (0, 1))
            zq, ofs = [], ml
            for k in mq:
                zq.append(matrix(zz[ofs:ofs + k]))
                ofs += k

    if solsta is mosek.solsta.unknown:
        return (solsta, None, None, None)
    return (solsta, x, zl, zq)
