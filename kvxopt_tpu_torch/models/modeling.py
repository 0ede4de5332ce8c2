"""Piecewise-linear modeling DSL (reference src/python/modeling.py):
variable, constraint, op, dot, and PWL max/min/abs/sum, with MPS I/O.

Fresh design around an explicit normal form instead of the reference's
operator-graph classes (modeling.py:250-1800):

- `affine`: coeffs {variable: (m x n) matrix} + constant (length m).
- convex PWL vector = affine + max-blocks, each block a list of affine
  pieces (elementwise max); concave functions are stored as negated
  convex ones.
- scalar PWL = affine scalar + ('sum'|'max', pieces, m) terms.

`op.solve()` canonicalizes PWL terms to auxiliary variables and linear
inequalities (the role of the reference's _inmatrixform,
modeling.py:2337), solves with kvxopt_tpu_torch.solvers.lp, and writes values
and multipliers back into the model objects: the solve runs on
config.default_device (the card unless the caller names another), and
x, z and y come back to the host in one copy each.  MPS write/read
(modeling.py:2640 tofile, :2760 fromfile) supports ROWS/COLUMNS/RHS/
RANGES/BOUNDS.
"""

from __future__ import annotations

import builtins
import numbers

import numpy as np

from ..base import matrix

_pymax, _pymin, _pysum = builtins.max, builtins.min, builtins.sum

_var_counter = [0]


class variable:
    """Optimization variable (reference modeling.py:37)."""

    # keep numpy from broadcasting elementwise over variables: ndarray
    # binary ops defer to our __rmul__/__radd__ (matrix * variable etc.)
    __array_priority__ = 20.0
    __array_ufunc__ = None

    def __init__(self, size=1, name=""):
        size = int(size)
        if size < 1:
            raise TypeError("size must be a positive integer")
        self._size = size
        self.name = name or f"x{_var_counter[0]}"
        _var_counter[0] += 1
        self.value = None

    def __len__(self):
        return self._size

    def _aff(self):
        return affine({self: np.eye(self._size)}, np.zeros(self._size))

    def __repr__(self):
        return f"variable({self._size},'{self.name}')"

    def __str__(self):
        if self.value is None:
            return f"variable({self._size},'{self.name}')\nvalue: None"
        return f"variable({self._size},'{self.name}')\nvalue:\n" + \
            str(self.value)

    # arithmetic lifts to affine
    def __add__(self, o): return self._aff() + o
    def __radd__(self, o): return self._aff() + o
    def __sub__(self, o): return self._aff() - o
    def __rsub__(self, o): return (-self._aff()) + o
    def __mul__(self, o): return self._aff() * o
    def __rmul__(self, o): return self._aff().__rmul__(o)
    def __neg__(self): return -self._aff()
    def __getitem__(self, k): return self._aff()[k]
    def __le__(self, o): return self._aff() <= o
    def __ge__(self, o): return self._aff() >= o
    def __eq__(self, o): return self._aff() == o
    def __hash__(self): return id(self)
    def __abs__(self): return abs(self._aff())


def _const_vec(c, m=None):
    if isinstance(c, numbers.Number):
        return np.full(m if m else 1, float(c))
    a = np.asarray(c, dtype=float).reshape(-1)
    if m is not None and a.size == 1 and m != 1:
        return np.full(m, a[0])
    return a


class affine:
    """Affine vector function sum_v A_v v + b."""

    __array_priority__ = 20.0

    def __init__(self, coeffs, const):
        self.coeffs = {v: np.atleast_2d(np.asarray(A, dtype=float))
                       for v, A in coeffs.items()}
        self.const = np.asarray(const, dtype=float).reshape(-1)
        for v, A in self.coeffs.items():
            if A.shape != (len(self.const), len(v)):
                raise TypeError("coefficient dimensions do not match")

    def __len__(self):
        return len(self.const)

    @staticmethod
    def from_any(o, m=None):
        if isinstance(o, affine):
            return o
        if isinstance(o, variable):
            return o._aff()
        return affine({}, _const_vec(o, m))

    def _broadcast(self, m):
        if len(self) == m:
            return self
        if len(self) == 1:
            coeffs = {v: np.repeat(A, m, axis=0)
                      for v, A in self.coeffs.items()}
            return affine(coeffs, np.full(m, self.const[0]))
        raise TypeError("incompatible dimensions")

    def __add__(self, o):
        if isinstance(o, pwl):
            return o + self
        if isinstance(o, pwl_scalar):
            return o + self
        o = affine.from_any(o, len(self))
        m = _pymax(len(self), len(o))
        a, b = self._broadcast(m), o._broadcast(m)
        coeffs = dict(a.coeffs)
        for v, A in b.coeffs.items():
            coeffs[v] = coeffs.get(v, 0) + A
        return affine(coeffs, a.const + b.const)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, (pwl, pwl_scalar)):
            raise TypeError("subtracting a convex PWL function is not "
                            "convex")
        return self + (-affine.from_any(o, len(self)))

    def __rsub__(self, o):
        return (-self) + o

    def __neg__(self):
        return affine({v: -A for v, A in self.coeffs.items()}, -self.const)

    def __mul__(self, o):
        if isinstance(o, numbers.Number):
            return affine({v: o * A for v, A in self.coeffs.items()},
                          o * self.const)
        raise TypeError("affine functions can only be scaled by numbers "
                        "on the right")

    def __rmul__(self, o):
        if isinstance(o, numbers.Number):
            return self * o
        M = np.atleast_2d(np.asarray(o, dtype=float))
        if M.shape[1] != len(self):
            if M.size == 1:
                return self * float(M.reshape(-1)[0])
            raise TypeError("incompatible dimensions")
        return affine({v: M @ A for v, A in self.coeffs.items()},
                      M @ self.const)

    __rmatmul__ = __rmul__

    def __getitem__(self, k):
        idx = np.arange(len(self))[k]
        idx = np.atleast_1d(idx)
        coeffs = {v: A[idx, :] for v, A in self.coeffs.items()}
        return affine(coeffs, self.const[idx])

    def __abs__(self):
        return pwl(affine({}, np.zeros(len(self))),
                   [[self, -self]])

    def __le__(self, o):
        if isinstance(o, (pwl, pwl_scalar)):
            return o.__ge__(self)
        return constraint(self - affine.from_any(o, len(self)), "<")

    def __ge__(self, o):
        if isinstance(o, (pwl, pwl_scalar)):
            return o.__le__(self)
        return constraint(affine.from_any(o, len(self)) - self, "<")

    def __eq__(self, o):
        if isinstance(o, (pwl,)):
            raise TypeError("equality requires affine functions")
        return constraint(self - affine.from_any(o, len(self)), "=")

    def __hash__(self):
        return id(self)

    def value(self):
        out = self.const.copy()
        for v, A in self.coeffs.items():
            if v.value is None:
                return None
            out = out + A @ np.asarray(v.value, dtype=float).reshape(-1)
        return matrix(out.reshape(-1, 1))

    def variables(self):
        return list(self.coeffs.keys())

    def __repr__(self):
        return f"<affine function of length {len(self)}>"

    __str__ = __repr__


class pwl:
    """Convex piecewise-linear vector function: affine + sum of
    elementwise max-blocks."""

    def __init__(self, aff, blocks):
        self.aff = aff
        self.blocks = [[p if isinstance(p, (pwl, pwl_scalar))
                        else affine.from_any(p, len(aff)) for p in blk]
                       for blk in blocks]

    def __len__(self):
        return len(self.aff)

    def _flat_pieces(self):
        """Flatten aff + max(block) into pieces aff + p_k (valid for a
        single block; pieces may themselves be PWL)."""
        if len(self.blocks) != 1:
            raise TypeError("cannot flatten a multi-block PWL function")
        return [p + self.aff if isinstance(p, (pwl, pwl_scalar))
                else self.aff + p for p in self.blocks[0]]

    def __add__(self, o):
        if isinstance(o, pwl):
            return pwl(self.aff + o.aff, self.blocks + o.blocks)
        return pwl(self.aff + affine.from_any(o, len(self)), self.blocks)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, pwl):
            raise TypeError("difference of PWL convex functions is not "
                            "convex")
        return self + (-affine.from_any(o, len(self)))

    def __rsub__(self, o):
        raise TypeError("negating a convex PWL function is not convex")

    def __mul__(self, o):
        if isinstance(o, numbers.Number):
            if o < 0:
                raise TypeError("PWL convex functions require nonnegative "
                                "scalars")
            return pwl(self.aff * o,
                       [[p * o for p in blk] for blk in self.blocks])
        raise TypeError("invalid product")

    __rmul__ = __mul__

    def __le__(self, o):
        rhs = affine.from_any(o, len(self)) if not isinstance(o, pwl) \
            else None
        if rhs is None:
            raise TypeError("PWL <= PWL is not convex")
        return constraint(self + (-rhs), "<")

    def __ge__(self, o):
        raise TypeError("lower bounds on convex PWL functions are not "
                        "convex")

    def value(self):
        base = self.aff.value()
        if base is None:
            return None
        out = np.asarray(base).reshape(-1)
        for blk in self.blocks:
            vals = []
            for p in blk:
                pv = p.value()
                if pv is None:
                    return None
                vals.append(np.asarray(pv).reshape(-1))
            out = out + np.max(np.stack(
                [np.broadcast_to(v, out.shape) for v in vals]), axis=0)
        return matrix(out.reshape(-1, 1))

    def __repr__(self):
        return f"<pwl function of length {len(self)}>"

    __str__ = __repr__


class pwl_scalar:
    """Convex PWL with scalar terms: affine part (any length; scalar
    terms broadcast across its rows) + ('sum'|'max', pieces, m) terms.
    The vector-affine case supports forms like A*x + sum(abs(x)) <= b
    (reference chap10/roblp.py)."""

    def __init__(self, aff, terms):
        self.aff = aff  # affine (scalar terms broadcast to its length)
        self.terms = terms

    def __add__(self, o):
        if isinstance(o, pwl_scalar):
            return pwl_scalar(self.aff + o.aff, self.terms + o.terms)
        return pwl_scalar(self.aff + affine.from_any(o, 1), self.terms)

    __radd__ = __add__

    def __mul__(self, o):
        if isinstance(o, numbers.Number) and o >= 0:
            return pwl_scalar(self.aff * o, [
                (kind, [p * o for p in pieces], m)
                for kind, pieces, m in self.terms])
        raise TypeError("invalid product")

    __rmul__ = __mul__

    def __le__(self, o):
        # t-lifted at solve time
        if isinstance(o, (pwl, pwl_scalar)):
            raise TypeError("PWL <= PWL is not convex")
        rhs = affine.from_any(o, len(self.aff))
        return constraint(pwl_scalar(self.aff - rhs, self.terms), "<")

    def __ge__(self, o):
        raise TypeError("lower bounds on convex PWL functions are not "
                        "convex")

    def __sub__(self, o):
        if isinstance(o, (pwl, pwl_scalar)):
            raise TypeError("difference of PWL convex functions is not "
                            "convex")
        return pwl_scalar(self.aff - affine.from_any(o, len(self.aff)),
                          self.terms)

    def value(self):
        base = self.aff.value()
        if base is None:
            return None
        vec = np.asarray(base).reshape(-1)
        out = 0.0
        for kind, pieces, m in self.terms:
            vals = []
            for p in pieces:
                pv = p.value() if hasattr(p, "value") else None
                if pv is None:
                    return None
                vals.append(np.broadcast_to(
                    np.asarray(pv).reshape(-1), (m,)))
            mx = np.max(np.stack(vals), axis=0)
            out += float(np.sum(mx)) if kind == "sum" else float(
                np.max(mx))
        return matrix((vec + out).reshape(-1, 1))

    def __repr__(self):
        return "<scalar pwl function>"

    __str__ = __repr__


def dot(u, v):
    """Inner product (reference modeling.py dot): matrix'affine or
    affine'matrix."""
    if isinstance(u, (variable, affine)) and not isinstance(
            v, (variable, affine)):
        u, v = v, u
    a = affine.from_any(v)
    c = np.asarray(u, dtype=float).reshape(-1)
    return a.__rmul__(c.reshape(1, -1)) if len(c) > 1 else a * float(c[0])


def sum(f):
    """Sum of the components (reference modeling.py sum)."""
    if isinstance(f, (variable, affine)):
        a = affine.from_any(f)
        ones = np.ones((1, len(a)))
        return ones @ a
    if isinstance(f, pwl):
        ones = np.ones((1, len(f)))
        aff = ones @ f.aff
        terms = [("sum", blk, len(f)) for blk in f.blocks]
        return pwl_scalar(aff, terms)
    if isinstance(f, pwl_scalar):
        return f
    return _pysum(f)


def max(*args):
    """PWL max (reference modeling.py max via _minmax): with several
    arguments, the elementwise maximum; with one affine/PWL argument, the
    maximum over its components."""
    if len(args) == 1:
        f = args[0]
        if isinstance(f, pwl_scalar):
            return f          # max of a scalar PWL is itself
        if isinstance(f, (variable, affine)):
            a = affine.from_any(f)
            return pwl_scalar(affine({}, np.zeros(1)),
                              [("max", [a], len(a))])
        if isinstance(f, pwl):
            if len(f.blocks) == 1:
                return pwl_scalar(affine({}, np.zeros(1)),
                                  [("max", f._flat_pieces(), len(f))])
            # multi-block: keep the whole PWL as one nested piece
            return pwl_scalar(affine({}, np.zeros(1)),
                              [("max", [f], len(f))])
        return _pymax(f)
    if not any(isinstance(a, (variable, affine, pwl, pwl_scalar))
               for a in args):
        return _pymax(*args)
    m = _pymax(len(a) if isinstance(a, (variable, affine, pwl)) else 1
               for a in args)
    pieces = []
    for a in args:
        if isinstance(a, pwl_scalar):
            # nested scalar PWL (e.g. max(max(abs(x)), 0.5), reference
            # modeling.py _minmax on f_i with PWL arguments): kept as a
            # piece, lowered with its own epigraph variables at solve
            # time (scalar value broadcasts across the m rows)
            pieces.append(a)
        elif isinstance(a, pwl):
            if len(a.blocks) == 1:
                for p in a._flat_pieces():
                    # pwl_scalar pieces (from nested max(max(abs(x)),..))
                    # have no _broadcast; the lowering handles them via
                    # the 'pwls' spec, so keep them whole like pwl
                    pieces.append(p if isinstance(p, (pwl, pwl_scalar))
                                  else p._broadcast(m))
            else:
                # nested multi-block PWL: kept as a piece, lowered with
                # its own epigraph variables at solve time
                if len(a) != m:
                    raise TypeError("nested PWL pieces must match the "
                                    "elementwise length")
                pieces.append(a)
        else:
            pieces.append(affine.from_any(a, m)._broadcast(m))
    return pwl(affine({}, np.zeros(m)), [pieces])


def min(*args):
    """Concave PWL min: implemented as -max(-args) (usable on the
    greater-than side of constraints)."""
    if len(args) == 1:
        f = args[0]
        if isinstance(f, (variable, affine, pwl)):
            return _neg_pwl(max(-affine.from_any(f)
                                if not isinstance(f, pwl) else _negate(f)))
        return _pymin(f)
    if not any(isinstance(a, (variable, affine, pwl)) for a in args):
        return _pymin(*args)
    neg = [(-affine.from_any(a)) if not isinstance(a, pwl)
           else _negate(a) for a in args]
    return _neg_pwl(max(*neg))


class _neg_pwl:
    """Concave wrapper: value = -inner (inner convex)."""

    def __init__(self, inner):
        self.inner = inner

    def __le__(self, o):
        raise TypeError("upper bounds on concave functions are not convex")

    def __ge__(self, o):
        # -inner >= o  <=>  inner + o <= 0
        if isinstance(self.inner, pwl):
            return constraint(self.inner + affine.from_any(
                o, len(self.inner)), "<")
        return constraint(self.inner + affine.from_any(o, 1), "<")


def _negate(f):
    if isinstance(f, pwl):
        raise TypeError("cannot negate a convex PWL function")
    return -f


class constraint:
    """f (<|=) 0 (reference modeling.py:1833)."""

    def __init__(self, f, kind, name=""):
        self.f = f           # affine, pwl, or pwl_scalar; constraint f<=0
        self.kind = kind     # '<' or '='
        self.multiplier = variable(
            len(f) if isinstance(f, (affine, pwl)) else len(f.aff))
        self.name = name     # also names the multiplier (property below)

    @property
    def name(self):
        return self._name

    @name.setter
    def name(self, value):
        """Renaming a constraint renames its multiplier to '<name>_mul'
        (reference doc/source/modeling.rst: constraint.name)."""
        if not isinstance(value, str):
            raise TypeError("attribute 'name' must be string")
        self._name = value
        self.multiplier.name = f"{value}_mul" if value else ""

    def type(self):
        return self.kind

    def __len__(self):
        return (len(self.f) if isinstance(self.f, (affine, pwl))
                else len(self.f.aff))

    def value(self):
        if isinstance(self.f, affine):
            return self.f.value()
        return None

    def __repr__(self):
        op_s = "<=" if self.kind == "<" else "=="
        return f"<constraint of length {len(self)} ({op_s} 0)>"

    __str__ = __repr__


class op:
    """Optimization problem container (reference modeling.py:2093)."""

    def __init__(self, objective=0.0, constraints=None, name=""):
        if constraints is None:
            constraints = []
        if isinstance(constraints, constraint):
            constraints = [constraints]
        self.objective = self._canon_objective(objective)
        self._constraints = list(constraints)
        self.name = name
        self.status = None

    @staticmethod
    def _canon_objective(objective):
        if isinstance(objective, numbers.Number):
            return affine({}, np.asarray([float(objective)]))
        if isinstance(objective, variable):
            objective = objective._aff()
        if isinstance(objective, (affine, pwl_scalar)):
            if isinstance(objective, affine) and len(objective) != 1:
                raise TypeError("objective must be scalar")
            if isinstance(objective, pwl_scalar) and \
                    len(objective.aff) != 1:
                raise TypeError("objective must be scalar")
            return objective
        if isinstance(objective, pwl):
            if len(objective) != 1:
                raise TypeError("objective must be scalar")
            return pwl_scalar(objective.aff,
                              [("sum", blk, 1) for blk in objective.blocks])
        raise TypeError(f"invalid objective {type(objective)}")

    def variables(self):
        seen = []
        seen_ids = set()
        def add(f):
            if isinstance(f, (affine,)):
                for v in f.coeffs:
                    if id(v) not in seen_ids:
                        seen_ids.add(id(v))
                        seen.append(v)
            elif isinstance(f, pwl):
                add(f.aff)
                for blk in f.blocks:
                    for p in blk:
                        add(p)
            elif isinstance(f, pwl_scalar):
                add(f.aff)
                for _, pieces, _ in f.terms:
                    for p in pieces:
                        add(p)
        add(self.objective)
        for c in self._constraints:
            add(c.f)
        return seen

    def constraints(self):
        return list(self._constraints)

    def inequalities(self):
        return [c for c in self._constraints if c.kind == "<"]

    def equalities(self):
        return [c for c in self._constraints if c.kind == "="]

    def addconstraint(self, c):
        self._constraints.append(c)

    def delconstraint(self, c):
        self._constraints.remove(c)

    # -- canonicalization + solve ---------------------------------------

    def _build_lp(self):
        """Lower PWL terms to auxiliary variables; returns
        (c, G, h, A, b, var_index, ineq_rows) where var_index maps
        variable -> column slice and ineq_rows maps constraint ->
        (start, length) rows of G."""
        varlist = self.variables()
        aux = []

        def mk_piece_spec(p):
            """('aff', affine) or, for a nested PWL piece,
            ('pwl', p, u, [(tb, [subspecs])...]) with fresh epigraph
            variables u/tb."""
            if isinstance(p, pwl):
                u = variable(len(p), name=f"_aux{len(aux)}")
                aux.append(u)
                bspecs = []
                for blk in p.blocks:
                    tb = variable(len(p), name=f"_aux{len(aux)}")
                    aux.append(tb)
                    bspecs.append((tb, [mk_piece_spec(q) for q in blk]))
                return ("pwl", p, u, bspecs)
            if isinstance(p, pwl_scalar):
                # nested scalar PWL piece: one epigraph variable per term
                tspecs = []
                for kind, pieces_, mterm in p.terms:
                    t = variable(mterm if kind == "sum" else 1,
                                 name=f"_aux{len(aux)}")
                    aux.append(t)
                    tspecs.append((kind, [mk_piece_spec(q) for q in
                                          pieces_], mterm, t))
                return ("pwls", p, tspecs)
            return ("aff", p)

        obj = self.objective
        obj_terms = []
        if isinstance(obj, pwl_scalar):
            for kind, pieces, m in obj.terms:
                t = variable(m if kind == "sum" else 1,
                             name=f"_aux{len(aux)}")
                aux.append(t)
                obj_terms.append((kind, [mk_piece_spec(p) for p in
                                         pieces], m, t))

        con_aux = []
        for c in self._constraints:
            if isinstance(c.f, pwl):
                blocks_aux = []
                for blk in c.f.blocks:
                    t = variable(len(c.f), name=f"_aux{len(aux)}")
                    aux.append(t)
                    blocks_aux.append(([mk_piece_spec(q) for q in blk],
                                       t))
                con_aux.append((c, blocks_aux))
            elif isinstance(c.f, pwl_scalar):
                terms_aux = []
                for kind, pieces, m in c.f.terms:
                    t = variable(m if kind == "sum" else 1,
                                 name=f"_aux{len(aux)}")
                    aux.append(t)
                    terms_aux.append((kind, [mk_piece_spec(p) for p in
                                             pieces], m, t))
                con_aux.append((c, terms_aux))
            else:
                con_aux.append((c, None))

        allvars = varlist + aux
        ofs, var_index = 0, {}
        for v in allvars:
            var_index[v] = slice(ofs, ofs + len(v))
            ofs += len(v)
        nvar = ofs

        def emit(f, sign=1.0):
            row = np.zeros((len(f), nvar))
            for v, A in f.coeffs.items():
                row[:, var_index[v]] += sign * A
            return row, sign * f.const

        cvec = np.zeros(nvar)
        const0 = 0.0
        if isinstance(obj, affine):
            r, cst = emit(obj)
            cvec += r[0]
            const0 = cst[0]
        else:
            r, cst = emit(obj.aff)
            cvec += r[0]
            const0 = cst[0]
            for kind, pieces, m, t in obj_terms:
                cvec[var_index[t]] += 1.0

        Grows, hrows = [], []
        Arows, brows = [], []
        ineq_rows = {}

        def lower_piece(spec, m):
            """Emit rows bounding a piece and return (row, cst) of an
            affine upper-bound expression of length m."""
            if spec[0] == "aff":
                return emit(spec[1]._broadcast(m))
            if spec[0] == "pwls":
                # nested scalar PWL: bound each term with its epigraph
                # variable, return aff + sum(terms) broadcast to m rows
                _, p, tspecs = spec
                for kind, subspecs, mterm, t in tspecs:
                    add_term_rows(kind, subspecs, mterm, t)
                row, cst = emit(p.aff._broadcast(m))
                for kind, subspecs, mterm, t in tspecs:
                    row[:, var_index[t]] += 1.0
                return row, cst
            _, p, u, bspecs = spec
            mp = len(p)
            acc_row, acc_cst = emit(p.aff)
            for tb, subspecs in bspecs:
                for sub in subspecs:
                    srow, scst = lower_piece(sub, mp)
                    srow[:, var_index[tb]] -= np.eye(mp)
                    Grows.append(srow)
                    hrows.append(-scst)
                acc_row[:, var_index[tb]] += np.eye(mp)
            # p.aff + sum_b tb - u <= 0
            r2 = acc_row.copy()
            r2[:, var_index[u]] -= np.eye(mp)
            Grows.append(r2)
            hrows.append(-acc_cst)
            urow = np.zeros((m, nvar))
            urow[:, var_index[u]] = np.eye(m)
            return urow, np.zeros(m)

        def add_term_rows(kind, piece_specs, m, t):
            # pieces - t <= 0  (t broadcast for 'max')
            for spec in piece_specs:
                row, cst = lower_piece(spec, m)
                if kind == "sum":
                    row[:, var_index[t]] -= np.eye(m)
                else:
                    row[:, var_index[t]] -= 1.0
                Grows.append(row)
                hrows.append(-cst)

        for kind, pieces, m, t in obj_terms:
            add_term_rows(kind, pieces, m, t)

        for c, aux_info in con_aux:
            start = _pysum(r.shape[0] for r in Grows)
            if isinstance(c.f, affine):
                row, cst = emit(c.f)
                if c.kind == "<":
                    Grows.append(row)
                    hrows.append(-cst)
                    ineq_rows[c] = (start, len(c.f))
                else:
                    Arows.append(row)
                    brows.append(-cst)
            elif isinstance(c.f, pwl):
                for blk_specs, t in aux_info:
                    add_term_rows("sum", blk_specs, len(c.f), t)
                # aff + sum_t t <= 0
                start = _pysum(r.shape[0] for r in Grows)
                row, cst = emit(c.f.aff)
                for blk, t in aux_info:
                    row[:, var_index[t]] += np.eye(len(c.f))
                Grows.append(row)
                hrows.append(-cst)
                ineq_rows[c] = (start, len(c.f))
            else:  # pwl_scalar (scalar terms broadcast over aff's rows)
                for kind, pieces, m, t in aux_info:
                    add_term_rows(kind, pieces, m, t)
                start = _pysum(r.shape[0] for r in Grows)
                row, cst = emit(c.f.aff)
                for kind, pieces, m, t in aux_info:
                    row[:, var_index[t]] += 1.0
                Grows.append(row)
                hrows.append(-cst)
                ineq_rows[c] = (start, len(c.f.aff))

        G = np.vstack(Grows) if Grows else np.zeros((0, nvar))
        h = np.concatenate(hrows) if hrows else np.zeros(0)
        A = np.vstack(Arows) if Arows else None
        b = np.concatenate(brows) if Arows else None
        return (cvec, const0, G, h, A, b, var_index, ineq_rows,
                varlist, con_aux)


    def solve(self, format="dense", solver=None, options=None,
              relax=False):
        """Canonicalize and solve (reference modeling.py:2579).

        Problems carrying integer columns (``_integer``, populated by
        `fromfile` from MPS 'MARKER' sections) route to ``glpk.ilp``
        with the corresponding I set (reference glpk.c:427-455) unless
        ``relax=True`` forces the LP relaxation."""
        from ..solvers import lp
        from ..solvers._conelp import _host

        def flat(v):    # a result vector, tensor or array, on the host
            return np.asarray(_host(v)).reshape(-1)

        (cvec, const0, G, h, A, b, var_index, ineq_rows, varlist,
         con_aux) = self._build_lp()
        ints = getattr(self, "_integer", None)
        if ints and not relax:
            from .. import glpk
            I = set()
            for v, idxs in ints.items():
                sl = var_index.get(v)
                if sl is not None:
                    I |= {sl.start + int(j) for j in idxs}
            status, x = glpk.ilp(cvec, G, h, A, b, I=I,
                                 options=options)
            self.status = status
            if x is not None:
                xv = np.asarray(x).reshape(-1)
                for v in varlist:
                    v.value = matrix(
                        xv[var_index[v]].copy().reshape(-1, 1))
            return self.status
        if G.shape[0] == 0:
            # ensure a nonempty cone for the solver
            G = np.zeros((1, len(cvec)))
            h = np.ones(1)
        if format == "sparse":
            from ..base import sparse, matrix as _m
            sol = lp(cvec, sparse(_m(G)), h, A, b, solver=solver,
                     options=options)
        else:
            sol = lp(cvec, G, h, A, b, solver=solver, options=options)
        self.status = sol["status"]
        if sol.get("x") is not None:
            x = flat(sol["x"])
            for v in varlist:
                v.value = matrix(x[var_index[v]].copy().reshape(-1, 1))
        if sol.get("z") is not None and self.status == "optimal":
            z = flat(sol["z"])
            for c, _ in con_aux:
                if c in ineq_rows:
                    s0, m = ineq_rows[c]
                    c.multiplier.value = matrix(
                        z[s0:s0 + m].copy().reshape(-1, 1))
            y = flat(sol["y"]) if sol.get("y") is not None else np.zeros(0)
            ofs = 0
            for c, _ in con_aux:
                if c.kind == "=":
                    m = len(c)
                    c.multiplier.value = matrix(
                        y[ofs:ofs + m].copy().reshape(-1, 1))
                    ofs += m
        return self.status

    # -- MPS I/O ---------------------------------------------------------

    def tofile(self, f):
        from .mps import write_mps
        write_mps(self, f)

    def fromfile(self, f):
        from .mps import read_mps
        read_mps(self, f)

    def __repr__(self):
        return f"<optimization problem with {len(self._constraints)} " \
               f"constraints>"

    __str__ = __repr__
