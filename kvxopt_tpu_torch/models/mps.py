"""MPS problem-file I/O for the modeling DSL (reference
modeling.py:2640 tofile, :2760 fromfile).

Supports NAME/ROWS (N,L,G,E)/COLUMNS/RHS/RANGES/BOUNDS
(UP,LO,FX,FR,MI,PL)/ENDATA, fixed- or free-format.  Reading installs one
vector variable (one entry per MPS column) plus the row constraints into
the given op; writing emits the canonicalized LP.  Copy of
kvxopt_tpu/models/mps.py."""

import numpy as np


def read_mps(problem, f):
    from .modeling import variable, affine

    close = False
    if isinstance(f, str):
        f = open(f, "r")
        close = True
    try:
        lines = f.read().splitlines()
    finally:
        if close:
            f.close()

    name = ""
    section = None
    rows = {}        # row name -> type
    row_order = []
    obj_row = None
    cols = {}        # col name -> index
    col_order = []
    entries = []     # (rowname, colname, value)
    rhs = {}
    ranges = {}
    bounds = {}      # col -> [lo, up]
    int_cols = set()  # 'MARKER' INTORG/INTEND integer columns
    in_integer = False

    for raw in lines:
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        if not raw[0].isspace():
            parts = raw.split()
            section = parts[0].upper()
            if section == "NAME":
                name = parts[1] if len(parts) > 1 else ""
            if section == "ENDATA":
                break
            continue
        parts = raw.split()
        if section == "ROWS":
            rtype, rname = parts[0].upper(), parts[1]
            rows[rname] = rtype
            if rtype == "N":
                if obj_row is None:
                    obj_row = rname
            else:
                row_order.append(rname)
        elif section == "COLUMNS":
            if len(parts) >= 2 and "'MARKER'" in (p.upper()
                                                  for p in parts):
                up = [p.upper() for p in parts]
                if "'INTORG'" in up:
                    in_integer = True
                elif "'INTEND'" in up:
                    in_integer = False
                continue
            cname = parts[0]
            if cname not in cols:
                cols[cname] = len(col_order)
                col_order.append(cname)
                if in_integer:
                    int_cols.add(cname)
            for i in range(1, len(parts) - 1, 2):
                entries.append((parts[i], cname, float(parts[i + 1])))
        elif section in ("RHS", "RANGES"):
            # the rhs/range-set name token is optional (the reference
            # writer omits it, modeling.py:2726): if the first token is
            # a known row name, pairs start at 0
            start = 0 if parts[0] in rows else 1
            target = rhs if section == "RHS" else ranges
            for i in range(start, len(parts) - 1, 2):
                target[parts[i]] = float(parts[i + 1])
        elif section == "BOUNDS":
            btype = parts[0].upper()
            # the bound-set name is optional (the reference writer
            # omits it, modeling.py:2750): with a value-less type and
            # two tokens, or a valued type and three, parts[1] is
            # already the column
            if len(parts) >= 4:
                cname, val = parts[2], float(parts[3])
            elif len(parts) == 3:
                if btype in ("UP", "LO", "FX"):
                    try:
                        val = float(parts[2])
                        cname = parts[1]
                    except ValueError:
                        cname, val = parts[2], 0.0
                else:
                    cname, val = parts[2], 0.0
            else:
                cname, val = parts[1], 0.0
            lo, up = bounds.get(cname, [0.0, np.inf])
            if btype == "UP":
                up = val
                if val < 0 and lo == 0.0:
                    lo = -np.inf
            elif btype == "LO":
                lo = val
            elif btype == "FX":
                lo = up = val
            elif btype == "FR":
                lo, up = -np.inf, np.inf
            elif btype == "MI":
                lo = -np.inf
            elif btype == "PL":
                up = np.inf
            else:
                raise ValueError(f"unsupported bound type {btype}")
            bounds[cname] = [lo, up]

    n = len(col_order)
    x = variable(n, name=name or "x")
    # build row coefficient matrix
    ridx = {r: i for i, r in enumerate(row_order)}
    M = np.zeros((len(row_order), n))
    cobj = np.zeros(n)
    for rname, cname, val in entries:
        j = cols[cname]
        if rname == obj_row:
            cobj[j] = val
        elif rname in ridx:
            M[ridx[rname], j] = val

    problem.objective = affine({x: cobj.reshape(1, -1)}, np.zeros(1))
    problem._constraints = []

    for rname in row_order:
        i = ridx[rname]
        row_aff = affine({x: M[i:i + 1, :]}, np.zeros(1))
        rtype = rows[rname]
        rv = rhs.get(rname, 0.0)
        if rtype == "E":
            if rname in ranges:
                r = ranges[rname]
                lo = rv + min(0.0, r)
                hi = rv + max(0.0, r)
                c1 = row_aff <= hi
                c2 = row_aff >= lo
                c1.name, c2.name = rname, rname + "_lo"
                problem._constraints += [c1, c2]
            else:
                c = row_aff == rv
                c.name = rname
                problem._constraints.append(c)
        elif rtype == "L":
            c = row_aff <= rv
            c.name = rname
            problem._constraints.append(c)
            if rname in ranges:
                c2 = row_aff >= rv - abs(ranges[rname])
                c2.name = rname + "_rng"
                problem._constraints.append(c2)
        elif rtype == "G":
            c = row_aff >= rv
            c.name = rname
            problem._constraints.append(c)
            if rname in ranges:
                c2 = row_aff <= rv + abs(ranges[rname])
                c2.name = rname + "_rng"
                problem._constraints.append(c2)

    # bounds
    lo = np.zeros(n)
    up = np.full(n, np.inf)
    for cname, (l, u) in bounds.items():
        lo[cols[cname]] = l
        up[cols[cname]] = u
    for cname in col_order:
        j = cols[cname]
        if cname not in bounds:
            lo[j], up[j] = 0.0, np.inf
    finite_lo = np.isfinite(lo)
    finite_up = np.isfinite(up)
    if finite_lo.any():
        idx = np.where(finite_lo)[0]
        sel = np.zeros((len(idx), n))
        sel[np.arange(len(idx)), idx] = 1.0
        c = affine({x: sel}, np.zeros(len(idx))) >= lo[idx]
        c.name = "_bounds_lo"
        problem._constraints.append(c)
    if finite_up.any():
        idx = np.where(finite_up)[0]
        sel = np.zeros((len(idx), n))
        sel[np.arange(len(idx)), idx] = 1.0
        c = affine({x: sel}, np.zeros(len(idx))) <= up[idx]
        c.name = "_bounds_up"
        problem._constraints.append(c)
    problem.name = name
    # 'MARKER' integrality is preserved (not relaxed): op.solve routes
    # problems with integer columns to glpk.ilp with the I set
    # (reference glpk.c:427-455 builds the same set for glp_intopt)
    problem._integer = {x: sorted(cols[c] for c in int_cols)} \
        if int_cols else {}
    return problem


def _scalar_name(base, i, m, fallback):
    """Reference row/column labels (modeling.py:2671): the name
    truncated to fit, '_', the scalar index — one label per scalar row
    or column of a vector constraint/variable."""
    base = "".join(ch for ch in base if not ch.isspace()) or fallback
    if m == 1 and not base[-1:].isdigit():
        return base[:8]
    return base[:7 - len(str(i))] + "_" + str(i)


def _uniquify(names):
    """Make MPS labels unique in place.  The 8-char truncation of
    `_scalar_name` can collide (e.g. 'LF1003B1'/'LF1003B2' both become
    'LF1003_0'), and an MPS reader merges same-named rows — silently
    DROPPING constraints on a write -> read round trip (the reference
    writer, modeling.py:2671, has the same hazard).  Colliding labels
    get a base-36 suffix that keeps them within 8 characters."""
    seen = {}
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    for k, name in enumerate(names):
        if name not in seen:
            seen[name] = 0
            continue
        while True:
            seen[name] += 1
            c = seen[name]
            suf = ""
            while c:
                c, r = divmod(c, 36)
                suf = digits[r] + suf
            cand = name[:8 - len(suf) - 1] + "~" + suf
            if cand not in seen:
                names[k] = cand
                seen[cand] = 0
                break
    return names


def write_mps(problem, f):
    """Emit the canonicalized LP in MPS form: NAME, ROWS (objective row
    'cost', one L/E row per remaining scalar constraint row labeled from
    the originating constraint's name), COLUMNS (labeled from variable
    names, with 'MARKER' INTORG/INTEND around integer columns), RHS,
    RANGES, BOUNDS, ENDATA.

    Beyond the reference writer (modeling.py:2640 — which emits every
    canonical row as L/E with an empty RANGES section and all-FR
    BOUNDS), structural fidelity is recovered from the canonical form
    (VERDICT r4 #8):
      - singleton G rows (one nonzero) become real BOUNDS entries
        (LO/UP/FX/MI; remaining free columns stay FR),
      - row pairs with exactly opposite coefficients (a'x <= hi and
        -a'x <= hk) collapse to one L row plus a RANGES entry of width
        hi + hk,
    so a bounded/ranged problem round-trips write -> read without row
    duplication, and integer columns survive into glpk.ilp."""
    close = False
    if isinstance(f, str):
        f = open(f, "w")
        close = True
    try:
        (cvec, const0, G, h, A, b, var_index, ineq_rows, varlist,
         con_aux) = problem._build_lp()
        n = len(cvec)
        mG = G.shape[0]
        # ---- structural recovery on the canonical G rows ------------
        is_row = np.ones(mG, bool)
        blo = {}          # col -> max lower bound
        bup = {}          # col -> min upper bound
        nnz = (G != 0.0).sum(axis=1)
        for i in range(mG):
            if nnz[i] == 1:
                j = int(np.nonzero(G[i])[0][0])
                a = G[i, j]
                v = h[i] / a
                if a > 0:
                    bup[j] = min(bup.get(j, np.inf), v)
                else:
                    blo[j] = max(blo.get(j, -np.inf), v)
                is_row[i] = False
        # opposite-row pairs -> RANGES (width hi + hk >= 0)
        rng = {}          # kept row index -> range width
        live = [i for i in range(mG) if is_row[i]]
        sig = {}
        for i in live:
            key = (-G[i]).tobytes()
            if key in sig:
                k = sig[key]          # earlier row with G[k] == -G[i]
                if is_row[k] and h[k] + h[i] >= 0:
                    rng[k] = h[k] + h[i]
                    is_row[i] = False
                    continue
            sig[G[i].tobytes()] = i
        # inequality (G) row labels from originating constraints
        rownames = [f"GROW{i}" for i in range(mG)]
        for k, (c, _aux) in enumerate(con_aux):
            if c in ineq_rows:
                s0, m = ineq_rows[c]
                for i in range(m):
                    rownames[s0 + i] = _scalar_name(
                        c.name or str(k), i, m, f"R{k}")
        # equality (A) row labels: equalities land in con_aux order
        mA = A.shape[0] if A is not None else 0
        eqnames = [f"AROW{i}" for i in range(mA)]
        ofs = 0
        for k, (c, _aux) in enumerate(con_aux):
            if c.kind == "=":
                for i in range(len(c)):
                    eqnames[ofs + i] = _scalar_name(
                        c.name or str(k), i, len(c), f"E{k}")
                ofs += len(c)
        # column labels from variable names
        colnames = [f"X{j}" for j in range(n)]
        for k, v in enumerate(varlist):
            sl = var_index[v]
            idx = range(sl.start, sl.stop) if isinstance(sl, slice) \
                else list(np.atleast_1d(sl))
            m = len(list(idx))
            for i, j in enumerate(idx):
                colnames[j] = _scalar_name(
                    getattr(v, "name", "") or str(k), i, m, f"X{j}")
        # unique labels: colliding truncated names would merge rows or
        # columns on read-back (constraints silently dropped)
        live_rows = [i for i in range(mG) if is_row[i]]
        allrow = ["cost"] + [rownames[i] for i in live_rows] + eqnames
        _uniquify(allrow)
        for k, i in enumerate(live_rows):
            rownames[i] = allrow[1 + k]
        eqnames = allrow[1 + len(live_rows):]
        _uniquify(colnames)
        # integer columns ('MARKER' round trip; read_mps -> _integer)
        int_cols = set()
        for v, idxs in (getattr(problem, "_integer", None) or {}).items():
            sl = var_index.get(v)
            if sl is not None:
                int_cols |= {sl.start + int(j) for j in idxs}
        f.write("NAME")
        if problem.name:
            f.write(10 * " " + problem.name[:8].rjust(8))
        f.write("\n")
        f.write("ROWS\n")
        f.write(" N  %8s\n" % "cost")
        for i in range(mG):
            if is_row[i]:
                f.write(" L  " + rownames[i].rjust(8) + "\n")
        for name in eqnames:
            f.write(" E  " + name.rjust(8) + "\n")
        f.write("COLUMNS\n")
        in_int = False
        nmark = 0
        for j in range(n):
            if (j in int_cols) != in_int:
                tag = "'INTORG'" if not in_int else "'INTEND'"
                f.write(f"    MARKER{nmark}  'MARKER'  {tag:>24}\n")
                in_int = not in_int
                nmark += 1
            cn = colnames[j].rjust(8)
            if cvec[j] != 0.0:
                f.write(f"    {cn}  {'cost':>8}  % 7.5E\n" % cvec[j])
            for i in range(mG):
                if is_row[i] and G[i, j] != 0.0:
                    f.write(f"    {cn}  {rownames[i]:>8}  % 7.5E\n"
                            % G[i, j])
            for i in range(mA):
                if A[i, j] != 0.0:
                    f.write(f"    {cn}  {eqnames[i]:>8}  % 7.5E\n"
                            % A[i, j])
        if in_int:
            tag = "'INTEND'"
            f.write(f"    MARKER{nmark}  'MARKER'  {tag:>24}\n")
        f.write("RHS\n")
        for i in range(mG):
            if is_row[i] and h[i] != 0.0:
                f.write(14 * " " + rownames[i].rjust(8) +
                        "  % 7.5E\n" % h[i])
        for i in range(mA):
            if b[i] != 0.0:
                f.write(14 * " " + eqnames[i].rjust(8) +
                        "  % 7.5E\n" % b[i])
        f.write("RANGES\n")
        for i, w in rng.items():
            f.write(14 * " " + rownames[i].rjust(8) + "  % 7.5E\n" % w)
        f.write("BOUNDS\n")
        for j in range(n):
            lo, up = blo.get(j), bup.get(j)
            cn = colnames[j].rjust(8)
            if lo is None and up is None:
                f.write(" FR " + 10 * " " + cn + "\n")
            elif lo is not None and up is not None and lo == up:
                f.write(" FX " + 10 * " " + cn + "  % 7.5E\n" % lo)
            else:
                if lo is not None:
                    f.write(" LO " + 10 * " " + cn + "  % 7.5E\n" % lo)
                else:
                    f.write(" MI " + 10 * " " + cn + "\n")
                if up is not None:
                    f.write(" UP " + 10 * " " + cn + "  % 7.5E\n" % up)
        f.write("ENDATA\n")
    finally:
        if close:
            f.close()
