"""Matrix formatting (reference src/python/printing.py).

`options` controls the default formats: dformat/iformat are %-style format
strings for 'd'/'i' typecodes, width/height bound the printed block (-1
means unlimited), exactly as the reference (printing.py:20-23).
"""

import numpy as np

options = {"dformat": "% .2e", "iformat": "% i", "width": 7, "height": -1}


def _limits(size):
    width = options.get("width", 7)
    height = options.get("height", -1)
    m, n = size
    pn = n if width is None or width < 0 else min(n, width)
    pm = m if height is None or height < 0 else min(m, height)
    return pm, pn


def matrix_str_default(X):
    """Format a dense matrix per
    printing.options ('dformat', 'width', 'height')."""
    m, n = X.size
    pm, pn = _limits(X.size)
    tc = X.typecode
    if tc == "i":
        fmt = options.get("iformat", "% i")
    else:
        fmt = options.get("dformat", "% .2e")
    a = np.asarray(X)
    rows = []
    for i in range(pm):
        cells = []
        for j in range(pn):
            v = a[i, j]
            if tc == "z":
                cells.append("%s%sj" % (fmt % v.real,
                                        ("+" if v.imag >= 0 else "") +
                                        (fmt % v.imag).strip()))
            else:
                cells.append(fmt % v)
        if pn < n:
            cells.append("...")
        rows.append(" ".join(cells))
    if pm < m:
        rows.append("[...]")
    return "[" + "]\n[".join(rows) + "]\n" if rows else "[]\n"


def spmatrix_str_default(X):
    """Format a sparse matrix like a dense one
    with blanks at structural zeros."""
    m, n = X.size
    pm, pn = _limits(X.size)
    fmt = options.get("dformat", "% .2e")
    a = X.to_scipy().tocsc()
    rows = []
    for i in range(pm):
        cells = []
        for j in range(pn):
            v = a[i, j]
            if a[i, j] != 0 or _in_pattern(a, i, j):
                if X.typecode == "z":
                    cells.append("%s%sj" % (fmt % v.real,
                                            ("+" if v.imag >= 0 else "") +
                                            (fmt % v.imag).strip()))
                else:
                    cells.append(fmt % v)
            else:
                cells.append(" " * max(1, len(fmt % 0.0) - 4) + "0")
        if pn < n:
            cells.append("...")
        rows.append(" ".join(cells))
    if pm < m:
        rows.append("[...]")
    return "[" + "]\n[".join(rows) + "]\n" if rows else "[]\n"


def _in_pattern(csc, i, j):
    lo, hi = csc.indptr[j], csc.indptr[j + 1]
    import numpy as _np
    pos = lo + _np.searchsorted(csc.indices[lo:hi], i)
    return pos < hi and csc.indices[pos] == i


def spmatrix_str_triplet(X):
    """Triplet (i, j, value) listing of a sparse
    matrix's nonzeros."""
    coo = X.to_scipy().tocoo()
    order = np.lexsort((coo.row, coo.col))
    fmt = options.get("dformat", "% .2e")
    lines = []
    for k in order:
        v = coo.data[k]
        if X.typecode == "z":
            sval = "%s%sj" % (fmt % v.real,
                              ("+" if v.imag >= 0 else "") +
                              (fmt % v.imag).strip())
        else:
            sval = fmt % v
        lines.append("(%i,%i) %s" % (coo.row[k], coo.col[k], sval))
    return "\n".join(lines) + ("\n" if lines else "")
