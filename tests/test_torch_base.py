"""The port's matrix and spmatrix (kvxopt_tpu_torch.base, printing and the
facade) against kvxopt_tpu's: each case of tests/test_base.py runs the
same operations, on the same seeded numpy inputs, through both packages,
and the results must be equal (values bit for bit, sizes, typecodes,
printed text and the exceptions raised)."""

import pickle

import numpy as np
import pytest
import torch

import kvxopt_tpu as jkvx
import kvxopt_tpu_torch as tkvx
from kvxopt_tpu_torch import config


def _rng():
    return np.random.default_rng(0)


def case_construction(kvx):
    m = kvx.matrix
    out = [m([1, 2, 3]), m([1.0, 2.0], (1, 2)), m(2.0, (2, 3)),
           m([[1.0, 2.0], [3.0, 4.0]]), m(np.arange(6.0).reshape(2, 3)),
           m([1, 2.5]), m([1, 2 + 1j]), m([1, 2], tc="d")]
    try:
        m([1.5], tc="i")
    except TypeError as e:
        out.append(type(e).__name__)
    return out


def case_block_construction(kvx):
    A = kvx.matrix(_rng().standard_normal((2, 2)))
    return [kvx.matrix([A, A]), kvx.matrix([[A], [A]])]


def case_indexing(kvx):
    A = kvx.matrix(np.arange(12.0).reshape(3, 4, order="F").copy())
    out = [A[0], A[3], A[-1], A[1, :], A[0:2, [1, 3]], A[kvx.matrix([0, 2])]]
    A[0, 0] = -1.0
    A[:, 1] = kvx.matrix([9.0, 9.0, 9.0])
    A[[0, 1]] = 5.0
    return out + [A]


def case_arithmetic(kvx):
    r = _rng()
    A = kvx.matrix(r.standard_normal((3, 3)))
    B = kvx.matrix(r.standard_normal((3, 3)))
    v = kvx.matrix(r.standard_normal(3))
    return [A + B, A - B, 2 * A, A / 2, A * B, A * v, -A, abs(A), A ** 2,
            A + 1.5, 3.0 - A]


def case_complex(kvx):
    r = _rng()
    Z = kvx.matrix(r.standard_normal(4) + 1j * r.standard_normal(4))
    return [Z, Z.H, Z.T, Z.real, Z.imag, Z * Z.H, kvx.conj(Z)]


def case_transpose(kvx):
    A = kvx.matrix(_rng().standard_normal((2, 3)))
    return [A.T, A.trans(), A.ctrans()]


def case_pickle(kvx):
    A = kvx.matrix(np.arange(6.0).reshape(2, 3))
    S = kvx.spmatrix([1.0, 2.0, 3.0], [0, 1, 2], [0, 1, 2], size=(4, 4))
    return [pickle.loads(pickle.dumps(A)), pickle.loads(pickle.dumps(S))]


def case_elementwise(kvx):
    A = kvx.matrix([1.0, 4.0, 9.0])
    X = kvx.matrix(_rng().uniform(0.1, 0.9, 5))
    return [kvx.sqrt(A), kvx.exp(kvx.matrix([0.0])), kvx.log(kvx.matrix(
        [-1.0])), kvx.mul(A, A), kvx.div(A, A), kvx.max(A), kvx.min(A),
        kvx.max(A, 5.0), kvx.min(A, 2.0, 3.0)] + [
        getattr(kvx, f)(X) for f in ("exp", "log", "sqrt", "sin", "cos",
                                     "tan", "asin", "acos", "atan", "sinh",
                                     "cosh", "tanh")] + [
        kvx.emul(X, X), kvx.ediv(X, X), kvx.emin(X, 0.5), kvx.emax(X, 0.5)]


def case_norm(kvx):
    A = kvx.matrix(_rng().standard_normal((3, 4)))
    return [kvx.norm(A, o) for o in ("F", "M", "1", "I")] + [kvx.norm(A)]


def case_blas(kvx):
    r = _rng()
    A = kvx.matrix(r.standard_normal((4, 3)))
    S = kvx.matrix(r.standard_normal((3, 3)))
    S = S + S.T
    x = kvx.matrix(r.standard_normal(3))
    y = kvx.matrix(r.standard_normal(4))
    out = []
    kvx.gemv(A, x, y, alpha=2.0, beta=0.5)
    out.append(y)
    C = kvx.matrix(0.0, (4, 4))
    kvx.gemm(A, A, C, transB="T")
    out.append(C)
    C2 = kvx.matrix(0.0, (4, 4))
    kvx.syrk(A, C2)
    out.append(C2)
    y2 = kvx.matrix(0.0, (3, 1))
    kvx.symv(S, x, y2)
    out.append(y2)
    y3 = kvx.matrix(r.standard_normal(3))
    kvx.axpy(x, y3, alpha=-1.5)
    return out + [y3]


def case_spmatrix_construction(kvx):
    S = kvx.spmatrix([1.0, 2.0, 3.0], [0, 1, 2], [0, 1, 2])
    out = [S, len(S), S[1, 1], S[0, 1],
           kvx.spmatrix([1.0, 1.0], [0, 0], [0, 0], size=(1, 1))]
    S.V = kvx.matrix([4.0, 5.0, 6.0])
    out.append(S)
    try:
        S.V = kvx.matrix([1.0, 2.0])
    except TypeError as e:
        out.append(type(e).__name__)
    return out + [S.I, S.J, *S.CCS]


def case_spmatrix_arithmetic(kvx):
    r = _rng()
    S = kvx.spmatrix(r.standard_normal(5), [0, 1, 2, 0, 2], [0, 1, 2, 2, 1])
    d = kvx.matrix(r.standard_normal(3))
    A = kvx.matrix(r.standard_normal((3, 3)))
    return [S + S, S * d, S * A, S * S, S.T, S - S, 2.0 * S, S / 2.0, -S,
            A + S, S.H]


def case_ipset_ipadd(kvx):
    S = kvx.spmatrix([1.0, 2.0, 3.0], [0, 1, 2], [0, 1, 2])
    S.ipset([10.0], [1], [1])
    S.ipadd([5.0], [1], [1])
    out = [S]
    try:
        S.ipset([1.0], [0], [1])
    except ValueError as e:
        out.append(type(e).__name__)
    return out


def case_sparse_spdiag(kvx):
    A = kvx.matrix(_rng().standard_normal((2, 2)))
    return [kvx.sparse([[A], [A]]), kvx.sparse(A),
            kvx.spdiag([1.0, 2.0, 3.0]), kvx.spdiag([A, kvx.matrix(5.0)]),
            kvx.sparse([kvx.spdiag([1.0, 2.0]), A])]


def case_sparse_indexing(kvx):
    S = kvx.spmatrix([1.0, 2.0], [0, 1], [0, 1], size=(3, 3))
    S[2, 2] = 9.0
    return [S, S[0:2, 0:2], S[:, 1], S[2, 2]]


def case_complex_sparse(kvx):
    r = _rng()
    v = r.standard_normal(4) + 1j * r.standard_normal(4)
    S = kvx.spmatrix(v, [0, 1, 2, 3], [0, 2, 1, 3])
    return [S, S.H, S * S.H, S + S]


def case_printing(kvx):
    A = kvx.matrix([[1.0, 2.0], [3.0, 4.0]])
    S = kvx.spmatrix([1.0], [0], [0], size=(2, 2))
    out = [str(A), str(S), repr(A), repr(S),
           kvx.printing.spmatrix_str_triplet(S)]
    old = dict(kvx.printing.options)
    try:
        kvx.printing.options["width"] = 2
        kvx.printing.options["height"] = 2
        out.append(str(kvx.matrix(np.arange(25.0).reshape(5, 5))))
    finally:
        kvx.printing.options.clear()
        kvx.printing.options.update(old)
    return out


def case_tofile_fromfile(kvx, tmp_path):
    A = kvx.matrix(_rng().standard_normal((3, 2)))
    p = tmp_path / f"{kvx.__name__}.bin"
    with open(p, "wb") as f:
        A.tofile(f)
    with open(p, "rb") as f:
        return [kvx.fromfile(f, (3, 2), "d")]


CASES = [case_construction, case_block_construction, case_indexing,
         case_arithmetic, case_complex, case_transpose, case_pickle,
         case_elementwise, case_norm, case_blas, case_spmatrix_construction,
         case_spmatrix_arithmetic, case_ipset_ipadd, case_sparse_spdiag,
         case_sparse_indexing, case_complex_sparse, case_printing,
         case_tofile_fromfile]


def _plain(x):
    """A comparable form: the type's name, size, typecode and values."""
    name = type(x).__name__
    if name == "matrix":
        return ("matrix", x.size, x.typecode, np.asarray(x))
    if name == "spmatrix":
        return ("spmatrix", x.size, x.typecode, np.asarray(x.I),
                np.asarray(x.J), np.asarray(x.V))
    return (name, x)


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
            a, b, equal_nan=True)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(u, v) for u, v in zip(a, b))
    return a == b


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_base_matches_jax(case, tmp_path):
    args = (tmp_path,) if case is case_tofile_fromfile else ()
    ref = [_plain(x) for x in case(jkvx, *args)]
    got = [_plain(x) for x in case(tkvx, *args)]
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g[0] == r[0], (i, g, r)
        assert _equal(g, r), (i, g, r)


def test_to_torch_goes_to_the_default_device():
    r = _rng()
    A = tkvx.matrix(r.standard_normal((3, 2)))
    S = tkvx.spmatrix([1.0, 2.0], [0, 2], [1, 0], size=(3, 2))
    Z = tkvx.matrix(r.standard_normal(2) + 1j * r.standard_normal(2))
    with config.using_device("cpu"):
        a, s, z = A.to_torch(), S.to_torch(), Z.to_torch()
    assert a.device.type == s.device.type == "cpu"
    assert a.dtype == s.dtype == torch.float64 and z.dtype == torch.complex128
    np.testing.assert_array_equal(a.numpy(), np.asarray(A))
    np.testing.assert_array_equal(s.numpy(), np.asarray(S))
    np.testing.assert_array_equal(z.numpy(), np.asarray(Z))
    assert tkvx.matrix([1, 2]).to_torch("cpu").dtype == torch.int64
    f = A.to_torch("cpu", torch.float32)
    assert f.dtype == torch.float32


def test_front_ends_take_the_port_matrix_types():
    """coneqp and conelp take the port's matrix and spmatrix, as the JAX
    package's take its own (tests/test_base.py's solver test): the same
    status, iterations and x to 1e-7."""
    from kvxopt_tpu import solvers as jsolvers
    from kvxopt_tpu_torch import solvers as tsolvers
    rows = [[2.0, 1.0, -1.0, 0.0], [1.0, 2.0, 0.0, -1.0]]
    c, h = [-4.0, -5.0], [3.0, 3.0, 0.0, 0.0]
    P = [[2.0, 0.5], [0.5, 1.0]]
    sols = {}
    for name, kvx, solvers in (("jax", jkvx, jsolvers),
                               ("torch", tkvx, tsolvers)):
        G = kvx.sparse(kvx.matrix(rows))
        args = (kvx.matrix(c), G, kvx.matrix(h))
        if name == "torch":
            with config.using_device("cpu"):
                sols[name] = (tsolvers.conelp(*args, {"l": 4}),
                              tsolvers.coneqp(kvx.matrix(P), *args))
        else:
            sols[name] = (solvers.conelp(*args, {"l": 4}),
                          solvers.coneqp(kvx.matrix(P), *args))
    for ref, got in zip(sols["jax"], sols["torch"]):
        assert got["status"] == ref["status"] == "optimal"
        assert abs(got["iterations"] - ref["iterations"]) <= 1
        np.testing.assert_allclose(np.asarray(got["x"]).reshape(-1),
                                   np.asarray(ref["x"]).reshape(-1),
                                   atol=1e-7)
    np.testing.assert_allclose(np.asarray(sols["torch"][0]["x"]),
                               [1.0, 1.0], atol=1e-6)
