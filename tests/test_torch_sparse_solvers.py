"""The port's host sparse layer (amd, umfpack, klu, cholmod's host LDL'
and the native library) against kvxopt_tpu's: the same seeded scipy
matrices go through both packages, and orderings must be equal and
factors, determinants and solves agree to 1e-12 relative."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

import kvxopt_tpu as jkvx
import kvxopt_tpu_torch as tkvx
from kvxopt_tpu import amd as jamd, cholmod as jchol, klu as jklu
from kvxopt_tpu import umfpack as jumf
from kvxopt_tpu_torch import amd as tamd, cholmod as tchol, klu as tklu
from kvxopt_tpu_torch import native, umfpack as tumf

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-12
PKGS = {"jax": (jkvx, jamd, jumf, jklu, jchol),
        "torch": (tkvx, tamd, tumf, tklu, tchol)}


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(1.0, np.abs(ref).max()))


def rand_csc(n, density, seed, complex_=False, diag_boost=2.0):
    A = sp.random(n, n, density=density, random_state=np.random.RandomState(
        seed), format="csc") + diag_boost * sp.eye(n)
    return (A + 1j * A).tocsc() if complex_ else A.tocsc()


def spd_csc(n, seed, density=0.08, complex_=False):
    A = sp.random(n, n, density=density,
                  random_state=np.random.RandomState(seed), format="csc")
    if complex_:
        A = A + 1j * sp.random(n, n, density=density, random_state=np.random
                               .RandomState(seed + 1), format="csc")
    return (A @ A.conj().T + n * 0.1 * sp.eye(n)).tocsc()


def rhs(n, k, seed, complex_=False):
    r = np.random.default_rng(seed)
    b = r.standard_normal((n, k))
    return b + 1j * r.standard_normal((n, k)) if complex_ else b


def run_both(fn):
    """fn(kvx, amd, umfpack, klu, cholmod) in each package."""
    return fn(*PKGS["jax"]), fn(*PKGS["torch"])


def arrays(xs):
    return [np.asarray(x) for x in xs]


@pytest.mark.parametrize("method", ["amd", "mindeg"])
def test_amd_order_equal(method):
    S = spd_csc(60, 4)
    n = 20
    arrow = sp.csc_matrix((np.r_[[10.0] * n, [1.0] * (2 * n - 2)],
                           (np.r_[np.arange(n), np.arange(1, n), [0] *
                                  (n - 1)],
                            np.r_[np.arange(n), [0] * (n - 1),
                                  np.arange(1, n)])))

    def order(kvx, amd, *_):
        if method == "mindeg":
            amd.options["method"] = "mindeg"
        try:
            return [np.asarray(amd.order(kvx.spmatrix._from_csc(M)))
                    for M in (S, arrow)] + [amd.order_array(
                        kvx.spmatrix._from_csc(S), uplo="U")]
        finally:
            amd.options.pop("method", None)
    ref, got = run_both(order)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert sorted(got[0].reshape(-1).tolist()) == list(range(60))


@pytest.mark.parametrize("complex_", [False, True], ids=["d", "z"])
def test_umfpack_equal(complex_):
    A = rand_csc(60, 0.08, 0, complex_)
    b = rhs(60, 3, 1, complex_)

    def run(kvx, amd, umfpack, klu, cholmod):
        As = kvx.spmatrix._from_csc(A)
        Fs = umfpack.symbolic(As)
        Fn = umfpack.numeric(As, Fs)
        out = arrays(umfpack.get_numeric(As, Fn))
        out.append(umfpack.get_det(As, Fs, Fn))
        for tr in ("N", "T", "C"):
            B = kvx.matrix(b.copy())
            umfpack.solve(As, Fn, B, trans=tr)
            out.append(np.asarray(B))
        B = kvx.matrix(b.copy())
        umfpack.linsolve(As, B)
        return out + [np.asarray(B)]
    ref, got = run_both(run)
    for g, r in zip(got, ref):
        close(g, r)
    close(got[-1], np.linalg.solve(A.toarray(), b), 1e-8)


def test_umfpack_singular_raises_in_both():
    def run(kvx, amd, umfpack, klu, cholmod):
        A = kvx.spmatrix([1.0, 2.0], [0, 1], [0, 0], size=(2, 2))
        with pytest.raises(ArithmeticError):
            umfpack.numeric(A, umfpack.symbolic(A))
    run_both(run)


@pytest.mark.parametrize("complex_", [False, True], ids=["d", "z"])
def test_klu_equal(complex_):
    A = rand_csc(60, 0.08, 4, complex_)
    b = rhs(60, 2, 5, complex_)

    def run(kvx, amd, umfpack, klu, cholmod):
        As = kvx.spmatrix._from_csc(A)
        Fs = klu.symbolic(As)
        Fn = klu.numeric(As, Fs)
        out = arrays(klu.get_numeric(As, Fs, Fn))
        out.append(klu.get_det(As, Fs, Fn))
        for tr in ("N", "T", "C"):
            B = kvx.matrix(b.copy())
            klu.solve(As, Fs, Fn, B, trans=tr)
            out.append(np.asarray(B))
        return out
    ref, got = run_both(run)
    for g, r in zip(got, ref):
        close(g, r)


def test_klu_refactorization_equal():
    """numeric(A2, Fs, N) with a prior N of the same pattern reuses its
    pivots; a prior N of another pattern falls back to a full factor."""
    A = rand_csc(50, 0.1, 5)
    A2 = A.copy()
    A2.data = A2.data * 1.7 + 0.1
    B = rand_csc(50, 0.2, 7)
    b = rhs(50, 2, 8)

    def run(kvx, amd, umfpack, klu, cholmod):
        As, A2s, Bs = (kvx.spmatrix._from_csc(M) for M in (A, A2, B))
        Fs = klu.symbolic(As)
        Fn = klu.numeric(As, Fs)
        Fn2 = klu.numeric(A2s, Fs, Fn)
        out = arrays(klu.get_numeric(A2s, Fs, Fn2))
        X = kvx.matrix(b.copy())
        klu.solve(A2s, Fs, Fn2, X)
        FsB = klu.symbolic(Bs)
        FnB = klu.numeric(Bs, FsB, Fn)
        Y = kvx.matrix(b.copy())
        klu.solve(Bs, FsB, FnB, Y)
        return out + [np.asarray(X), np.asarray(Y), klu.get_det(
            Bs, FsB, FnB)]
    ref, got = run_both(run)
    for g, r in zip(got, ref):
        close(g, r)
    close(A2 @ got[-3], b, 1e-8)


def test_klu_btf_blocks_equal():
    """A scrambled block upper triangular matrix: the same BTF blocks r,
    the same off-diagonal part F and the same factors in both."""
    rng = np.random.default_rng(20)
    n1, n2, n3 = 8, 5, 7
    n = n1 + n2 + n3
    M = np.zeros((n, n))
    for lo, k, seed in ((0, n1, 1), (n1, n2, 2), (n1 + n2, n3, 3)):
        D = np.random.default_rng(seed).standard_normal((k, k))
        M[lo:lo + k, lo:lo + k] = D + k * np.eye(k)
    M[:n1, n1:] = rng.standard_normal((n1, n2 + n3)) * 0.3
    M[n1:n1 + n2, n1 + n2:] = rng.standard_normal((n2, n3)) * 0.3
    A0 = M[rng.permutation(n)][:, rng.permutation(n)]
    b = rhs(n, 2, 21)

    def run(kvx, amd, umfpack, klu, cholmod):
        As = kvx.spmatrix._from_csc(sp.csc_matrix(A0))
        Fs = klu.symbolic(As)
        Fn = klu.numeric(As, Fs)
        out = arrays(klu.get_numeric(As, Fs, Fn))
        X = kvx.matrix(b.copy())
        klu.solve(As, Fs, Fn, X)
        return out + [np.asarray(X), klu.get_det(As, Fs, Fn)]
    ref, got = run_both(run)
    for g, r in zip(got, ref):
        close(g, r)
    assert len(got[6]) >= 4 and np.abs(got[5]).sum() > 0
    close(got[-1], np.linalg.det(A0), 1e-8)


def _host(cholmod):
    old = dict(cholmod.options)
    cholmod.options.update({"supernodal": 2, "device": False})
    return old


def _restore(cholmod, old):
    cholmod.options.clear()
    cholmod.options.update(old)


@pytest.mark.parametrize("complex_", [False, True], ids=["d", "z"])
def test_cholmod_host_sys_codes_equal(complex_):
    """cholmod's host LDL' (options['device'] False): every sys code 0-8,
    diag, getfactor, a refactorization and splinsolve."""
    S = spd_csc(40, 0, complex_=complex_)
    b = rhs(40, 2, 1, complex_)

    def run(kvx, amd, umfpack, klu, cholmod):
        old = _host(cholmod)
        try:
            As = kvx.spmatrix._from_csc(S)
            F = cholmod.symbolic(As)
            cholmod.numeric(As, F)
            assert not getattr(F, "_device", False)
            out = [F.perm]
            for s in range(9):
                B = kvx.matrix(b.copy())
                cholmod.solve(F, B, sys=s)
                out.append(np.asarray(B))
            out += [np.asarray(cholmod.diag(F)),
                    np.asarray(cholmod.getfactor(F))]
            cholmod.numeric(kvx.spmatrix._from_csc(S * 2.0), F)
            B = kvx.matrix(b.copy())
            cholmod.solve(F, B)
            out.append(np.asarray(B))
            if not complex_:    # spsolve takes a real right-hand side
                E = kvx.spmatrix([1.0, 2.0], [0, 5], [0, 0], size=(40, 1))
                out.append(np.asarray(cholmod.splinsolve(As, E)))
            B = kvx.matrix(b.copy())
            cholmod.linsolve(As, B)
            return out + [np.asarray(B)]
        finally:
            _restore(cholmod, old)
    ref, got = run_both(run)
    np.testing.assert_array_equal(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        close(g, r)
    close(S.toarray() @ got[1], b, 1e-8)


def test_cholmod_not_pd_raises_in_both():
    """supernodal != 0 refuses an indefinite matrix; supernodal = 0 factors
    it as LDL'."""
    def run(kvx, amd, umfpack, klu, cholmod):
        old = _host(cholmod)
        try:
            S = kvx.spmatrix([-1.0, 1.0], [0, 1], [0, 1], size=(2, 2))
            F = cholmod.symbolic(S)
            with pytest.raises(ArithmeticError):
                cholmod.numeric(S, F)
            cholmod.options["supernodal"] = 0
            cholmod.numeric(S, F)
            x = kvx.matrix([2.0, 3.0])
            cholmod.solve(F, x)
            return np.asarray(x)
        finally:
            _restore(cholmod, old)
    ref, got = run_both(run)
    np.testing.assert_array_equal(got, ref)
    close(got.reshape(-1), [-2.0, 3.0])


def test_importing_the_port_builds_no_native_library():
    """Importing every module of the port neither compiles nor loads
    host.cpp's library (nor reads host.cpp, which every build hashes):
    that happens at the first call into it.  msk and
    gurobi are imported over empty stand-ins for the commercial packages
    they need at import."""
    code = (
        "import importlib, pkgutil, sys, types\n"
        "_builds = []\n"
        "def _reads(event, args):\n"
        "    if event == 'open' and str(args[0]).endswith('host.cpp'):\n"
        "        _builds.append(args[0])\n"
        "sys.addaudithook(_reads)\n"
        "for b in ('mosek', 'gurobipy'):\n"
        "    sys.modules[b] = types.ModuleType(b)\n"
        "import kvxopt_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from kvxopt_tpu_torch import native\n"
        "assert native._Lazy._cdll is None\n"
        "assert _builds == []\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._build()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native._build()
