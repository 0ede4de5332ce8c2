"""The port's modeling layer (kvxopt_tpu_torch.modeling and models/mps.py)
against the JAX package's, problem by problem: the cases of
tests/test_modeling.py and the modeling examples (lp_modeling, normappr,
roblp, l1svc) at their sizes, on seeded numpy data.  Each case builds
the same model with each package's own modeling module and solves it,
the port on the CPU.

Tolerances: the same status; the objective and every variable's value
within 1e-7 (1 + |value|); every constraint multiplier within
1e-6 (1 + |value|); names and the MPS files' text equal.
"""

import numpy as np
import pytest

import kvxopt_tpu as jpkg
import kvxopt_tpu.modeling as jmod
import kvxopt_tpu_torch as tpkg
from chip_smoke import INT_MPS
import kvxopt_tpu_torch.modeling as tmod
from kvxopt_tpu_torch import config

VALUE_TOL, MUL_TOL = 1e-7, 1e-6


def record(prob, variables=None, constraints=None):
    """What a solve gives a user: status, objective, the variables'
    values and the constraints' multipliers (None where unset)."""
    def flat(v):
        return None if v is None else np.asarray(v, dtype=float).ravel()
    variables = prob.variables() if variables is None else variables
    constraints = (prob.constraints() if constraints is None
                   else constraints)
    return {"status": prob.status,
            "objective": flat(prob.objective.value()),
            "values": [flat(v.value) for v in variables],
            "multipliers": [flat(c.multiplier.value) for c in constraints]}


def close(a, b, tol, what):
    if b is None:
        assert a is None, what
        return
    assert a is not None and a.shape == b.shape, (what, a, b)
    err = np.abs(a - b).max(initial=0.0)
    assert err <= tol * (1 + np.abs(b).max(initial=0.0)), (what, err)


def compare(port, ref):
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert set(p) == set(r)
        for key, rv in r.items():
            pv = p[key]
            if key in ("values", "multipliers"):
                assert len(pv) == len(rv), (i, key)
                tol = VALUE_TOL if key == "values" else MUL_TOL
                for j, (a, b) in enumerate(zip(pv, rv)):
                    close(a, b, tol, (i, key, j))
            elif key == "objective":
                close(pv, rv, VALUE_TOL, (i, key))
            else:
                assert pv == rv, (i, key, pv, rv)


def run(case, tmp_path):
    """case(pkg, mod, folder) with the port on the CPU and with the JAX
    package -> (port's records, JAX's records)."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    with config.using_device("cpu"):
        port = case(tpkg, tmod, tmp_path / "port")
    return port, case(jpkg, jmod, tmp_path / "jax")


# ---------------------------------------------------------------------------
# The cases of tests/test_modeling.py
# ---------------------------------------------------------------------------

def scalar_lp(pkg, mod, tmp):
    x, y = mod.variable(), mod.variable()
    cs = [2 * x + y <= 3, x + 2 * y <= 3, x >= 0, y >= 0]
    lp1 = mod.op(-4 * x - 5 * y, cs)
    lp1.solve()
    return [record(lp1, [x, y], cs)]


def matrix_lp(pkg, mod, tmp, fmt="dense"):
    x = mod.variable(2)
    A = pkg.matrix([[2.0, 1.0, -1.0, 0.0], [1.0, 2.0, 0.0, -1.0]])
    b = pkg.matrix([3.0, 3.0, 0.0, 0.0])
    ineq = (A * x <= b)
    lp2 = mod.op(mod.dot(pkg.matrix([-4.0, -5.0]), x), ineq)
    lp2.solve(format=fmt)
    return [record(lp2, [x], [ineq])]


def pwl_data(m=200, n=40, seed=100):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), rng.standard_normal((m, 1))


def pwl_problem(kind, fmt="dense", solver=None):
    def case(pkg, mod, tmp):
        An, bn = pwl_data()
        A, b = pkg.matrix(An), pkg.matrix(bn)
        x = mod.variable(An.shape[1])
        r = A * x - b
        f = {"max abs": lambda: mod.max(abs(r)),
             "sum abs": lambda: mod.sum(abs(r)),
             "deadzone": lambda: mod.sum(mod.max(0, abs(r) - 0.75,
                                                 2 * abs(r) - 2.25))}[kind]
        prob = mod.op(f())
        prob.solve(format=fmt, solver=solver)
        return [record(prob, [x])]
    return case


def min_constraint(pkg, mod, tmp):
    x = mod.variable()
    c = (mod.min(x, 4 - x) >= 1)
    prob = mod.op(x, [c])
    prob.solve()
    return [record(prob, [x], [c])]


def variable_indexing(pkg, mod, tmp):
    x = mod.variable(3)
    cs = [x[0] + x[1] + x[2] == 1, x >= 0]
    prob = mod.op(x[0] - 2 * x[2], cs)
    prob.solve()
    return [record(prob, [x], cs)]


def mps_roundtrip(pkg, mod, tmp):
    x = mod.variable(2)
    prob = mod.op(mod.dot(pkg.matrix([-4.0, -5.0]), x),
                  [pkg.matrix([[2.0, 1.0, -1.0, 0.0],
                               [1.0, 2.0, 0.0, -1.0]]) * x <=
                   pkg.matrix([3.0, 3.0, 0.0, 0.0])])
    path = str(tmp / "prob.mps")
    prob.tofile(path)
    lp = mod.op()
    lp.fromfile(path)
    lp.solve()
    return [record(lp)]


def nested_multiblock_pwl(pkg, mod, tmp):
    rng = np.random.default_rng(21)
    m, n = 30, 6
    A1, b1, A2, b2 = (pkg.matrix(rng.standard_normal(s))
                      for s in ((m, n), (m, 1), (m, n), (m, 1)))
    x = mod.variable(n)
    prob = mod.op(mod.max(abs(A1 * x - b1) + abs(A2 * x - b2)))
    prob.solve()
    return [record(prob, [x])]


def nested_pwl_in_constraint(pkg, mod, tmp):
    x = mod.variable(2)
    c = (abs(x[0]) + abs(x[1]) <= 1)
    prob = mod.op(-x[0] - 0.5 * x[1], [c])
    prob.solve()
    return [record(prob, [x], [c])]


def renamed_multiplier(pkg, mod, tmp):
    x = mod.variable(2, name="x")
    c = x <= 1.0
    names = []
    for name in ("cap", "newname"):
        c.name = name
        names.append(c.multiplier.name)
    return [{"names": names}]


def mps_roundtrip_named(pkg, mod, tmp):
    x = mod.variable(2, name="xvar")
    A = pkg.matrix(np.array([[2., 1.], [1., 2.], [-1., 0.], [0., -1.]]))
    b = pkg.matrix(np.array([3., 3., 0., 0.]).reshape(-1, 1))
    c1 = (A * x <= b)
    c1.name = "ineq"
    c2 = (x[0] + x[1] == 1.5)
    c2.name = "bal"
    lp = mod.op(-4.0 * x[0] - 5.0 * x[1], [c1, c2], name="test")
    lp.solve()
    path = tmp / "t.mps"
    lp.tofile(str(path))
    lp2 = mod.op()
    lp2.fromfile(str(path))
    lp2.solve()
    return [record(lp, [x], [c1, c2]), record(lp2),
            {"text": path.read_text(),
             "names": sorted(c.name for c in lp2.constraints())}]


def nested_scalar_pwl_in_max(pkg, mod, tmp):
    x = mod.variable(3)
    p = mod.op(mod.max(mod.max(abs(x)), 0.5),
               [x >= -3, x <= 3, mod.sum(x) == 1])
    p.solve()
    y = mod.variable(2)
    q = mod.op(mod.sum(y), [mod.max(mod.sum(abs(y)), 1.5) <= 2.0, y >= -4])
    q.solve()
    z = mod.variable(3)
    r = mod.op(mod.sum(mod.max(mod.max(mod.max(abs(z)), 0.5), z)),
               [z >= -3, z <= 3, mod.sum(z) == 1])
    r.solve()
    return [record(p, [x]), record(q, [y]), record(r, [z])]


def mps_bounded_ranged_roundtrip(pkg, mod, tmp):
    x = mod.variable(3, name="v")
    A = pkg.matrix(np.array([[1.0, 2.0, 1.0], [-1.0, -2.0, -1.0]]))
    c1 = (A * x <= pkg.matrix(np.array([8.0, -2.0]).reshape(-1, 1)))
    c1.name = "band"
    cb = [x <= pkg.matrix(np.array([4.0, 5.0, 6.0]).reshape(-1, 1)),
          x >= pkg.matrix(np.array([-1.0, 0.0, 1.0]).reshape(-1, 1))]
    prob = mod.op(mod.dot(pkg.matrix([1.0, -2.0, 0.5]), x), [c1] + cb,
                  name="rng")
    prob.solve()
    out = [record(prob, [x], [c1] + cb)]
    path = tmp / "rng.mps"
    prob.tofile(str(path))
    out.append({"text": path.read_text()})
    for _ in range(2):
        lp = mod.op()
        lp.fromfile(str(path))
        lp.solve()
        out.append(record(lp))
        path = tmp / "rng2.mps"
        lp.tofile(str(path))
    return out


def mps_integer_marker(pkg, mod, tmp):
    path = tmp / "int.mps"
    path.write_text(INT_MPS)
    prob = mod.op()
    prob.fromfile(str(path))
    prob.solve()
    out = [record(prob), {"integer": sorted(
        (v.name, sorted(int(i) for i in idx))
        for v, idx in prob._integer.items())}]
    prob.solve(relax=True)
    out.append(record(prob))
    path2 = tmp / "int2.mps"
    prob.tofile(str(path2))
    p2 = mod.op()
    p2.fromfile(str(path2))
    p2.solve()
    return out + [record(p2), {"text": path2.read_text()}]


# ---------------------------------------------------------------------------
# The modeling examples (examples/*.py), on numpy data at their sizes
# ---------------------------------------------------------------------------

def example_data(m=200, n=50, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)), rng.standard_normal((m, 1)),
            rng.uniform(size=(m, 1)), rng.standard_normal((n, 1)))


def lp_modeling(pkg, mod, tmp):
    x, y = mod.variable(), mod.variable()
    cs = [2 * x + y <= 3, x + 2 * y <= 3, x >= 0, y >= 0]
    lp1 = mod.op(-4 * x - 5 * y, cs)
    lp1.solve()
    x2 = mod.variable(2)
    A = np.array([[2., 1.], [1., 2.], [-1., 0.], [0., -1.]])
    ineq = (A * x2 <= np.array([3., 3., 0., 0.]))
    lp2 = mod.op(mod.dot(np.array([-4., -5.]), x2), ineq)
    lp2.solve()
    return [record(lp1, [x, y], cs), record(lp2, [x2], [ineq])]


def normappr(pkg, mod, tmp):
    An, bn, _, _ = example_data()
    A, b = pkg.matrix(An), pkg.matrix(bn)
    out = []
    for f in (lambda r: mod.max(abs(r)), lambda r: mod.sum(abs(r)),
              lambda r: mod.sum(mod.max(0, abs(r) - 0.75,
                                        2 * abs(r) - 2.25))):
        x = mod.variable(An.shape[1])
        prob = mod.op(f(A * x + b))
        prob.solve()
        out.append(record(prob, [x]))
    return out


def roblp(pkg, mod, tmp):
    An, _, un, cn = example_data()
    A, b, c = pkg.matrix(An), pkg.matrix(un), pkg.matrix(cn)
    n = An.shape[1]
    x = mod.variable(n)
    c1 = (A * x + mod.sum(abs(x)) <= b)
    p1 = mod.op(mod.dot(c, x), c1)
    p1.solve()
    x2, y = mod.variable(n), mod.variable(n)
    cs = [A * x2 + mod.sum(y) <= b, -y <= x2, x2 <= y]
    p2 = mod.op(mod.dot(c, x2), cs)
    p2.solve()
    return [record(p1, [x], [c1]), record(p2, [x2, y], cs)]


def l1svc(pkg, mod, tmp):
    An, _, _, _ = example_data()
    A = pkg.matrix(An)
    m, n = An.shape
    x, u = mod.variable(n, "x"), mod.variable(m, "u")
    cs = [A * x >= 1 - u, u >= 0]
    p1 = mod.op(mod.sum(abs(x)) + mod.sum(u), cs)
    p1.solve()
    x2 = mod.variable(n, "x")
    p2 = mod.op(mod.sum(abs(x2)) + mod.sum(mod.max(0, 1 - A * x2)))
    p2.solve()
    return [record(p1, [x, u], cs), record(p2, [x2])]


CASES = {
    "scalar lp": scalar_lp,
    "matrix lp": matrix_lp,
    "matrix lp sparse": lambda *a: matrix_lp(*a, fmt="sparse"),
    "pwl max abs": pwl_problem("max abs"),
    "pwl sum abs": pwl_problem("sum abs"),
    "pwl deadzone": pwl_problem("deadzone"),
    "pwl sum abs sparse": pwl_problem("sum abs", fmt="sparse"),
    "pwl sum abs glpk": pwl_problem("sum abs", solver="glpk"),
    "min constraint": min_constraint,
    "variable indexing": variable_indexing,
    "mps roundtrip": mps_roundtrip,
    "nested multiblock pwl": nested_multiblock_pwl,
    "nested pwl in constraint": nested_pwl_in_constraint,
    "renamed multiplier": renamed_multiplier,
    "mps roundtrip named": mps_roundtrip_named,
    "nested scalar pwl in max": nested_scalar_pwl_in_max,
    "mps bounded ranged roundtrip": mps_bounded_ranged_roundtrip,
    "mps integer marker": mps_integer_marker,
    "example lp_modeling": lp_modeling,
    "example normappr": normappr,
    "example roblp": roblp,
    "example l1svc": l1svc,
}


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(name, tmp_path):
    port, ref = run(CASES[name], tmp_path)
    compare(port, ref)
    statuses = [r["status"] for r in ref if "status" in r]
    assert all(s == "optimal" for s in statuses), statuses


def test_exceptions():
    for mod in (tmod, jmod):
        with pytest.raises(TypeError):
            mod.variable(0)


def test_integer_marker_solution(tmp_path):
    """tests/test_modeling.py's expected x: integer x1, continuous x2."""
    with config.using_device("cpu"):
        out = mps_integer_marker(tpkg, tmod, tmp_path)
    np.testing.assert_allclose(out[0]["values"][0], [5.0, 0.5], atol=1e-6)
    assert abs(out[2]["values"][0][0] - 5.75) < 1e-4
    assert "'INTORG'" in out[-1]["text"] and "'INTEND'" in out[-1]["text"]


def test_solve_on_the_default_device_raises_without_a_card(monkeypatch):
    """op.solve runs on config.default_device: with no card and no
    device named it raises, as every front end does."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = tmod.variable()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmod.op(x, [x >= 1]).solve()
