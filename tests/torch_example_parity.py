"""Shared checks of the example parity tests (tests/test_torch_examples.py
and tests/test_torch_book_examples*.py): the JAX package's example
scripts loaded under names of their own, the result comparison, and the
iteration counts of modeling-DSL solves.

The bar of every comparison: the same status, iterations within 1, x
within 1e-6 (1 + |x|) and the primal objective within 1e-7 (1 + |obj|)
of the JAX package's, on the same numpy data.
"""

import contextlib
import importlib.util
import os

import numpy as np
import torch

EXDIR = os.path.join(os.path.dirname(__file__), "..", "examples")
XTOL, OTOL = 1e-6, 1e-7


def load_jax_example(name):
    """examples/<name>.py as a fresh module named _jax_example_<name>:
    tests/test_examples.py imports the same files by their bare names, so
    the parity tests never share its module objects."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", os.path.join(EXDIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host(v):
    """A result vector of either package as a float64 numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


def rel(a, b):
    """|a - b| / (1 + |b|) in the 2-norm."""
    a, b = host(a).ravel(), host(b).ravel()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / (1.0 + np.linalg.norm(b)))


def close_x(a, b, tol=XTOL):
    d = rel(a, b)
    assert d <= tol, d


def close_obj(a, b, tol=OTOL):
    a, b = float(a), float(b)
    assert abs(a - b) <= tol * (1.0 + abs(b)), (a, b)


def compare(sol, ref, xtol=XTOL, otol=OTOL):
    """The port's result dict `sol` against the JAX package's `ref`; x
    on the CPU as the tests' fixture asks."""
    assert sol["status"] == ref["status"], (sol["status"], ref["status"])
    assert abs(sol["iterations"] - ref["iterations"]) <= 1, (
        sol["iterations"], ref["iterations"])
    assert isinstance(sol["x"], torch.Tensor)
    assert sol["x"].device.type == "cpu"
    close_x(sol["x"], ref["x"], xtol)
    close_obj(sol["primal objective"], ref["primal objective"], otol)


@contextlib.contextmanager
def recorded_lp(*solver_modules):
    """Inside the block each module's solvers.lp call result is kept, in
    order, in one list per module: op.solve keeps only the status, and
    this gives its iterations."""
    seen = [[] for _ in solver_modules]
    saved = [m.lp for m in solver_modules]

    def wrap(fn, out):
        def lp(*args, **kwargs):
            out.append(fn(*args, **kwargs))
            return out[-1]
        return lp
    for m, fn, out in zip(solver_modules, saved, seen):
        m.lp = wrap(fn, out)
    try:
        yield seen
    finally:
        for m, fn in zip(solver_modules, saved):
            m.lp = fn


def compare_ops(ops, jops, lps, jlps):
    """DSL problems: each op's status and objective, and the lp results
    op.solve made, pairwise against the JAX package's."""
    assert len(ops) == len(jops) and len(lps) == len(jlps) == len(ops)
    for p, jp, s, js in zip(ops, jops, lps, jlps):
        assert p.status == jp.status
        compare(s, js)
        close_obj(np.asarray(p.objective.value()).reshape(-1)[0],
                  np.asarray(jp.objective.value()).reshape(-1)[0])


def compare_values(variables, jvariables, tol=XTOL):
    for v, jv in zip(variables, jvariables):
        close_x(np.asarray(v.value), np.asarray(jv.value), tol)
