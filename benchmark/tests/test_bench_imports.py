"""Nothing under benchmark/ imports JAX or the JAX package, compared by
whole top-level module names (kvxopt_tpu_torch begins with kvxopt_tpu),
and the plain reference imports nothing of the port either."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "kvxopt_tpu"}
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_walks_every_module():
    assert BENCH / "run.py" in MODULES and len(MODULES) > 10


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in MODULES if "reference" in p.relative_to(BENCH).parts],
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"kvxopt_tpu_torch"})


def test_names_are_compared_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import kvxopt_tpu_torch.solvers\n"
                     "from kvxopt_tpu_torch import parallel\n")
    assert top_level_imports(probe) == {"kvxopt_tpu_torch"}
    assert not top_level_imports(probe) & FORBIDDEN
    probe.write_text("from kvxopt_tpu.solvers import qp\n")
    assert top_level_imports(probe) & FORBIDDEN == {"kvxopt_tpu"}
