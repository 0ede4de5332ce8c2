"""kvxopt_tpu_torch and chip_smoke.py never import jax or kvxopt_tpu:
the machine with the card has no JAX."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "kvxopt_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|kvxopt_tpu)\b|"
                       r"from\s+(jax|kvxopt_tpu)(\.|\s))", re.M)


def test_importing_every_module_loads_no_jax():
    """Every module of the port imported, msk and gurobi over empty
    stand-ins for the commercial packages they need at import."""
    code = (
        "import importlib, pkgutil, sys, types\n"
        "for b in ('mosek', 'gurobipy'):\n"
        "    sys.modules[b] = types.ModuleType(b)\n"
        "import kvxopt_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'kvxopt_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_source_has_no_jax_import(path):
    assert not FORBIDDEN.search(path.read_text()), path
