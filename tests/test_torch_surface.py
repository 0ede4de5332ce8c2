"""The port's public surface against the JAX package's inventory: every
row of tests/test_parity.py's CHECKS table (imported, not copied),
applied to the kvxopt_tpu_torch module of the same name; that file's
type-attribute check on the port's matrix and spmatrix; and the version
the two packages carry."""

import importlib
import sys
import types

import pytest

from tests.test_parity import CHECKS

import kvxopt_tpu
import kvxopt_tpu_torch

PORT_CHECKS = {mod.replace("kvxopt_tpu", "kvxopt_tpu_torch", 1): names
               for mod, names in CHECKS.items()}


@pytest.mark.parametrize("mod", sorted(PORT_CHECKS))
def test_port_module_symbols(mod):
    m = importlib.import_module(mod)
    missing = [s for s in PORT_CHECKS[mod] if not hasattr(m, s)]
    assert not missing, f"{mod} missing {missing}"


def test_port_type_attributes(monkeypatch):
    """tests/test_parity.py's test_type_attributes, run with the port's
    matrix and spmatrix in place of the JAX package's."""
    from tests import test_parity
    fake = types.ModuleType("kvxopt_tpu")
    fake.matrix, fake.spmatrix = (kvxopt_tpu_torch.matrix,
                                  kvxopt_tpu_torch.spmatrix)
    monkeypatch.setitem(sys.modules, "kvxopt_tpu", fake)
    test_parity.test_type_attributes()


def test_port_version_is_the_jax_package_version():
    from kvxopt_tpu import info as jinfo
    from kvxopt_tpu_torch import _version, info
    assert kvxopt_tpu_torch.__version__ == kvxopt_tpu.__version__
    assert _version.version == kvxopt_tpu_torch.__version__
    assert (info.version, info.license) == (jinfo.version, jinfo.license)
