"""Fixtures of the benchmark's CPU tests."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.tests.small import SMALL  # noqa: E402


@pytest.fixture
def small_cell():
    """small_cell(name) -> the harness.Cell of workload `name`, its
    configuration cut to SMALL's size."""
    from benchmark import harness

    def make(name, spec=None):
        cell = harness.Cell(name, spec)
        cell.cfg = {**cell.cfg, **SMALL[cell.cfg["name"]]}
        return cell
    return make


@pytest.fixture(autouse=True)
def port_on_cpu():
    """The port's default device is the card; here it is the CPU."""
    from kvxopt_tpu_torch import config
    with config.using_device("cpu"):
        yield
