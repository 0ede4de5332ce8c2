"""The check must fail its control and the faults the cells can have.

The control is the plain reference computed in float32, put in the
program's place (benchmark/control.py); the faults break the timed path
underneath a whole run of the harness on the CPU: a solve that returns
its state unchanged, half of the batch left out, and an answer altered
where it is produced."""

import time

import pytest
import torch

from benchmark import control, harness

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 3, 987654321])
@pytest.mark.parametrize("name", ["portfolio-b32", "portfolio-single"])
def test_float32_control_is_not_correct(small_cell, name, seed):
    cell = small_cell(name)
    cell.traffic = dict(cell.traffic, check_calls=2)
    numbers, ok = control.control(cell, seed, CPU)
    assert not ok
    assert numbers["not_optimal"] > 0


@pytest.mark.parametrize("name", ["portfolio-b32", "portfolio-single"])
def test_float64_reference_in_the_programs_place_is_correct(small_cell,
                                                            name):
    cell = small_cell(name)
    cell.traffic = dict(cell.traffic, check_calls=2)
    numbers, ok = control.control(cell, 5, CPU, dtype=torch.float64)
    assert ok, numbers


def _unchanged(out):
    """The start of an IPM: x, y zero, s and z the cone's identity."""
    x, y, s, z = out[:4]
    return (torch.zeros_like(x), torch.zeros_like(y), torch.ones_like(s),
            torch.ones_like(z), *out[4:])


def _half(out):
    """Lanes past the first half left out: zeros in their place."""
    x, y, s, z = (t.clone() for t in out[:4])
    h = x.shape[0] // 2
    for t in (x, y, s, z):
        t[h:] = 0.0
    return (x, y, s, z, *out[4:])


def _altered(out):
    x = out[0].clone()
    x[..., 0] += 1e-3
    return (x, *out[1:])


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


def _broken_batch(monkeypatch, fault):
    from kvxopt_tpu_torch import parallel
    real = parallel.batched_qp_solver

    def factory(*a, **k):
        solve = real(*a, **k)
        return lambda *args: FAULTS[fault](solve(*args))
    monkeypatch.setattr(parallel, "batched_qp_solver", factory)


def _broken_front_end(monkeypatch, fault):
    from kvxopt_tpu_torch import solvers
    real = solvers.qp

    def qp(*args, **kw):
        r = real(*args, **kw)
        out = FAULTS[fault]((r["x"][None], r["y"][None], r["s"][None],
                             r["z"][None]))
        return dict(r, **{k: v[0] for k, v in zip("xysz", out)})
    monkeypatch.setattr(solvers, "qp", qp)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_batch_cell_fails_each_fault(small_cell, monkeypatch, fault):
    _broken_batch(monkeypatch, fault)
    line = harness.run(small_cell("portfolio-b32"), 12, 0.2, False,
                       time.perf_counter(), device=CPU)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_single_cell_fails_each_fault(small_cell, monkeypatch, fault):
    _broken_front_end(monkeypatch, fault)
    line = harness.run(small_cell("portfolio-single"), 12, 0.2, False,
                       time.perf_counter(), device=CPU)
    assert line["correct"] is False, line["checks"]
