"""The KKT work count and the chip's bound, against hand counts."""

import pytest

from benchmark import roofline


def test_kkt_work_by_hand():
    # n = 3, m = 2, p = 1: syrk 2*9, Cholesky 27/3, L^-1 A' 9*1,
    # Schur 3*1, its Cholesky 1/3; bytes 8 * (9 + 6 + 3 + 9)
    nbytes, flops = roofline.kkt_work(3, 2, 1)
    assert flops == pytest.approx(18 + 9 + 9 + 3 + 1 / 3)
    assert nbytes == 8 * 27


def test_kkt_work_at_the_portfolio_shape():
    nbytes, flops = roofline.kkt_work(1010, 1000, 11)
    assert flops == pytest.approx(1000 * 1010 ** 2 + 1010 ** 3 / 3
                                  + 1010 ** 2 * 11 + 1010 * 121
                                  + 11 ** 3 / 3)
    assert nbytes == 8 * (2 * 1010 ** 2 + 1000 * 1010 + 11 * 1010)
    # the flops bound it: about 20.6 microseconds per factorization
    assert roofline.bound_s(nbytes, flops) == pytest.approx(
        flops / 67e12)


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_kkt_roofline_reader():
    from types import SimpleNamespace

    from benchmark import harness
    mod = harness.load_module(harness.BENCH / "metrics" / "kkt_roofline.py")
    cell = SimpleNamespace(cfg={"n": 3, "k": 1},
                           problem=SimpleNamespace(shapes=lambda c: (3, 2, 1)))
    run = {"cell": cell, "calls": [
        {"seconds": 0.5, "iterations": [4, 6], "optimal": [True, True]},
        {"seconds": 1.5, "iterations": [10], "optimal": [False]}]}
    nbytes, flops = roofline.kkt_work(3, 2, 1)
    want = 100 * roofline.bound_s(20 * nbytes, 20 * flops) / 2.0
    assert mod.read(run) == pytest.approx(want)
    assert mod.read({"cell": cell, "calls": [
        {"seconds": 1.0, "iterations": [0], "optimal": [False]}]}) is None
