"""The port's random generators (kvxopt_tpu_torch.gsl and the facade's
normal, uniform, setseed, getseed) against the JAX package's contract.

The JAX package draws threefry bits and the port a torch.Generator's,
so no test compares draws across the packages.  What they share: the
seed contract (a seed repeats its draws, another seed gives others,
getseed returns it), the shapes and dtypes, and the distributions:
mean and variance within 5 standard errors at 10^5 draws (the standard
error of the variance from the sample's fourth moment), and the bounds.
"""

import math

import numpy as np
import pytest
import torch

import kvxopt_tpu_torch as tpkg
from kvxopt_tpu_torch import config, gsl

N_DRAWS = 100_000

# name -> (arguments, mean, variance, lower bound, upper bound)
DISTRIBUTIONS = {
    "normal": ((1.5, 2.0), 1.5, 4.0, -math.inf, math.inf),
    "uniform": ((-1.0, 3.0), 1.0, 16.0 / 12.0, -1.0, 3.0),
    "weibull": ((2.0, 1.5), 1.5 * math.gamma(1.5),
                1.5 ** 2 * (math.gamma(2.0) - math.gamma(1.5) ** 2),
                0.0, math.inf),
}


@pytest.fixture(autouse=True)
def keep_the_seed():
    seed = gsl.getseed()
    with config.using_device("cpu"):
        yield
    gsl.setseed(seed)


def test_facade_exports_the_generators():
    from kvxopt_tpu_torch import getseed, normal, setseed, uniform
    assert (normal, uniform, setseed, getseed) == (
        gsl.normal, gsl.uniform, gsl.setseed, gsl.getseed)
    assert {"normal", "uniform", "setseed", "getseed"} <= set(tpkg.__all__)


@pytest.mark.parametrize("name", sorted(DISTRIBUTIONS))
@pytest.mark.parametrize("kind", ["matrix", "torch"])
def test_seed_contract(name, kind):
    fn = getattr(gsl, name if kind == "matrix" else name + "_torch")

    def draw(seed):
        gsl.setseed(seed)
        return np.asarray(fn(4, 3)), np.asarray(fn(4, 3))

    a1, a2 = draw(7)
    b1, b2 = draw(7)
    assert gsl.getseed() == 7
    np.testing.assert_array_equal(a1, b1)
    np.testing.assert_array_equal(a2, b2)
    assert not np.array_equal(a1, a2)       # the generator advances
    c1, _ = draw(8)
    assert not np.array_equal(a1, c1)
    assert gsl.getseed() == 8


@pytest.mark.parametrize("name", sorted(DISTRIBUTIONS))
def test_shapes_and_dtypes_match_jax(name):
    from kvxopt_tpu import gsl as jgsl
    for shape in ((5, 1), (3, 4)):
        port, ref = getattr(gsl, name)(*shape), getattr(jgsl, name)(*shape)
        assert port.size == ref.size == shape
        assert port.typecode == ref.typecode == "d"
        t = getattr(gsl, name + "_torch")(*shape)
        r = getattr(jgsl, name + "_jax")(*shape)
        assert tuple(t.shape) == tuple(r.shape) == shape
        assert t.dtype == torch.float64 and str(r.dtype) == "float64"
        assert t.device == config.default_device
    assert gsl.normal(3).size == (3, 1)


@pytest.mark.parametrize("name", sorted(DISTRIBUTIONS))
def test_distribution(name):
    args, mean, var, lo, hi = DISTRIBUTIONS[name]
    gsl.setseed(12345)
    x = np.asarray(getattr(gsl, name)(N_DRAWS, 1, *args)).ravel()
    m, v = x.mean(), x.var(ddof=1)
    m4 = np.mean((x - m) ** 4)
    se_mean = math.sqrt(var / N_DRAWS)
    se_var = math.sqrt((m4 - v ** 2) / N_DRAWS)
    assert abs(m - mean) <= 5 * se_mean, (m, mean, se_mean)
    assert abs(v - var) <= 5 * se_var, (v, var, se_var)
    assert lo <= x.min() and x.max() <= hi
    if math.isfinite(hi):
        assert x.max() < hi                 # U[a, b) never gives b
