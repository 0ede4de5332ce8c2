"""Two public names of the JAX package that the port lacked, against
kvxopt_tpu: config.set_default_dtype/set_compute_dtype and
ConeDims.qblock/sblock.

The setters must reach every reader of config.default_dtype and
config.compute_dtype, which read the module's globals by attribute
although the module's class is config._Config.  Each test restores the
setting it changes.
"""

import numpy as np
import pytest
import torch

from kvxopt_tpu import config as jcfg
from kvxopt_tpu import solvers as jsolvers
from kvxopt_tpu.cones import ConeDims as JDims
from kvxopt_tpu_torch import config as tcfg
from kvxopt_tpu_torch import solvers as tsolvers
from kvxopt_tpu_torch.cones import ConeDims as TDims


@pytest.fixture
def restore_dtypes():
    saved = (jcfg.default_dtype, jcfg.compute_dtype, tcfg.default_dtype,
             tcfg.compute_dtype)
    try:
        yield
    finally:
        (jcfg.default_dtype, jcfg.compute_dtype, tcfg.default_dtype,
         tcfg.compute_dtype) = saved


def test_set_default_dtype_float32_lp(restore_dtypes):
    """After set_default_dtype("float32") the userguide LP solves in f32
    through both packages, with the same status."""
    c = np.array([-4.0, -5.0])
    G = np.array([[2.0, 1.0], [1.0, 2.0], [-1.0, 0.0], [0.0, -1.0]])
    h = np.array([3.0, 3.0, 0.0, 0.0])
    jcfg.set_default_dtype("float32")
    tcfg.set_default_dtype("float32")
    assert tcfg.default_dtype is torch.float32
    ref = jsolvers.lp(c, G, h)
    with tcfg.using_device("cpu"):
        sol = tsolvers.lp(c, G, h)
    assert np.asarray(ref["x"]).dtype == np.float32
    assert sol["x"].dtype == torch.float32
    assert sol["status"] == ref["status"] == "optimal"
    assert abs(sol["iterations"] - ref["iterations"]) <= 1
    np.testing.assert_allclose(sol["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-4)


@pytest.mark.parametrize("name", ["float64", np.float64, torch.float64,
                                  "float16"])
def test_set_compute_dtype(restore_dtypes, name):
    """set_compute_dtype takes a name, a numpy dtype or a torch dtype and
    gives the JAX package's dtype."""
    jcfg.set_compute_dtype(name if not isinstance(name, torch.dtype)
                           else str(name).split(".")[1])
    tcfg.set_compute_dtype(name)
    assert str(tcfg.compute_dtype) == "torch." + np.dtype(
        jcfg.compute_dtype).name


def test_blocks_of_an_lqs_vector():
    """qblock and sblock give the same blocks in both packages on an
    l+q+s vector: each q block's slice and each s block's (m, m) view in
    row-major order of the stored entries."""
    dims = dict(l=3, q=(4, 2), s=(3, 2))
    jd, td = JDims(**dims), TDims(**dims)
    u = np.random.default_rng(0).standard_normal(td.size)
    ut = torch.from_numpy(u)
    for k in range(len(td.q)):
        got = td.qblock(ut, k)
        assert got.shape == (td.q[k],)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jd.qblock(u, k)))
    for k in range(len(td.s)):
        got = td.sblock(ut, k)
        assert got.shape == (td.s[k], td.s[k])
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jd.sblock(u, k)))
