"""Executor dispatch of the port (config.dispatch_device(_batched),
solvers.coneprog._veclen/_dispatch_ctx in every front end,
parallel.batch._dispatched_batch, the thread-local config.using_device
and ops.ipm_chol's kernels at every n) against the JAX package's
(kvxopt_tpu/config.py, tests/test_dispatch.py).

There is no card here.  Where a test needs the route to be taken, the
`fake_card` fixture keeps config.default_device the card and tells
config that one is present (config._card_missing): a solve routed to
the host then runs on the CPU, and one left on the card raises, since
torch has no CUDA device to place it on.  So the device of a result, or
the RuntimeError, shows which way the front end went.  The bars: the
same decision as JAX's on every size and threshold; a routed solve
bit-equal to the same solve on the CPU and within 1e-9 of JAX's.
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kvxopt_tpu_torch import ConeDims, config
from kvxopt_tpu_torch import solvers as tsolvers
from kvxopt_tpu_torch.ops import chol_ls, ipm_chol
from kvxopt_tpu_torch.parallel import batch
from kvxopt_tpu_torch.solvers import coneprog

SIZES = (0, 1, 63, 64, 511, 512, 2047, 2048, 10 ** 9)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fake_card(monkeypatch):
    """The card is the default device and config believes it is there;
    both thresholds 64."""
    monkeypatch.setattr(config, "default_device", torch.device("cuda"))
    monkeypatch.setattr(config, "_card_missing", lambda: False)
    monkeypatch.setattr(config, "host_dispatch_threshold", 64)
    monkeypatch.setattr(config, "host_dispatch_threshold_batched", 64)


# ---------------------------------------------------------------------------
# The policy: the same decision as the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("single", (0, 64, 512))
@pytest.mark.parametrize("batched", (0, 64, 512, 2048))
def test_decisions_match_jax(monkeypatch, single, batched):
    from kvxopt_tpu import config as jconfig
    host = object()
    for cfg in (jconfig, config):
        monkeypatch.setattr(cfg, "accelerator_is_host", lambda: False)
        monkeypatch.setattr(cfg, "host_device", lambda: host)
        monkeypatch.setattr(cfg, "host_dispatch_threshold", single)
        monkeypatch.setattr(cfg, "host_dispatch_threshold_batched", batched)
    monkeypatch.setattr(config, "_card_missing", lambda: False)
    for n in SIZES:
        for fn in ("dispatch_device", "dispatch_device_batched"):
            t = single if fn == "dispatch_device" else min(single, batched)
            want = host if 0 < t and n < (
                single if fn == "dispatch_device" else batched) else None
            assert getattr(jconfig, fn)(n) is want, (fn, n)
            assert getattr(config, fn)(n) is want, (fn, n)


def _veclen_inputs(pkg):
    return {
        "1-D": np.zeros(7), "2-D": np.zeros((3, 4)), "0-D": np.float64(2.0),
        "list": [1.0, 2.0, 3.0], "tuple": (1.0, 2.0), "None": None,
        "matrix": pkg.matrix(np.ones((3, 2))),
        "spmatrix": pkg.spmatrix([1.0, 2.0], [0, 1], [0, 1], (4, 3)),
        "callable": lambda v: v,
    }


@pytest.mark.parametrize("kind", ("1-D", "2-D", "0-D", "list", "tuple",
                                  "None", "matrix", "spmatrix", "callable"))
def test_veclen_matches_jax(kind):
    import kvxopt_tpu
    import kvxopt_tpu_torch
    from kvxopt_tpu.solvers import coneprog as jconeprog
    want = jconeprog._veclen(_veclen_inputs(kvxopt_tpu)[kind])
    assert coneprog._veclen(_veclen_inputs(kvxopt_tpu_torch)[kind]) == want
    assert want == {"1-D": 7, "2-D": 12, "0-D": 1, "list": 3, "tuple": 2,
                    "matrix": 6, "spmatrix": 12}.get(kind)


def test_veclen_of_a_tensor():
    assert coneprog._veclen(torch.zeros((5, 3))) == 15


def test_noop_when_the_default_device_is_the_cpu(monkeypatch):
    monkeypatch.setattr(config, "host_dispatch_threshold", 512)
    monkeypatch.setattr(config, "host_dispatch_threshold_batched", 2048)
    with config.using_device("cpu"):
        assert config.accelerator_is_host()
        assert config.dispatch_device(1) is None
        assert config.dispatch_device_batched(1) is None
        assert isinstance(coneprog._dispatch_ctx(1), contextlib.nullcontext)


def test_no_card_raises_at_every_size(monkeypatch):
    """The default device is the card and there is none: nothing is
    routed, so the front ends and the batch drivers raise below the
    threshold as above it."""
    monkeypatch.setattr(config, "default_device", torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(config, "host_dispatch_threshold", 64)
    monkeypatch.setattr(config, "host_dispatch_threshold_batched", 64)
    assert config.dispatch_device(1) is None
    assert config.dispatch_device_batched(1) is None
    c, G, h = userguide_lp()
    for call in (lambda: tsolvers.lp(c, G, h),
                 lambda: tsolvers.conelp(c, G, h, {"l": 4}),
                 lambda: tsolvers.qp(np.eye(2), c, G, h),
                 lambda: batch.batched_lp_solver(ConeDims(l=4))(
                     c[None], G[None], h[None])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# The front ends route before any array is placed
# ---------------------------------------------------------------------------

def userguide_lp():
    """tests/test_dispatch.py's LP."""
    c = np.array([-4., -5.])
    G = np.array([[2., 1.], [1., 2.], [-1., 0.], [0., -1.]])
    h = np.array([3., 3., 0., 0.])
    return c, G, h


def userguide_socp():
    G1 = -np.array([[-12.0, -6.0, 5.0], [-13.0, 3.0, 5.0],
                    [-12.0, 12.0, -6.0]])
    G2 = -np.array([[-3.0, 6.0, -10.0], [-3.0, 6.0, 2.0], [1.0, 9.0, 2.0],
                    [-1.0, -19.0, 3.0]])
    return (np.array([-2.0, 1.0, 5.0]), [G1, G2],
            [np.array([-12.0, -3.0, -2.0]), np.array([27.0, 0.0, 3.0, -42.0])])


def userguide_sdp():
    Gs = [np.array([[-7.0, -11.0, -11.0, 3.0], [7.0, -18.0, -18.0, 8.0],
                    [-2.0, -8.0, -8.0, 1.0]]).T,
          np.array([[-21.0, -11.0, 0.0, -11.0, 10.0, 8.0, 0.0, 8.0, 5.0],
                    [0.0, 10.0, 16.0, 10.0, -10.0, -10.0, 16.0, -10.0, 3.0],
                    [-5.0, 2.0, -17.0, 2.0, -6.0, 8.0, -17.0, 8.0, 6.0]]).T]
    hs = [np.array([[33.0, -9.0], [-9.0, 26.0]]),
          np.array([[14.0, 9.0, 40.0], [9.0, 91.0, 10.0],
                    [40.0, 10.0, 15.0]])]
    return np.array([1.0, -1.0, 1.0]), Gs, hs


def disc():
    """One nonlinear constraint x0^2 + x1^2 <= 1, x0 numpy."""
    def F(x=None, z=None):
        if x is None:
            return 1, np.zeros(2)
        f = (x[0] ** 2 + x[1] ** 2 - 1.0).reshape(1)
        Df = (2.0 * x).reshape(1, 2)
        if z is None:
            return f, Df
        return f, Df, z[0] * 2.0 * torch.eye(2, dtype=x.dtype)
    return F


def quadratic():
    """minimize |x - (1, 2)|^2 subject to x <= 0.5, x0 numpy."""
    def F(x=None, z=None):
        if x is None:
            return 0, np.zeros(2)
        d = x - torch.tensor([1.0, 2.0], dtype=x.dtype)
        Df = (2.0 * d).reshape(1, 2)
        if z is None:
            return (d @ d).reshape(1), Df
        return (d @ d).reshape(1), Df, z[0] * 2.0 * torch.eye(2,
                                                             dtype=x.dtype)
    return F


def gp_userguide():
    """examples/gp.py: the userguide's box."""
    F = np.array([[-1., 1., 1., 0., -1., 1., 0., 0.],
                  [-1., 1., 0., 1., 1., -1., 1., -1.],
                  [-1., 0., 1., 1., 0., 0., -1., 1.]]).T
    g = np.log([1.0, 2 / 100.0, 2 / 100.0, 1 / 1000.0, 0.5, 1 / 2.0, 0.5,
                1 / 2.0])
    return [1, 2, 1, 1, 1, 1, 1], F, g


def _front_end_calls():
    c, G, h = userguide_lp()
    P = np.array([[2.0, 0.5], [0.5, 1.0]])
    sc, Gq, hq = userguide_socp()
    dc, Gs, hs = userguide_sdp()
    box = (np.vstack([np.eye(2), -np.eye(2)]), np.ones(4))
    return {
        "coneqp": lambda: tsolvers.coneqp(P, c, G, h, {"l": 4}),
        "qp": lambda: tsolvers.qp(P, c, G, h),
        "conelp": lambda: tsolvers.conelp(c, G, h, {"l": 4}),
        "lp": lambda: tsolvers.lp(c, G, h),
        "lp equilibrate": lambda: tsolvers.lp(
            c, G, h, options={"equilibrate": True}),
        "socp": lambda: tsolvers.socp(sc, Gq=Gq, hq=hq),
        "sdp": lambda: tsolvers.sdp(dc, Gs=Gs, hs=hs),
        "cpl": lambda: tsolvers.cpl(np.array([1.0, 1.0]), disc(), *box),
        "cp": lambda: tsolvers.cp(quadratic(), box[0], 0.5 * box[1]),
        "gp": lambda: tsolvers.gp(*gp_userguide()),
    }


@pytest.mark.parametrize("name", sorted(_front_end_calls()))
def test_front_end_routes_below_the_threshold(fake_card, name):
    sol = _front_end_calls()[name]()
    assert sol["status"] == "optimal"
    assert sol["x"].device.type == "cpu"


# the order n + m + p of each call's KKT system, counted by hand (cp:
# mnl = 0, the box's 4 rows; cpl: the disc's one nonlinear row; gp: six
# posynomial constraints)
KKT_ORDERS = {"coneqp": 6, "qp": 6, "conelp": 6, "lp": 6,
              "lp equilibrate": 6, "socp": 10, "sdp": 16, "cpl": 7,
              "cp": 6, "gp": 9}


@pytest.mark.parametrize("name", sorted(_front_end_calls()))
def test_front_end_size_is_the_kkt_order(fake_card, monkeypatch, name):
    """A call stays at a threshold equal to its KKT order and is routed
    at one more."""
    order = KKT_ORDERS[name]
    monkeypatch.setattr(config, "host_dispatch_threshold", order)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _front_end_calls()[name]()
    monkeypatch.setattr(config, "host_dispatch_threshold", order + 1)
    assert _front_end_calls()[name]()["x"].device.type == "cpu"


def test_batch_size_is_the_kkt_order(fake_card, monkeypatch):
    """_dispatched_batch sizes a call by n + m + p per instance: q's
    last dimension, G's rows and A's rows (positional or keyword)."""
    seen = []

    def spy(*args, **kwargs):
        seen.append(config.default_device.type)

    q, G, A = np.zeros((2, 5)), np.zeros((2, 7, 5)), np.zeros((2, 3, 5))
    for t, want in ((15, "cuda"), (16, "cpu")):
        monkeypatch.setattr(config, "host_dispatch_threshold_batched", t)
        batch._dispatched_batch(spy, 1, "chol2")(None, q, G, None, A, None)
        batch._dispatched_batch(spy, 0, None)(q, G, None, A=A)
        assert seen[-2:] == [want, want]
    monkeypatch.setattr(config, "host_dispatch_threshold_batched", 13)
    batch._dispatched_batch(spy, 0, None)(q, G, None)
    assert seen[-1] == "cpu"


@pytest.mark.parametrize("name", sorted(_front_end_calls()))
def test_front_end_stays_at_the_threshold(fake_card, monkeypatch, name):
    """Every size here is at least 2: with the threshold 2 each call stays
    on the card, which is not there."""
    monkeypatch.setattr(config, "host_dispatch_threshold", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _front_end_calls()[name]()


def test_routed_solve_equals_plain_and_jax(fake_card):
    from kvxopt_tpu import solvers as jsolvers
    c, G, h = userguide_lp()
    with coneprog._dispatch_ctx(coneprog._veclen(c)) as dev:
        assert dev == torch.device("cpu")
    routed = tsolvers.lp(c, G, h)
    with config.using_device("cpu"):
        plain = tsolvers.lp(c, G, h)
    ref = jsolvers.lp(c, G, h)
    assert routed["status"] == plain["status"] == ref["status"] == "optimal"
    assert routed["iterations"] == plain["iterations"]
    for k in ("x", "s", "z"):
        assert torch.equal(routed[k], plain[k]), k
        np.testing.assert_allclose(routed[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-9)


def test_tensors_keep_their_device(fake_card, monkeypatch):
    """Only array-like inputs are routed: with CPU tensors the solve runs
    on the CPU whatever the threshold."""
    monkeypatch.setattr(config, "host_dispatch_threshold", 2)
    c, G, h = (torch.as_tensor(a) for a in userguide_lp())
    assert tsolvers.lp(c, G, h)["x"].device.type == "cpu"


# ---------------------------------------------------------------------------
# The batch drivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,routed", (
    ("chol2_mixed", False), ("chol2_mixed_nofb", False), ("chol2", True),
    (None, True)))
def test_dispatched_batch_never_routes_mixed(fake_card, strategy, routed):
    seen = []

    def spy(*args):
        seen.append(config.default_device.type)

    G = np.zeros((2, 32, 16))
    batch._dispatched_batch(spy, 1, strategy)(None, np.zeros((2, 16)), G)
    assert seen == ["cpu" if routed else "cuda"]
    batch._dispatched_batch(spy, 1, strategy)(None, np.zeros((2, 16)),
                                              np.zeros((2, 48, 16)))
    assert seen[1] == "cuda"


def test_batched_lp_routes_below_the_threshold(fake_card):
    rng = np.random.default_rng(4)
    Bn, n, m = 3, 6, 12
    G = rng.standard_normal((Bn, m, n))
    h = np.einsum("bmn,bn->bm", G, rng.standard_normal((Bn, n))) + 1.0
    c = -np.einsum("bmn,bm->bn", G, rng.uniform(0.5, 1.5, (Bn, m)))
    out = batch.batched_lp_solver(ConeDims(l=m))(c, G, h)
    with config.using_device("cpu"):
        ref = batch.make_lp_solver(ConeDims(l=m))(c, G, h)
    assert out[0].device.type == "cpu"
    for a, b in zip(out[:8], ref[:8]):
        assert torch.equal(a, b)


def test_batched_mixed_is_not_routed(fake_card):
    rng = np.random.default_rng(5)
    Bn, n, m = 2, 4, 8
    P = np.stack([np.eye(n)] * Bn)
    q = rng.standard_normal((Bn, n))
    G = rng.standard_normal((Bn, m, n))
    h = np.ones((Bn, m))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.batched_qp_solver(ConeDims(l=m), "chol2_mixed_nofb")(P, q, G, h)
    x = batch.batched_qp_solver(ConeDims(l=m), "chol2")(P, q, G, h)[0]
    assert x.device.type == "cpu"


# ---------------------------------------------------------------------------
# The environment variables, ops/ipm_chol.py and config.using_device
# ---------------------------------------------------------------------------

def test_environment_variable():
    """KVXOPT_TPU_HOST_DISPATCH=0 turns dispatch off (the batched one
    too); 64 sets the threshold.  One fresh process reads each value at
    the import of config."""
    code = """
import importlib, os
from kvxopt_tpu_torch import config as c
for value in ("0", "64"):
    os.environ["KVXOPT_TPU_HOST_DISPATCH"] = value
    c = importlib.reload(c)
    c._card_missing = lambda: False
    print(c.host_dispatch_threshold, c.dispatch_device(1),
          c.dispatch_device_batched(1))
"""
    env = dict(os.environ, KVXOPT_TPU_HOST_DISPATCH_BATCHED="64",
               PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["0 None None", "64 cpu cpu"]


@pytest.mark.parametrize("n", (1, 8, 31, 256))
def test_kernels_at_every_n(monkeypatch, n):
    """No size threshold in ops/ipm_chol.py: an f32 batch reaches
    chol_ls's wrappers (the kernels on the card, their plain versions
    here) at every n, an f64 one never."""
    seen = []
    for name in ("batched_cholesky_ls", "chol_solve_ls", "tri_solve_ls"):
        def spy(*args, _f=getattr(chol_ls, name), _name=name, **kwargs):
            seen.append(_name)
            return _f(*args, **kwargs)
        monkeypatch.setattr(chol_ls, name, spy)
    g = torch.Generator().manual_seed(n)
    A = torch.randn((2, n, n), generator=g, dtype=torch.float64)
    K = A @ A.mT + n * torch.eye(n, dtype=torch.float64)
    rhs = torch.randn((2, n, 3), generator=g, dtype=torch.float64)
    for dt in (torch.float64, torch.float32):
        L, Dinv = ipm_chol.chol_factor(K.to(dt))
        assert (Dinv is None) == (dt == torch.float64)
        x = ipm_chol.chol_solve(L, Dinv, rhs.to(dt))
        ipm_chol.tri_lower_solve(L, Dinv, rhs.to(dt))
        assert torch.allclose(K.to(dt) @ x, rhs.to(dt), rtol=0,
                              atol=1e-4 if dt == torch.float32 else 1e-10)
        assert seen == ([] if dt == torch.float64 else
                        ["batched_cholesky_ls", "chol_solve_ls",
                         "tri_solve_ls"])


def test_using_device_is_thread_local():
    """A using_device block changes the default device of its own thread
    only, nests, and restores it on exit; other threads keep the
    process-wide device."""
    import threading
    process = config.default_device
    seen = {}
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait(10)
        seen["other"] = config.default_device
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with config.using_device("meta"):
        inside.set()
        done.wait(10)
        with config.using_device("cpu"):
            seen["nested"] = config.default_device
        seen["outer"] = config.default_device
    t.join(10)
    assert seen == {"other": process, "nested": torch.device("cpu"),
                    "outer": torch.device("meta")}
    assert config.default_device == process


def test_dispatched_batch_keeps_tensors(fake_card):
    """Below the threshold a routed call gets the very tensors it was
    given: only array-like inputs are placed on the CPU."""
    seen = []

    def spy(*args):
        seen.append((config.default_device.type, args))

    t = torch.zeros((2, 16))
    args = (np.zeros((2, 16)), t, torch.zeros((2, 8, 16)))
    batch._dispatched_batch(spy, 1, "chol2")(*args)
    assert seen[0][0] == "cpu"
    assert all(a is b for a, b in zip(seen[0][1], args))


def test_mixed_pass2_gets_the_failed_lanes(fake_card, monkeypatch):
    """batched_qp_solver_mixed's pass 2 gets the failed lanes of the
    inputs as given (numpy stays numpy, so _dispatched_batch can route
    it); its results are merged back on pass 1's device."""
    from kvxopt_tpu_torch.solvers.coneprog import OPTIMAL
    got = {}

    def fake(dims, kktsolver=None, options=None, mesh=None, with_eq=False):
        def solve(P, q, G, h):
            if kktsolver == "chol2":
                got["args"] = (P, q, G, h)
                x = torch.ones((len(q), q.shape[-1]), dtype=torch.float64)
                st = torch.full((len(q),), OPTIMAL)
            else:
                x = torch.zeros((len(q), q.shape[-1]), dtype=torch.float64)
                st = torch.tensor([OPTIMAL, OPTIMAL + 1, OPTIMAL])
            return (x, x, x, x, st, st, ())
        return solve

    monkeypatch.setattr(batch, "batched_qp_solver", fake)
    q = np.arange(6.0).reshape(3, 2)
    out = batch.batched_qp_solver_mixed(ConeDims(l=2))(q, q, q, q)
    assert all(isinstance(a, np.ndarray) for a in got["args"])
    np.testing.assert_array_equal(got["args"][1], q[[1]])
    assert out[0].tolist() == [[0.0, 0.0], [1.0, 1.0], [0.0, 0.0]]
