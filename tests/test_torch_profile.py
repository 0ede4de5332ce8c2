"""options['profile'] in the port's coneqp (through qp) and conelp: with
a directory, per call or in solvers.options, the solve runs under
torch.profiler and writes one Chrome trace there; without the key no
profiler is created and nothing is written."""

import json

import numpy as np
import pytest
import torch

from kvxopt_tpu_torch import config, solvers


@pytest.fixture(autouse=True)
def _cpu():
    with config.using_device("cpu"):
        yield
    solvers.options.pop("profile", None)


def qp_args(seed=0, n=8, m=16):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    G = rng.standard_normal((m, n))
    h = G @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
    return M @ M.T + np.eye(n), rng.standard_normal(n), G, h


def lp_args(seed=1, n=8, m=16):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((m, n))
    h = G @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
    return -G.T @ rng.uniform(0.5, 1.5, m), G, h


def solve(kind, options=None):
    if kind == "qp":
        return solvers.qp(*qp_args(), options=options)
    c, G, h = lp_args()
    return solvers.conelp(c, G, h, {"l": 16, "q": [], "s": []},
                          options=options)


def one_trace(path):
    files = sorted(path.iterdir())
    assert len(files) == 1, files
    trace = json.loads(files[0].read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    assert any(e.get("ph") == "X" for e in events)
    return files[0]


@pytest.mark.parametrize("kind", ["qp", "conelp"])
@pytest.mark.parametrize("where", ["call", "global"])
def test_profile_writes_one_trace(tmp_path, kind, where):
    if where == "call":
        sol = solve(kind, {"profile": str(tmp_path)})
    else:
        solvers.options["profile"] = tmp_path
        sol = solve(kind)
    assert sol["status"] == "optimal"
    first = one_trace(tmp_path)
    # a second call writes a second file beside the first
    solve(kind, {"profile": str(tmp_path)})
    files = sorted(tmp_path.iterdir())
    assert len(files) == 2 and first in files


@pytest.mark.parametrize("kind", ["qp", "conelp"])
def test_no_profile_key_no_profiler(tmp_path, kind, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("torch.profiler.profile called")
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    assert solve(kind)["status"] == "optimal"
    assert solve(kind, {"maxiters": 50})["status"] == "optimal"
    assert not list(tmp_path.iterdir())
    # the key, with the patched profiler, reaches it
    with pytest.raises(AssertionError, match="profiler.profile called"):
        solve(kind, {"profile": str(tmp_path)})
