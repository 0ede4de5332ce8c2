"""Spans and counters of the QP path, recorded in memory per call.

Each top-level call of a QP entry opens a root span: `qp`, `coneqp`
(solvers.coneprog) or `batched_qp` (parallel.batch: batched_qp_solver,
make_qp_solver's solve and the mixed and sequential drivers).  A front
end called inside another one's root (qp calls coneqp; batched_qp_solver
calls make_qp_solver's solve) opens no second root.  Inside a root the
solve opens these spans:

    qp | coneqp | batched_qp            the call
      ipm                               solvers.coneprog._coneqp_core
        cone                            scaling, Newton right-hand sides,
                                        ds recovery, step lengths
        kkt.factor                      factor(W)
          kkt.fallback                  chol2's lanes on the augmented
                                        LDL' (kkt._on_ldl): their factor
        kkt.solve                       each solve(bx, by, bz)
          kkt.fallback                  and each of their solves
        sync                            each host wait on the device

and counts, per call, `ipm.steps` (interior-point steps taken),
`kkt.fallback_lanes` (the lanes chol2 handed to the augmented LDL',
summed over the call's factorizations; 0 where chol2 could and did
not), `h2d_bytes` (bytes the front ends copy from host memory to a CUDA
device) and, in parallel.batch's QP solve, `operand_bytes` (the bytes
of the distinct storages its P, q, G, h, A and b occupy, a storage that
lanes share counted once).  On exit from the root one `Call` record
goes to a process-wide deque of the last MAX_CALLS calls: `calls()`
returns them, `clear()` empties it.  A span outside any root records nothing.

The recorder is on by default, and `enable(False)` turns it off.  Its
clock is time.perf_counter_ns(): it creates no CUDA event and waits for
nothing.  The span stack is the calling thread's own.

Under `annotate()` each span also enters torch.profiler.record_function
with its name, so that a profiler trace shows the spans beside the
kernels they launched.  options['profile'] = <directory> (coneqp,
conelp) does so for one solve and writes its Chrome trace there
(_profile_ctx).  Without either, record_function is never entered.

IMPORT_NS holds the (start, end) of the package's import, from the top
of kvxopt_tpu_torch/__init__.py to its end.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import NamedTuple

MAX_CALLS = 8192
IMPORT_NS = None

_now = time.perf_counter_ns


class Call(NamedTuple):
    """One root span's record.  spans maps each span name, the root's
    included, to (count, total ns, self ns), self being total less the
    spans opened directly inside it; the self times sum to end_ns -
    start_ns.  counters maps each counter's name to its total."""

    seq: int
    name: str
    start_ns: int
    end_ns: int
    spans: dict
    counters: dict


class _State(threading.local):
    def __init__(self):
        # open spans, innermost last: [name, start ns, ns of the spans
        # opened directly inside, record_function or None]
        self.stack = []
        self.spans = None     # name -> [count, total ns, self ns]
        self.counters = None  # name -> total
        self.annotating = False


_tls = _State()
_calls = collections.deque(maxlen=MAX_CALLS)
_seq = itertools.count()
_on = True


def enable(on=True):
    """Turn the recorder on or off for the whole process; a root already
    open is recorded."""
    global _on
    _on = bool(on)


def calls():
    """The records of the last MAX_CALLS calls, oldest first."""
    return list(_calls)


def clear():
    """Forget every record."""
    _calls.clear()


def _record_function(name):
    import torch
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Span:
    """The context of an inner span: pushes a frame on enter and pops it
    on exit, so one object serves every (nested, threaded) use."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        s = _tls
        s.stack.append([self.name, _now(), 0, _record_function(self.name)
                        if s.annotating else None])

    def __exit__(self, *exc):
        t1 = _now()
        s = _tls
        name, t0, inner, rf = s.stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        dt = t1 - t0
        s.stack[-1][2] += dt
        a = s.spans.get(name)
        if a is None:
            s.spans[name] = [1, dt, dt - inner]
        else:
            a[0] += 1
            a[1] += dt
            a[2] += dt - inner


class _Root:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        s = _tls
        rf = _record_function(self.name) if s.annotating else None
        s.spans, s.counters = {}, {}
        s.stack.append([self.name, _now(), 0, rf])

    def __exit__(self, *exc):
        t1 = _now()
        s = _tls
        name, t0, inner, rf = s.stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        spans = {k: tuple(v) for k, v in s.spans.items()}
        spans[name] = (1, t1 - t0, t1 - t0 - inner)
        _calls.append(Call(next(_seq), name, t0, t1, spans, s.counters))
        s.spans = s.counters = None


_NULL = contextlib.nullcontext()
_SPANS = {}


def root(name):
    """The context of a call's root span named `name`; a no-op inside
    another root or with the recorder off."""
    if not _on or _tls.stack:
        return _NULL
    return _Root(name)


def span(name):
    """The context of a span named `name` inside the open root; a no-op
    where no root is open."""
    if not _tls.stack:
        return _NULL
    sp = _SPANS.get(name)
    if sp is None:
        sp = _SPANS.setdefault(name, _Span(name))
    return sp


def count(name, n=1):
    """Add n to the open root's counter `name` (nothing without one)."""
    c = _tls.counters
    if c is not None:
        c[name] = c.get(name, 0) + n


def _on_card(device):
    return device.type == "cuda"


def count_h2d(t):
    """Count tensor t, just made from host memory, in the open root's
    h2d_bytes where it lies on a CUDA device."""
    if _tls.counters is not None and _on_card(t.device):
        count("h2d_bytes", t.numel() * t.element_size())


def count_operands(*tensors):
    """Count the bytes of the distinct storages that `tensors` (None
    skipped) occupy in the open root's operand_bytes, each storage once
    however many tensors view it.  It reads the tensors' metadata alone,
    so it waits for nothing."""
    if _tls.counters is None:
        return
    seen = {}
    for t in tensors:
        if t is not None:
            st = t.untyped_storage()
            seen[(t.device, st.data_ptr())] = st.nbytes()
    count("operand_bytes", sum(seen.values()))


@contextlib.contextmanager
def annotate():
    """Within it, the calling thread's spans, those already open
    included, also enter torch.profiler.record_function under their
    names, so that a profiler running around them shows them."""
    s = _tls
    if s.annotating:
        yield
        return
    opened = [f for f in s.stack if f[3] is None]
    for f in opened:
        f[3] = _record_function(f[0])
    s.annotating = True
    try:
        yield
    finally:
        s.annotating = False
        for f in reversed(opened):
            f[3].__exit__(None, None, None)
            f[3] = None


def _profile_ctx(options, device):
    """Opt-in torch.profiler capture of a whole solve: with
    options['profile'] = <directory> (per call or in solvers.options),
    the solve runs under torch.profiler, tracing the host's operators,
    the spans (annotate()) and, where `device` is the card, its kernels,
    and on exit writes one Chrome trace under that directory,
    kvxopt_<pid>_<unique>.trace.json, so that calls do not overwrite each
    other.  Without the key no profiler is created."""
    import torch

    from .solvers.coneprog import _merged_options
    pdir = _merged_options(options).get("profile")
    if not pdir:
        return _NULL
    return _profiled(str(pdir), torch.device(device))


@contextlib.contextmanager
def _profiled(pdir, device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    os.makedirs(pdir, exist_ok=True)
    with profile(activities=acts) as prof:
        with annotate():
            yield
    fd, path = tempfile.mkstemp(prefix=f"kvxopt_{os.getpid()}_",
                                suffix=".trace.json", dir=pdir)
    os.close(fd)
    prof.export_chrome_trace(path)
