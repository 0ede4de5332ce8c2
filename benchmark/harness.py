"""The benchmark of kvxopt_tpu_torch: one cell, one process, one line.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
and a traffic mix, and everything else is found by name:

  configs/<config>.json    the configuration's sizes, its source, the
                           tolerances it states, and the names of its
                           generator (problems/<problem>.py) and plain
                           reference (reference/<reference>.py)
  traffic/<traffic>.json   the entry (entries/<entry>.py), the batch,
                           where the inputs are made, the calls warmed,
                           checked and traced
  metrics/<name>.py        a metric, end to end or per layer:
                           read(run) -> a number, or None where it finds
                           nothing to read; a name with a suffix after
                           its first '.' (solves_per_s.single) is read by
                           metrics/<name>.py where that file exists, and
                           else by the file of the name before the '.'
  limits/<cell>.json       optional: limits where a cell's readings call
                           for others than the configuration states

The run is a closed loop with one caller: call i + 1 starts when call i
has returned and its status and x are on the host.  Each call's
instances are made from (seed, call index) before its clock starts, and
the window is the sum of the calls' times: it ends with the first call
that takes it past --seconds.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kvxopt_tpu")

# random streams drawn from --seed
WINDOW, WARM, SAMPLE, TRACE = 0, 1, 2, 3


class NoCard(RuntimeError):
    pass


class OffCard(RuntimeError):
    """The program answered a call from another device than the run's:
    the run measured something else than the cell names."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """The Python file at `path` as a module (names may hold '.' or '-')."""
    name = "benchmark_" + "_".join(Path(path).relative_to(BENCH).with_suffix(
        "").parts).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def call_seed(seed, stream, index):
    """A 63-bit seed for one call's instances, from the run's seed, the
    stream and the call's index."""
    ss = np.random.SeedSequence([seed % 2 ** 64, stream, index])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def percentile(values, pct):
    """The pct-th percentile of values, linear between order statistics
    (numpy's default method)."""
    v = sorted(values)
    if not v:
        return math.nan
    r = (len(v) - 1) * pct / 100.0
    lo = math.floor(r)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (r - lo)


class Reservoir:
    """A uniform sample of k items of a stream of unknown length
    (Vitter's algorithm R), drawn from `rng`."""

    def __init__(self, k, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic,
    generator, reference, entry and limits loaded."""

    def __init__(self, name, spec=None):
        spec = spec or load_json(ROOT / "BENCHMARK.json")
        work = {w["name"]: w for w in spec["workloads"]}
        if name not in work:
            raise SystemExit(f"unknown workload {name!r}; known: "
                             f"{', '.join(work)}")
        self.name, self.spec, self.work = name, spec, work[name]
        conf = {c["name"]: c for c in spec["configs"]}[self.work["config"]]
        self.cfg = load_json(ROOT / conf["file"])
        self.traffic = load_json(BENCH / "traffic" /
                                 f"{self.work['traffic']}.json")
        self.problem = load_module(BENCH / "problems" /
                                   f"{self.cfg['problem']}.py")
        self.reference = load_module(BENCH / "reference" /
                                     f"{self.cfg['reference']}.py")
        self.limits = default_limits(self.cfg)
        own = BENCH / "limits" / f"{name}.json"
        if own.exists():
            self.limits.update(load_json(own))
        self.chips = int(self.work["chips"])

    def metrics(self, kind):
        """The cell's end_to_end or per_layer entries of BENCHMARK.json."""
        return [m for m in self.spec[kind]
                if self.name in m.get("workloads", [self.name])]


def default_limits(cfg):
    """The limit of each number the check compares, as the configuration
    states them: no sampled instance short of optimal, and the residual
    within the stated feasibility tolerance."""
    return {"not_optimal": 0, "residual": cfg["tolerances"]["feastol"]}


def metric_reader(name):
    """The module that reads metric `name` (see the module's docstring)."""
    own = BENCH / "metrics" / f"{name}.py"
    return load_module(own if own.exists() else
                       BENCH / "metrics" / f"{name.split('.')[0]}.py")


def require_on(device, res):
    """Raise OffCard unless the call's answer `res` lies on `device`."""
    where = res["x"].device
    if where.type != device.type:
        raise OffCard(f"the program answered on {where}, the run is on "
                      f"{device}")


def make_inputs(cell, seed, stream, index, device):
    """One call's instances: a dict of tensors on the card with the batch
    first ("device" traffic), or of one instance's numpy arrays
    ("numpy" traffic, made on the host)."""
    import torch
    t = cell.traffic
    dtype = getattr(torch, cell.cfg["dtype"])
    where = device if t["inputs"] == "device" else torch.device("cpu")
    gen = torch.Generator(device=where)
    gen.manual_seed(call_seed(seed, stream, index))
    data = cell.problem.make(cell.cfg, gen, t["batch"], where, dtype)
    if t["inputs"] == "numpy":
        return {k: v[0].numpy() for k, v in data.items()}
    return data


def as_batch(data, device):
    """make_inputs' data as tensors on `device` with the batch first."""
    import torch
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.as_tensor(v)[None]).to(device)
            for k, v in data.items()}


def require_cards(chips):
    """Raise NoCard unless torch sees `chips` CUDA devices."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA devices, "
                     f"{torch.cuda.device_count()} present")


def run_window(cell, call, result, seed, seconds, device, sync):
    """The measured window.  Returns (calls, sample): per call its
    seconds, optimal flags and iterations; and the sampled calls
    (index, result) drawn from the seed, their results kept as the
    program left them."""
    sample = Reservoir(cell.traffic["check_calls"],
                       np.random.default_rng([seed % 2 ** 64, SAMPLE]))
    calls, total, i = [], 0.0, 0
    while total < seconds:
        data = make_inputs(cell, seed, WINDOW, i, device)
        sync()
        t0 = time.perf_counter()
        raw = call(data)
        dt = time.perf_counter() - t0
        del data
        res = result(raw)
        require_on(device, res)
        total += dt
        calls.append({"seconds": dt, "optimal": res["optimal"],
                      "iterations": res["iterations"]})
        sample.offer((i, res))
        i += 1
    return calls, sample.items


def check(cell, sample, seed, device):
    """Judge the sampled calls' results against their regenerated inputs
    with the plain reference.  Returns {name: (value, limit)} of the
    numbers compared, whether each is within its limit, and {name: value}
    of the judge's other readings, which decide nothing."""
    lim = cell.limits
    worst = {"not_optimal": 0}
    for i, res in sample:
        data = as_batch(make_inputs(cell, seed, WINDOW, i, device), device)
        j = cell.reference.judge(data, res, cell.cfg["tolerances"])
        worst["not_optimal"] += sum(not o for o in res["optimal"])
        for k, v in j.items():
            worst[k] = max([worst.get(k, 0.0), *v])
    numbers = {k: (worst[k], lim[k]) for k in lim}
    ok = all(v <= limit for v, limit in numbers.values())
    return numbers, ok, {k: v for k, v in worst.items() if k not in lim}


def traced(cell, call, result, seed, device, sync):
    """The per-layer readings of a --trace 1 run: a profiled stretch of
    calls and a stretch under the sync counter, on fresh inputs."""
    from . import tracing
    t = cell.traffic
    n_prof, n_sync = t["trace_calls"], t["sync_calls"]
    inputs = [make_inputs(cell, seed, TRACE, i, device)
              for i in range(n_prof + n_sync)]
    # one call with the inputs in memory, so that the caching allocator
    # has its blocks before the trace opens
    result(call(inputs[0]))
    sync()
    raws = []

    def stretch():
        for d in inputs[:n_prof]:
            raws.append(call(d))
    prof = tracing.profiled(stretch)
    prof_iters = [result(r)["iterations"] for r in raws]
    raws.clear()

    def counted():
        for d in inputs[n_prof:]:
            raws.append(call(d))
    syncs = tracing.count_syncs(counted)
    sync_iters = [result(r)["iterations"] for r in raws]
    return {"profile": prof, "profile_iterations": prof_iters,
            "syncs": syncs, "sync_iterations": sync_iters}


def power_limit():
    """The card's name and power limit as nvidia-smi reports them, or
    None where it cannot be read."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(cell, seed, seconds, trace, t_start, device=None):
    """Run one Cell and return the result line (a dict).  device: the
    torch device to run on (the card; a test may pass the CPU, which
    skips the look for cards)."""
    import torch
    if device is None:
        require_cards(cell.chips)
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    entry = load_module(BENCH / "entries" / f"{cell.traffic['entry']}.py")
    call, result = entry.prepare(cell.cfg["dims"])
    for i in range(cell.traffic["warm_calls"]):
        require_on(device, result(call(make_inputs(cell, seed, WARM, i,
                                                   device))))
    sync()
    setup_s = time.perf_counter() - t_start

    calls, sample = run_window(cell, call, result, seed, seconds, device,
                               sync)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    readings = (traced(cell, call, result, seed, device, sync)
                if trace else None)
    del call, result
    if on_card:
        torch.cuda.empty_cache()
    numbers, ok, other = check(cell, sample, seed, device)
    del sample

    run_data = {"cell": cell, "calls": calls, "readings": readings,
                "setup_s": setup_s}
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = metric_reader(m["name"]).read(run_data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    lanes = sum(len(c["optimal"]) for c in calls)
    solved = sum(sum(c["optimal"]) for c in calls)
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else device.type,
           "count": cell.chips, "memory_peak_bytes": peak}
    line = {"correct": ok, "attempted": lanes, "failed": lanes - solved,
            "metrics": metrics, "device": dev}
    if trace:
        prof = readings["profile"]
        dev["busy_s"] = prof.busy
        dev["window_s"] = prof.wall
        line["breakdown"] = {"device_ops": prof.device_ops,
                             "idle_gaps": prof.idle_gaps}
    if on_card:
        dev["power"] = power_limit()
    dev["calls"] = len(calls)
    dev["host_threads"] = torch.get_num_threads()
    dev["host_cpus"] = os.cpu_count()
    line["readings"] = other
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in numbers.items()}
    return line
