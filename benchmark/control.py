"""The control of a cell's check: the plain reference, computed in float32
(the precision below the configuration's float64), put in the program's
place on the inputs of the cell's own calls, and judged as a run judges
the program.  It has to come out not correct.

    python benchmark/control.py --workload <cell> --seed <n> [--seed ...]

prints, per seed, each number the check compares beside its limit, and
whether the control passed.  Benchmark runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(cell, seed, device, dtype=None):
    """The check's numbers {name: value} of the reference in `dtype`
    (float32 by default) on the inputs of the first check_calls calls of
    a run with `seed`, judged as harness.check judges the program."""
    import torch
    from benchmark import harness
    dtype = dtype or torch.float32
    sample = []
    for i in range(cell.traffic["check_calls"]):
        data = harness.as_batch(harness.make_inputs(
            cell, seed, harness.WINDOW, i, device), device)
        out = cell.reference.solve(**data, tol=cell.cfg["tolerances"],
                                   dtype=dtype)
        out["optimal"] = [s == "optimal" for s in out["status"]]
        sample.append((i, out))
    numbers, ok, _ = harness.check(cell, sample, seed, device)
    return {k: v for k, (v, _) in numbers.items()}, ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    cell = harness.Cell(args.workload)
    harness.require_cards(cell.chips)
    device = torch.device("cuda", 0)
    for seed in args.seed:
        t0 = time.perf_counter()
        numbers, ok = control(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "numbers": numbers, "limits": cell.limits,
                          "passed": ok,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
