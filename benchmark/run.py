"""Run one cell of the benchmark of kvxopt_tpu_torch and print its line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

from the root of a checkout that holds BENCHMARK.json and the package.
The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device; with --trace 1 also breakdown; then the
judge's readings that decide nothing, and checks last), and the last
lines of standard error give each number the check compared beside its
limit.  Without as many CUDA devices as the cell asks for, with an answer
of the program on another device than the card, or with JAX or the JAX
package loaded once the window has closed, the run exits with a code
other than 0 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def environment():
    """The program's and the math libraries' defaults whatever the
    caller's environment holds (a caller who sets nothing gets torch's
    host threads), and every cache inside the checkout at a fixed path."""
    for k in [k for k in os.environ if k.startswith("KVXOPT_TPU_")]:
        del os.environ[k]
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.pop(k, None)
    cache = ROOT / ".cache" / "benchmark"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    from benchmark import harness
    try:
        line = harness.run(harness.Cell(args.workload), args.seed,
                           args.seconds, bool(args.trace), T_START)
    except harness.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    except harness.OffCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in line["readings"].items():
        print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
