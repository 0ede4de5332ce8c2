"""Time kernel K2 (chol_solve_ls) of one or more checkouts of
kvxopt_tpu_torch on one card, as chip_smoke.py phase 1 times it
(chip_smoke.k2_times): K2, its plain version and torch.cholesky_solve,
host-timed and by device time, at (B, n, k) = (16,512,1), (16,512,32),
(16,32,1), (16,32,32), (16,1024,1).

    python3 tools/k2_compare.py ROOT [ROOT ...]

Each ROOT is a directory holding a kvxopt_tpu_torch/ package (the repo
root, or an older commit unpacked with `git archive`).  The roots run one
after another, each in its own process, in the order given, so two trees
compare within one run on one card (parent, change, change, parent).
Each prints its timing lines and one JSON line {"root", "gpu", "rows"}.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def one(root):
    # the package from ROOT; chip_smoke.py from this checkout, by path
    # (ROOT may hold an older chip_smoke.py)
    sys.path.insert(0, str(Path(root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    # K2's kernel before its redesign was sweep_kernel
    chip_smoke.K2_KEYS = ("sweep_kernel", "chol_solve_kernel")
    import torch
    from kvxopt_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        chip_smoke.fail("CUDA is not available")
    _build.load_library()
    gpu = chip_smoke.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"])
    print(f"root {root}: kernels built in {_build.BUILD_INFO['seconds']:.2f}"
          f" s; {gpu}", flush=True)
    rows = chip_smoke.k2_times(torch.device("cuda:0"))
    print(json.dumps({"root": str(root), "gpu": gpu, "rows": {
        ",".join(map(str, key)): v for key, v in rows.items()}}), flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        one(argv[1])
        return
    if not argv:
        sys.exit(__doc__)
    for root in argv:
        rc = subprocess.run([sys.executable, __file__, "--one", root]).returncode
        if rc != 0:
            sys.exit(f"k2_compare: {root} failed with exit code {rc}")


if __name__ == "__main__":
    main(sys.argv[1:])
