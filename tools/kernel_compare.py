"""Time a kernel of one or more checkouts of kvxopt_tpu_torch on one card,
as chip_smoke.py times it:

  K1  K1 (batched_cholesky_ls), K4 (batched_cholesky), the plain version
      and torch.linalg.cholesky_ex, host-timed and by device time split by
      kernel, at (B, n) = (16,512), (16,32), (3,200), (16,128) and the
      scaling rows (16,1024), (8,2048), (2,4096) (chip_smoke.k1_times);
  K2  K2 (chol_solve_ls), its plain version and torch.cholesky_solve at
      (B, n, k) = (16,512,1), (16,512,32), (16,32,1), (16,32,32),
      (16,1024,1) (chip_smoke.k2_times).

    python3 tools/kernel_compare.py K1|K2 ROOT [ROOT ...]

Each ROOT is a directory holding a kvxopt_tpu_torch/ package (the repo
root, or an older commit unpacked with `git archive`).  The roots run one
after another, each in its own process, in the order given, so two trees
compare within one run on one card (parent, change, change, parent).
Each prints its timing lines and one JSON line {"kernel", "root", "gpu",
"rows"}.  The profiler keys name the kernels of the older trees too.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def one(kernel, root):
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
    dev = torch.device("cuda:0")
    if kernel == "K1":
        rows = chip_smoke.k1_times(
            dev, chip_smoke.K1_TIMES + chip_smoke.K1_SCALING)
    else:
        rows = chip_smoke.k2_times(dev)
    print(json.dumps({"kernel": kernel, "root": str(root), "gpu": gpu,
                      "rows": {",".join(map(str, key)): v
                               for key, v in rows.items()}}), flush=True)


def main(argv):
    if len(argv) == 3 and argv[0] == "--one":
        one(argv[1], argv[2])
        return
    if len(argv) < 2 or argv[0] not in ("K1", "K2"):
        sys.exit(__doc__)
    for root in argv[1:]:
        rc = subprocess.run([sys.executable, __file__, "--one", argv[0],
                             root]).returncode
        if rc != 0:
            sys.exit(f"kernel_compare: {root} failed with exit code {rc}")


if __name__ == "__main__":
    main(sys.argv[1:])
