"""On-card gate for kvxopt_tpu_torch: builds the CUDA kernels, checks them
against their plain PyTorch versions, and drives the port's main path,
the two-pass batched mixed-precision cone-QP solve, on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  0. environment and kernel build;
  1. kernels K1/K2/K3 against their plain versions at the solve's shapes
     (B=16 n=512) and a padded shape (B=3 n=200), with times, plus the
     factor + 2 solves headline shape B=16 n=1024;
  2. batched_qp_solver_mixed on 16 random QPs (n=512, m=1024, f64 state,
     abstol/feastol 1e-7): every lane optimal, KKT residuals < 1e-6,
     every kernel launched during the solve;
  3. the same 16 problems on CPU tensors (the plain versions, same
     options): same status, iterations within 1, x within 1e-6.
The last line is {"ok": true, "device": {...}}; the line before it is
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`.
"""

import importlib.util
import json
import subprocess
import sys
import time

import numpy as np
import torch

B, N, M = 16, 512, 1024
SEEDS = range(16)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def sh(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    return out.stdout.strip()


def median_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def spd_batch(Bn, n, seed, device):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((Bn, 2 * n, n)).astype(np.float32)
    K = np.einsum("bij,bik->bjk", G, G) + n * np.eye(n, dtype=np.float32)
    return torch.as_tensor(K, device=device)


def large_problem(seed, n=N, m=M):
    """The numpy generator of bench._large_problem."""
    rng = np.random.default_rng(seed)
    Mx = rng.standard_normal((n, n))
    P = Mx @ Mx.T + n * np.eye(n)
    q = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    h = G @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
    return P, q, G, h


def phase0():
    import kvxopt_tpu_torch  # noqa: F401  (TF32 off)
    from kvxopt_tpu_torch.ops import _build
    print(json.dumps({
        "env": {"torch": torch.__version__, "cuda": torch.version.cuda,
                "nvcc": sh([_build._nvcc(), "--version"]).splitlines()[-1],
                "triton": importlib.util.find_spec("triton") is not None,
                "gpu": sh(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"])}}), flush=True)
    _build.load_library()
    regs = [ln.strip() for ln in _build.BUILD_INFO["log"].splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    print(f"setup: kernels built in {_build.BUILD_INFO['seconds']:.2f} s "
          f"({_build.BUILD_INFO['path']})", flush=True)
    for ln in regs:
        print("  ptxas:", ln)


def phase1(dev):
    from kvxopt_tpu_torch.ops import chol_ls as cl
    rows = {}
    for Bn, n in ((B, N), (3, 200)):
        K = spd_batch(Bn, n, 1, dev)
        L, Dinv = cl.batched_cholesky_ls(K)
        Lr, _ = cl.batched_cholesky_ls_ref(K)
        torch.cuda.synchronize()
        errL = float((L - Lr).abs().max())
        relL = errL / float(Lr.abs().max())
        nb = Dinv.shape[0]
        eyeerr = 0.0
        for kb in range(nb):
            lo, hi = kb * 128, min(kb * 128 + 128, n)
            Iblk = Dinv[kb, :, :hi - lo, :hi - lo] @ L[:, lo:hi, lo:hi]
            eyeerr = max(eyeerr, float((Iblk - torch.eye(
                hi - lo, device=dev)).abs().max()))
        print(f"K1 B={Bn} n={n}: max|L-Lref|/max|Lref|={relL:.3e} "
              f"(tol 1e-5), max|Dinv*Lkk-I|={eyeerr:.3e} (tol 1e-4)")
        check(relL < 1e-5 and eyeerr < 1e-4, "K1 disagrees with plain")

        rng = np.random.default_rng(2)
        K64 = K.double()
        errs2 = {}
        for k in (1, 4):
            shape = (Bn, n) if k == 1 else (Bn, n, k)
            b = torch.as_tensor(rng.standard_normal(shape).astype(
                np.float32), device=dev)
            x = cl.chol_solve_ls(L, Dinv, b)
            xr = cl.chol_solve_ls_ref(L, Dinv, b)
            torch.cuda.synchronize()
            x3 = x if k > 1 else x[..., None]
            r = K64 @ x3.double() - (b if k > 1 else b[..., None]).double()
            rel = float(torch.linalg.norm(r) / torch.linalg.norm(b.double()))
            errs2[k] = float((x - xr).abs().max())
            print(f"K2 B={Bn} n={n} k={k}: residual {rel:.3e} (tol 1e-5), "
                  f"max|x-xref|={errs2[k]:.3e}")
            check(rel < 1e-5, "K2 residual too large")

        errs3 = {}
        for trans in (False, True):
            b = torch.as_tensor(rng.standard_normal((Bn, n, n)).astype(
                np.float32), device=dev)
            x = cl.tri_solve_ls(L, Dinv, b, trans=trans)
            xr = cl.tri_solve_ls_ref(L, Dinv, b, trans=trans)
            torch.cuda.synchronize()
            err = float((x - xr).abs().max())
            rel = err / (float(xr.abs().max()) + 1.0)
            errs3[trans] = err
            print(f"K3 B={Bn} n={n} k={n} trans={trans}: "
                  f"max|x-xref|/(max|xref|+1)={rel:.3e} (tol 1e-4)")
            check(rel < 1e-4, "K3 disagrees with plain")

        if (Bn, n) == (B, N):
            b1 = torch.randn((B, N), device=dev)
            bw = torch.randn((B, N, N), device=dev)
            t = {
                "K1": (median_ms(lambda: cl.batched_cholesky_ls(K)),
                       median_ms(lambda: cl.batched_cholesky_ls_ref(K))),
                "K2": (median_ms(lambda: cl.chol_solve_ls(L, Dinv, b1)),
                       median_ms(lambda: cl.chol_solve_ls_ref(L, Dinv, b1))),
                "K3": (median_ms(lambda: cl.tri_solve_ls(L, Dinv, bw)),
                       median_ms(lambda: cl.tri_solve_ls_ref(L, Dinv, bw))),
            }
            rows["K1"] = dict(err=errL, ms=t["K1"][0], plain=t["K1"][1])
            rows["K2"] = dict(err=errs2[1], ms=t["K2"][0], plain=t["K2"][1])
            rows["K3"] = dict(err=errs3[False], ms=t["K3"][0],
                              plain=t["K3"][1])
            for k, (a, p) in t.items():
                print(f"time {k} B={B} n={N}: kernel {a:.4f} ms, "
                      f"plain {p:.4f} ms (median of 20)")

    Kh = spd_batch(B, 1024, 3, dev)
    bh = torch.randn((B, 1024), device=dev)

    def fs_kernel():
        Lh, Dh = cl.batched_cholesky_ls(Kh)
        cl.chol_solve_ls(Lh, Dh, bh)
        cl.chol_solve_ls(Lh, Dh, bh)

    def fs_plain():
        Lh, Dh = cl.batched_cholesky_ls_ref(Kh)
        cl.chol_solve_ls_ref(Lh, Dh, bh)
        cl.chol_solve_ls_ref(Lh, Dh, bh)

    a, p = median_ms(fs_kernel), median_ms(fs_plain)
    print(f"time factor+2 solves B={B} n=1024: kernel {a:.4f} ms, "
          f"plain {p:.4f} ms (median of 20)")
    return rows


def residuals(P, q, G, h, x, s, z):
    rd = np.einsum("bij,bj->bi", P, x) + q + np.einsum("bji,bj->bi", G, z)
    rp = np.einsum("bij,bj->bi", G, x) + s - h
    return (np.linalg.norm(rd, axis=1) / (1 + np.linalg.norm(q, axis=1)),
            np.linalg.norm(rp, axis=1) / (1 + np.linalg.norm(h, axis=1)))


def phase2(dev, data):
    from kvxopt_tpu_torch import ConeDims
    from kvxopt_tpu_torch.convert import problem_to_torch, state_to_numpy
    from kvxopt_tpu_torch.ops import chol_ls as cl
    from kvxopt_tpu_torch.parallel import batched_qp_solver_mixed
    solve = batched_qp_solver_mixed(ConeDims(l=M))
    args = problem_to_torch(*data, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    cl.reset_launches()
    out = solve(*args)
    torch.cuda.synchronize()
    launches = dict(cl.LAUNCHES)
    pass2 = solve.stats["pass2_lanes"]
    x, y, s, z, it, status, m = state_to_numpy(out)
    print(f"slice B={B} n={N} m={M}: status {status.tolist()}, "
          f"iterations {it.tolist()}, lanes re-solved in pass 2: {pass2}")
    print(f"slice launches during the solve: {launches}")
    check((status == 1).all(), "not every lane optimal")
    rd, rp = residuals(*data, x, s, z)
    print(f"slice max stationarity residual {rd.max():.3e}, "
          f"max primal residual {rp.max():.3e} (tol 1e-6)")
    check(rd.max() < 1e-6 and rp.max() < 1e-6, "KKT residuals too large")
    check(all(v > 0 for v in launches.values()), "a kernel never launched")
    ts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(*args)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    print(f"slice wall time: median {np.median(ts):.4f} s over 3 warm "
          f"batch solves {['%.4f' % t for t in ts]}, mean iterations "
          f"{it.mean():.2f}")
    print(f"slice pass-1 status {solve.stats['pass1_status']}")
    breakdown(args)
    return (x, it, status), launches


def breakdown(args):
    """Each pass alone on all lanes, and the device's share of pass 1."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from kvxopt_tpu_torch import ConeDims
    from kvxopt_tpu_torch.parallel import batched_qp_solver
    from kvxopt_tpu_torch.solvers.coneprog import Options
    fast = batched_qp_solver(ConeDims(l=M), "chol2_mixed_nofb",
                             Options(ozaki=True))
    slow = batched_qp_solver(ConeDims(l=M), "chol2")
    for name, fn in (("pass 1 chol2_mixed_nofb", fast),
                     ("pass 2 chol2 (f64)", slow)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        print(f"breakdown {name} on all {B} lanes: "
              f"{time.perf_counter() - t0:.4f} s, iterations "
              f"{out[4].tolist()}, status {out[5].tolist()}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fast(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    if busy == 0:
        print("profile pass 1: device time not measured (no device events)")
        return
    print(f"profile pass 1 (profiler on): wall {wall:.4f} s, device busy "
          f"{busy:.4f} s ({100 * busy / wall:.1f}%), {len(kern)} kernels")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def phase3(data, gpu):
    from kvxopt_tpu_torch import ConeDims
    from kvxopt_tpu_torch.convert import problem_to_torch, state_to_numpy
    from kvxopt_tpu_torch.parallel import batched_qp_solver_mixed
    # facref explicit: on the card the "vmap" default resolves it on
    solve = batched_qp_solver_mixed(ConeDims(l=M), {"facref": True})
    t0 = time.perf_counter()
    out = state_to_numpy(solve(*problem_to_torch(*data)))
    x, it, status = out[0], out[4], out[5]
    xg, itg, stg = gpu
    dx = np.linalg.norm(xg - x, axis=1) / (1 + np.linalg.norm(x, axis=1))
    print(f"cpu plain path: {time.perf_counter() - t0:.1f} s, status "
          f"{status.tolist()}, iterations {it.tolist()}, max "
          f"|x_gpu-x_cpu|/(1+|x_cpu|) {dx.max():.3e} (tol 1e-6)")
    check((status == stg).all(), "status differs from the CPU plain path")
    check((np.abs(it - itg) <= 1).all(), "iterations differ by more than 1")
    check(dx.max() <= 1e-6, "x differs from the CPU plain path")


def main():
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    dev = torch.device("cuda:0")
    phase0()
    rows = phase1(dev)
    data = tuple(np.stack(a) for a in zip(*(large_problem(s)
                                             for s in SEEDS)))
    gpu, launches = phase2(dev, data)
    phase3(data, gpu)
    replaces = {"K1": "kvxopt_tpu/ops/chol_ls.py:358",
                "K2": "kvxopt_tpu/ops/chol_ls.py:517",
                "K3": "kvxopt_tpu/ops/chol_ls.py:592"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": "kvxopt_tpu_torch/csrc/chol_ls.cu",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": rows[k]["err"], "ms": rows[k]["ms"],
         "plain_ms": rows[k]["plain"]} for k in ("K1", "K2", "K3")]}))
    print(sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
