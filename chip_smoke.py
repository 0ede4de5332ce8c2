"""On-card gate for kvxopt_tpu_torch: builds the CUDA kernels, checks them
against their plain PyTorch versions, and drives the port's main paths
on one GPU: the kernel entry point kvxopt_tpu_torch.ops.batched_cholesky
(K4); the two-pass batched mixed-precision cone-QP solve, on the
orthant, on orthant + second-order cones + equality constraints, and on
orthant + second-order + semidefinite cones; the batched cone-LP solve;
the cone-program front ends (solvers.coneqp/qp/conelp/lp/socp/sdp)
with numpy data and no device named; the nonlinear front ends
(solvers.cp/cpl/gp, cvxprog.oracle_from_function); the sparse layer
(cholmod's tile-supernodal factorization on the card, the tile and dense
routes of a scenario batch, a sparse-KKT LP); and the modeling layer
(op.solve on PWL models, MPS I/O) with the solver= routes (osqp's ADMM
on the card, glpk, dsdp); the sequential batch driver with
chol2_mixed's per-lane f64 fallback, misc on the card and
options['profile']; and custom vector spaces in coneqp/conelp with the
multi-device layer over torch.distributed (sharded_kkt_solver,
dist_cholesky, arrow_kkt_factor, mesh=) in spawned worlds on the card;
the executor dispatch: the crossovers between the card and the CPU
that set its thresholds, and its routes; and the repo's example
programs (kvxopt_tpu_torch.examples and its cvxbook problems).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  0. environment and kernel build;
  1. K1 against its plain version at the solves' shapes (B=16 n=512,
     the Schur complement's B=16 n=32), a padded shape (B=3 n=200) and
     two ragged single-block shapes (B=4 n=100, B=4 n=20), with times;
     K1, K4, the plain version and cholesky_ex host-timed and by device
     time at (16,512), (16,32), (3,200) and (16,128) (one diagonal block,
     the chain's step); the factor + 2 solves headline shape B=16 n=1024;
     K2 against its plain version at (B, n, k) = (16,512,1), (16,512,32),
     (16,32,1), (16,32,32), (3,200,1), (2,130,3), (2,128,37),
     (2,256,300), (2,4096,1), (2,4096,32), with R contiguous, transposed,
     sliced (aligned and not) and, at k=1, 2-D and 3-D, then K2, plain and
     torch.cholesky_solve times and device times at (16,512,1),
     (16,512,32), (16,32,1), (16,32,32), (16,1024,1); K3 against its plain
     version in both modes at (B, n, k) = (16,512,512), (2,128,37),
     (2,200,200), (2,256,300), (16,32,32), with R contiguous, transposed
     and sliced, then K3 and plain times in both modes at (16,512,512),
     (16,1024,1024), (16,32,32) in TFLOP/s = B n^2 k / t, and device
     times from the profiler at (16,512,512);
  2. K4 against its plain version and K1's L at B=16 n=512 and B=3
     n=200, with times; K4 through kvxopt_tpu_torch.ops.batched_cholesky;
     factor-only scaling rows (B, n) = (16,1024), (8,2048), (2,4096) for
     K1, K4 and the plain version, in TFLOP/s = B n^3/3/t;
  2b. K5 (the f64 Cholesky solve) against its plain version at
     (B, n, k) = (32,1010,1), (32,1010,11), (1,1010,1), (1,1010,11) and
     (32,1010,16|64|128), with
     K5, plain and torch.cholesky_solve host times, device times beside
     K5's bound, and K5's launches in one portfolio-b32 call (the
     benchmark's problem), by ops.LAUNCHES;
  2c. K6 (the f64 Cholesky factor) against its plain version at
     (B, n) = (32,1010), (100,1010), (1,1010) and (32,11), by backward
     error and against cholesky_nan's factor (1e-12, its diagonal
     positive), with K6, plain (cholesky_nan) and torch.linalg.cholesky_ex
     host times, device times beside K6's bound, and K6's launches in
     one portfolio-b32 call by ops.LAUNCHES, two a factorization (K and
     the Schur complement);
  2d. K7 (chol2's K = C0 + G' diag(d)^-2 G + reg I on an orthant)
     against its plain version at (B, m, n) = (100,1000,1010) with G and
     C0 shared (portfolio-frontier), (32,1000,1010) batched (portfolio-
     b32) and (1,1000,1010) shared (portfolio-single), entry by entry
     within 2 (m + 4) u (|C0| + |G|' diag(w) |G|), with K7, plain and
     torch.matmul's GEMM of the formed scaled G host times, device times
     beside K7's bound, and K7's launches in one portfolio-b32 call by
     ops.LAUNCHES, one a factorization of K;
  3. batched_qp_solver_mixed on 16 random QPs (n=512, m=1024 orthant,
     f64 state, abstol/feastol 1e-7): every lane optimal, KKT residuals
     < 1e-6, K1-K3 launched during the solve;
  4. the same 16 problems on CPU tensors (the plain versions, same
     options): same status, iterations within 1, x within 1e-6;
  5. batched_qp_solver_mixed(with_eq=True) on 16 random QPs with n=512,
     l=512, q=[64]*8, p=32: every lane optimal, stationarity, Gx+s=h and
     Ax=b residuals < 1e-6, s and z in the cones, K1 launched on the
     Schur complement (n=32) and K2 with k=p, K1-K3 launched;
  6. phase 5's problems on CPU tensors: same status, iterations within
     1, x within 1e-6;
  7. "slice l+q+s": batched_qp_solver_mixed on 16 random QPs with n=512,
     l=256, q=[64]*4, s=[16]*2 (m=1024), no equality rows: every lane
     optimal, stationarity and Gx+s=h residuals < 1e-6, s and z in the
     cones (the s blocks' eigenvalues included), K1-K3 launched; one
     lane with NaN in an s block gives NaN on that lane alone in
     max_step, max_step_eig and compute_scaling, without a raise;
  8. batched_qp_solver with no strategy named (chol) on phase 7's
     problems: every lane optimal, x within 1e-6 of phase 7's;
  9. the ldl and ldl2 strategies at B=4 n=64 l=64 q=(16,16) s=(8,8) on
     the card against the same solves on CPU tensors;
 10. phase 7's problems on CPU tensors: same status, iterations within
     1, x within 1e-6;
 11. "lp batch": batched_lp_solver(ConeDims(l=768)) on 16 LPs with
     n=384, m=768 (grid_scenarios: the shape of bench_configs'
     ACTIVSg2000 scenario batch, a seeded random stand-in for its
     submatrix), numpy data, f64, abstol and feastol 1e-7: every lane
     optimal, G'z + c and Gx + s - h below 1e-6 relative with x, s, z
     over tau, s and z in the cone, the result tensors on the card; 3
     warm wall times and the device's busy share over one solve; the
     same 16 LPs on CPU tensors: same status, iterations within 1, x/tau
     within 1e-6;
 12. "front ends": coneqp and qp on phase 3's lane 0 (x within 1e-6 of
     the batched chol2 solve), conelp on an l+q+s cone LP with n=512,
     l=256, q=[64]*4, s=[16]*2 (lqs_lp; optimal, residuals below 1e-6,
     s and z in the cone, and the same call on CPU tensors: same status,
     iterations within 1, x within 1e-6), the userguide LP, SOCP and
     SDP and the primal- and dual-infeasible LPs (their certificates'
     identities), all with numpy data: each result has the JAX
     function's key set and its tensors on the card; each call's warm
     median of 3 is printed;
 13. "nonlinear": cp on examples/acent.py's analytic centering at
     m=2000, n=1000 (the oracle on the card; optimal, b - Ax > 0,
     |A'(1/(b-Ax))| <= 1e-6 (1+|b|)); cpl on lqs_lp(0)'s l+q+s cone LP
     plus |x|^2 <= r^2 (default chol; optimal, the ball active, znl >
     1e-8, c + Df'znl + G'zl and Gx + sl - h below 1e-6 relative, sl and
     zl in the cone); gp on the userguide box (the documented h, w, d)
     and on a seeded GP with n=256, K=[8]*65; cp on examples/acent2.py;
     cpl with an oracle_from_function oracle of 64 variables, whose f, Df
     and H agree with the hand-coded ones to 1e-10; per call the warm
     median of 3, iterations, host syncs per iteration (torch.cuda's
     sync debug mode), the device's busy share (profiler) and K1-K4's
     launches (0: the f64 path); each call again on the CPU: same
     status, iterations within 1, x within 1e-6 (1+|x|), the primal
     objective within 1e-7 relative;
 14. "sparse", on stiffness_standin (a seeded stand-in for bcsstk13:
     n=2003, 42,943 stored lower nonzeros, a 9-point grid with 3 dof per
     node topped up with random couplings in a band, cfg_bcsstk's
     diagonal dominance): (a) cholmod through its public API with
     options['device'] "auto" (the card): symbolic once (AMD), numeric
     (the factor's tensors on the card; a warm median of 3
     refactorizations), solve: residual below 1e-8, P A P' = L L' to
     1e-10 relative, every sys code 0-8 within 1e-8 relative of the host
     LDL' (options['device'] False), the same for a Hermitian case with
     n=300; NT against T(T+1)/2 and one factor's kernel launches; the
     host LDL' refactorization and scipy splu factor + 2 solves beside
     them; (b) cfg_bcsstk's scenario batch, 16 copies with per-matrix
     jitter: the tile route (one batched TileCholesky factor in f64,
     natural order, then 2 solves; residual below 1e-8) and the dense
     route (ops.best_chol_factor_solve on K padded to 2048 in f32: K1 and
     two K2; residual below 1e-4; the driven run's factor and solves
     against their plain versions on the same inputs, K1 as in phase 1,
     K2 to 1e-5 relative), ms per matrix, K1's and K2's launches;
     (c) conelp on G = [S; I; -I] (n=2003, m=6009) with tile_kktsolver
     (K = G'W^-2 G formed on the card, tiles_from_dense, factor, solve):
     optimal, residuals below 1e-6, x within 1e-6 (1 + |x|) of the same
     LP through the default chol2 on the card and of the same call on
     CPU tensors (status, iterations within 1); warm median of 3, busy
     share and host syncs per iteration;
 15. "modeling": (a) examples/normappr.py's three PWL problems and
     examples/roblp.py's two at m=1000, n=250 (pwl_models, seeded numpy
     data through matrix) through kvxopt_tpu_torch.modeling's op.solve()
     on the card: optimal, z >= 0 and s'z below 1e-6 (1 + |pcost|);
     per model the warm median of 3, _build_lp's host time, iterations,
     host syncs per iteration and the device's busy share; each model on
     the CPU (status, iterations within 1, every variable within
     1e-7 (1 + |value|)) and with solver='glpk' (HiGHS; the objective
     within 1e-6 relative); (b) roblp at m=200, n=50, its data at the
     MPS writer's six digits (mps_exact), through tofile and fromfile,
     solved on the card (the objective within 1e-8 relative), and an
     integer-marker MPS through op.solve() to glpk.ilp (x = (5, 0.5)); (c) solvers.qp(solver='osqp') on osqp_problem (n=1000,
     G 2000 x 1000, a budget row) on the card: status, ADMM iterations,
     warm median of 3, ms per iteration, host syncs per call and the busy
     share of a call cut to OSQP_PROFILED iterations; the same call on
     the CPU (status, iterations within 2, x within 1e-6 relative) and,
     where it ends optimal, the native qp (objective within 1e-4
     relative); lp(solver='osqp') on (a)'s
     max|Ax+b| LP beside the native lp; (d) dsdp.sdp and
     solvers.sdp(solver='dsdp') on the userguide SDP
     (examples/dsdp_dual_scaling.py) against the native sdp on the card:
     objectives within 1e-6 relative, dsdp.sdp at its default gap
     tolerance within that tolerance, 1e-5;
 16. "seq and misc": (a) parallel.batched_qp_solver_seq (chol2_mixed
     with its per-lane f64 fallback, group=1, then group=2) on phase 3's
     16 problems: every lane optimal, residuals below 1e-6, x within
     1e-6 (1 + |x|) of phase 3's, K1-K3 launched at n=512; per lane the
     iterations, K1's factorizations and those that took the fallback
     (each lane alone, kkt.chol_factor's f64 calls counted; fewer than
     K1's); K1-K3 on the inputs the driver gives them at B=1 and B=2
     (captured by path_inputs) against their plain versions at phase
     1's tolerances, K3 in both modes; warm medians of 3
     beside phase 3's two-pass wall and each pass alone (timed on lanes
     0-7 where the first group=1 run takes over SEQ_CUT_S); one lane's
     device profile; (b) coneqp with misc.kkt_chol through the H=P
     wrapper against kktsolver='chol' on lane 0 of phase 7's problems
     (status and iterations equal, x within 1e-7 (1 + |x|)), then misc's
     pack, unpack, sdot, snrm2, compute_scaling, scale (four modes) and
     scale2 on the card against CPU tensors with one W: at the interior
     pair (s + e, z + e) of that solution all to 1e-10, at s and z
     themselves likewise except the MISC_COND outputs, sdot and
     compute_scaling's (1e-6), printed beside their change on the CPU
     under a 1e-15 relative change of s and z and sdot's condition; (c) solvers.qp on phase 3's lane 0 with
     options['profile']: one Chrome trace that parses and holds CUDA
     kernel events; the call without the key writes nothing;
 17. "custom spaces and the multi-device layer": (a) coneqp on phase 7's
     lane 0 and conelp on lqs_lp(0) with x = {'a': x[:256], 'b': x[256:]},
     P and G operators and a kktsolver over misc.kkt_chol, and coneqp on
     phase 5's lane 0 with y = {'u', 'w'} (p split in two) as well: each
     the dense call's status, iterations within 1, x within 1e-6 (1 +
     |x|); (b)-(e) in spawned worlds (parallel.spawn) of 1 rank over
     NCCL and of 2 ranks over gloo, both on cuda:0: (b) coneqp through
     sharded_kkt_solver on phase 7's lane 0, twice (cold and warm), at
     world 2 also with dist_nb=128, against its dense chol solve, as
     (a); (c) dist_cholesky at n=2048, nb=256 against
     torch.linalg.cholesky, 1e-10 relative on L; (d) arrow_kkt_factor
     on B=16 blocks of nb=384 bordered by nc=64, over the mesh and (in
     this process) without one, the arrow system's residual below 1e-10
     relative; (e) batched_qp_solver_mixed(mesh=) on phase 3's problems,
     at world 2 each rank on its 8 lanes: phase 3's status and
     iterations, x within 1e-12 (1 + |x|), K1-K3 launched (world 1's
     counts are launches_phase17); each part's wall;
 19. "examples" (after 17, before the CPU comparisons and 18): the
     port's example programs (kvxopt_tpu_torch.examples: the 21 scripts
     of examples/ other than weak_scaling_sharded through main(), and
     the 24 cvxbook problems of examples.book on <name>_data()), numpy
     data and no device named: (a) with both thresholds 0, each call's
     values as tests/test_examples.py and the JAX book tests assert them
     (check_example), its result tensors on the card (portfolio and
     covsel give numpy: device time seen by the profiler instead;
     smoothrec and inputdesign run lapack, a host facade: no device
     work), the card's warm median of 3, and K1-K4's counts over all of them (0: the examples solve in
     f64); against the CPU, in the worker that runs "examples"
     (examples_cpu, config.using_device("cpu"), its warm median of 3):
     every solve's status, iterations within 1, x within 1e-6 (1 + |x|);
     (b) with config.py's thresholds, the route each call's solves take
     (KKT order and device), then l1regls at L1REGLS_WIDE (operator P
     and G: never routed) and mcsdp at n = MCSDP_WIDE (order 10100) on
     the card, checked against the CPU as in (a), and mcsdp at
     n = MCSDP_SMALL (order 420) on the CPU; thresholds 0 again; (c)
     weak_scaling_sharded's factor+solve step at world 1 over NCCL
     (rows 2048, n 256): its row, and ux within 1e-8 of the dense solve;
 18. "dispatch", after the CPU workers have ended, the host CPU's model
     and torch's thread count printed: (a) solvers.qp and solvers.lp
     with numpy data on large_problem(0, n, 2n) (the LP's c = -G'z0,
     orthant_lp; KKT order 3n) at n in DISPATCH_N, and the userguide
     LP, SOCP and SDP, each on the card and under
     config.using_device("cpu"), the median of DISPATCH_REPS warm calls
     taken in turns; (b) batched_qp_solver(ConeDims(l=2n), "chol2") and
     batched_lp_solver on B=16 such problems at n in DISPATCH_NB (and
     DISPATCH_NB_MORE while the CPU still wins), tensors on the card
     against CPU tensors, the same status per lane on both, every lane
     optimal at DISPATCH_NB (at n=1024 f64 chol2 ends some orthant lanes
     'singular', in the JAX package too); (c) K1, K2 (k=1) and K3
     (k=n) against cholesky_ex, cholesky_solve and solve_triangular at
     B=16 over DISPATCH_NK, host median of 20, and the three summed
     (a factor and its solves); (e) the repo's own single-instance
     solves (phase 13's gp, acent2 and l+q+s cpl, phase 15's PWL models
     through op.solve) on the card and on the CPU, beside their KKT
     order and the route the default thresholds give them; each
     crossover (the smallest KKT order, or n for (c), from which the
     card wins at every larger one swept) printed beside its default in
     config.py (ops/ipm_chol.py: 0, the kernels at every n), a
     difference printed, not checked; (d) with both thresholds ROUTE_T:
     the userguide LP, SOCP and SDP come back on the CPU and coneqp at
     n=512 on the card, each with the card-forced call's status,
     iterations within 1, x within 1e-6 (1 + |x|); batched_lp_solver at
     B=16 n=32 given numpy data returns CPU tensors within 1e-6 of the
     card's, given CUDA tensors stays on the card; batched_qp_solver at
     n=32 with "chol2_mixed_nofb" on numpy data, and with "chol2" on f32
     CUDA tensors, stays on the card and launches K1; with thresholds 0
     the userguide LP stays on the card; in a fresh process
     KVXOPT_TPU_HOST_DISPATCH=0 turns dispatch off (the LP on the card)
     and ROUTE_T turns it on.
Phases 1-17 and 19 run with executor dispatch off (both thresholds 0, in this
process and, through the environment, in every process it starts), so
that they measure the card; phase 19(b) sets config.py's thresholds
for its route checks and 0 again after them; phase 18 sets the
thresholds itself and restores config.py's defaults at its end.
The CPU solves of phases 4, 6, 10, 11-15 and 19 run in three worker
processes (spawned after the build, at lower priority, a few CPU threads
each; phase 10's first, then the short ones of 11-15, then phases 4
and 6, then 19's) beside the card's phases, and are compared with the
card's solves at the end; each phase prints the seconds since the
start.  Phases 11-13 and 15 run the f64 chol2, chol, qr and ldl
strategies (cuSOLVER and torch) and the ADMM's torch operations, which
launch none of K1-K4; they print the counts, set to 0 before each
solve.
Each pass-1 breakdown prints K1's, K2's and K3's device time, launches
and share, cuSOLVER's eigh and potrf kernels' the same way, and the host's
synchronizing calls per IPM iteration.  The line before the card's line
is the kernels line: per kernel its launches on the main path (phase 7;
K4: phase 2; K5, K6 and K7: one portfolio-b32 call, phases 2b, 2c
and 2d), in
phase 14(b) (launches_phase14), in phase 16(a)'s
group=1 run (launches_phase16) and in phase 17(e) (launches_phase17),
its error against
the plain version, its time, the plain version's and one PyTorch call's
(median of 20), and its bound from the bytes and flops of the same
shape.  The last line is
{"ok": true, "device": {...}}; the line before it is
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`.
"""

import contextlib
import importlib.util
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import torch

B, N, M = 16, 512, 1024
SEEDS = range(16)
L_EQ, Q_EQ, P_EQ = 512, (64,) * 8, 32   # phase 5: m = 512 + 8 * 64 = M
L_S, Q_S, S_S = 256, (64,) * 4, (16,) * 2  # phase 7: m = 256+256+512 = M
K_GRID = 384    # phase 11: n = k, m = 2k, as bench_configs.cfg_activsg
SUB_SEED = 2000  # the stand-in for the ACTIVSg2000 submatrix
M_AC, N_AC = 2000, 1000   # phase 13: analytic centering, A (m, n)
N_GP, K_GP = 256, (8,) * 65  # phase 13: the seeded GP, 64 constraints
N_OF = 64       # phase 13: oracle_from_function's variables
M_PWL, N_PWL = 1000, 250  # phase 15(a): five times the examples' size
N_OSQP, M_OSQP = 1000, 2000  # phase 15(c): the OSQP QP, G (m, n)
OSQP_PROFILED = 200  # phase 15(c): ADMM iterations of the profiled call
# phase 14: bcsstk13's order and stored lower nonzeros, the band of the
# stand-in's random couplings; the scenario batch, padded order and tile
# size of bench_configs.cfg_bcsstk; the Hermitian case's order and count
N_SP, NNZ_SP, BAND_SP = 2003, 42943, 60
B_SP, NPAD_SP, TS_SP = 16, 2048, 128
N_SPZ, NNZ_SPZ = 300, 4000
# phase 17: dist_cholesky's order and block (the KVX_DRYRUN_SCALE=1 size
# of __graft_entry__.py), the sharded solve's distributed block, the
# arrow blocks (phase 11's K_GRID) and their border, each world's time
N_DC, NB_DC, NB_SH = 2048, 256, 128
B_AR, NB_AR, NC_AR = 16, K_GRID, 64
WORLD_S = 300.0
T0 = time.perf_counter()
POOL = None     # the worker processes of the CPU solves


# the f32 kernels; K5, the f64 Cholesky solve, runs on the f64 paths
F32_KERNELS = ("K1", "K2", "K3", "K4")


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    if POOL is not None:
        POOL.terminate()
    sys.exit(1)


def stamp(label):
    print(f"elapsed {time.perf_counter() - T0:.1f} s: {label}", flush=True)


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


def spd_batch(Bn, n, seed, dev):
    """G'G + nI with G (2n, n) standard normal, f32, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn((Bn, 2 * n, n), generator=g, device=dev)
    return G.mT @ G + n * torch.eye(n, device=dev)


def large_problem(seed, n=N, m=M):
    """The numpy generator of bench._large_problem."""
    rng = np.random.default_rng(seed)
    Mx = rng.standard_normal((n, n))
    P = Mx @ Mx.T + n * np.eye(n)
    q = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    h = G @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
    return P, q, G, h


def lqeq_problem(seed, n=N, l=L_EQ, qs=Q_EQ, p=P_EQ):
    """Feasible by construction: P = MM' + nI and q as bench._large_problem;
    G standard normal, x0 = 0.1 randn; s0 uniform(0.5, 1.5) on the
    orthant and SOC blocks as bench_configs._socp_batch builds them;
    h = G x0 + s0; A standard normal (p, n), b = A x0."""
    rng = np.random.default_rng(seed)
    m = l + sum(qs)
    Mx = rng.standard_normal((n, n))
    P = Mx @ Mx.T + n * np.eye(n)
    q = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    x0 = 0.1 * rng.standard_normal(n)
    s0 = np.empty(m)
    s0[:l] = rng.uniform(0.5, 1.5, l)
    ofs = l
    for qm in qs:
        u = rng.standard_normal(qm - 1) * 0.3
        s0[ofs] = np.linalg.norm(u) + rng.uniform(0.5, 1.5)
        s0[ofs + 1:ofs + qm] = u
        ofs += qm
    A = rng.standard_normal((p, n))
    return P, q, G, G @ x0 + s0, A, A @ x0


def lqs_problem(seed, n=N, l=L_S, qs=Q_S, ss=S_S):
    """Feasible l + q + s QP, no equality rows: P = MM' + nI and q as
    bench._large_problem; G standard normal with each column's s rows
    symmetrized block by block, x0 = 0.1 randn; s0 uniform(0.5, 1.5) on
    the orthant, SOC blocks as lqeq_problem builds them, and M M' + I
    with M = 0.2 randn(m, m) on each s block; h = G x0 + s0."""
    rng = np.random.default_rng(seed)
    m = l + sum(qs) + sum(k * k for k in ss)
    Mx = rng.standard_normal((n, n))
    P = Mx @ Mx.T + n * np.eye(n)
    q = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    ofs = l + sum(qs)
    for k in ss:
        X = G[ofs:ofs + k * k].reshape(k, k, n)
        G[ofs:ofs + k * k] = (0.5 * (X + X.transpose(1, 0, 2))).reshape(
            k * k, n)
        ofs += k * k
    x0 = 0.1 * rng.standard_normal(n)
    s0 = np.empty(m)
    s0[:l] = rng.uniform(0.5, 1.5, l)
    ofs = l
    for qm in qs:
        u = rng.standard_normal(qm - 1) * 0.3
        s0[ofs] = np.linalg.norm(u) + rng.uniform(0.5, 1.5)
        s0[ofs + 1:ofs + qm] = u
        ofs += qm
    for k in ss:
        Ms = 0.2 * rng.standard_normal((k, k))
        s0[ofs:ofs + k * k] = (Ms @ Ms.T + np.eye(k)).ravel()
        ofs += k * k
    return P, q, G, G @ x0 + s0


def grid_scenarios(k=K_GRID, seeds=SEEDS):
    """(c, G, h), one LP per seed, as bench_configs._grid_scenarios builds
    them, with a seeded standard-normal k x k `sub` standing in for the
    ACTIVSg2000 submatrix (its file is not in the repo):
    G0 = [sub + (1 + sum|sub|) I; -I] on every lane, and per lane
    x0 = 0.1 randn, s0 uniform(0.5, 1.5), h = G0 x0 + s0, z0 uniform(0.1,
    1), c = -G0' z0."""
    sub = np.random.default_rng(SUB_SEED).standard_normal((k, k))
    G0 = np.vstack([sub + np.eye(k) * (1.0 + np.abs(sub).sum()),
                    -np.eye(k)])
    m, n = G0.shape
    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        x0 = rng.standard_normal(n) * 0.1
        h = G0 @ x0 + rng.uniform(0.5, 1.5, m)
        out.append((-G0.T @ rng.uniform(0.1, 1.0, m), G0, h))
    return tuple(np.stack(a) for a in zip(*out))


def lqs_lp(seed, n=N, l=L_S, qs=Q_S, ss=S_S):
    """A bounded l + q + s cone LP: G and h as lqs_problem builds them,
    c = -G' z0 with z0 inside the cone as tests/test_conelp.py's
    mixed-cone problem makes it: uniform(0.5, 1.5) on the orthant,
    (2, 0.1, ..., 0.1) on each SOC block, I + 0.1 ones on each s block."""
    _, _, G, h = lqs_problem(seed, n, l, qs, ss)
    z0 = [np.random.default_rng(seed).uniform(0.5, 1.5, l)]
    z0 += [np.r_[2.0, np.full(k - 1, 0.1)] for k in qs]
    z0 += [(np.eye(k) + 0.1 * np.ones((k, k))).ravel() for k in ss]
    return -G.T @ np.concatenate(z0), G, h


def lqs_x0(seed, n=N, l=L_S, qs=Q_S, ss=S_S):
    """lqs_problem's x0 (h = G x0 + s0 with s0 inside the cone), from the
    same draws."""
    rng = np.random.default_rng(seed)
    m = l + sum(qs) + sum(k * k for k in ss)
    rng.standard_normal((n, n))
    rng.standard_normal(n)
    rng.standard_normal((m, n))
    return 0.1 * rng.standard_normal(n)


def acent_data(m=M_AC, n=N_AC, seed=0):
    """examples/acent.py's generator at m x n: A standard normal,
    b = |A u| + uniform(0.5, 2) > 0, so x = 0 is strictly feasible."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    return A, np.abs(A @ rng.standard_normal(n)) + rng.uniform(0.5, 2.0, m)


def acent_oracle(A, b):
    """cp oracle of minimize -sum log(b - Ax) (examples/acent.py), on the
    tensors' device: H = z0 A' diag(1/y^2) A."""
    def F(x=None, z=None):
        if x is None:
            return 0, A.new_zeros(A.shape[1])
        y = b - A @ x
        f = -torch.sum(torch.log(y)).reshape(1)
        Df = (A.T @ (1.0 / y)).reshape(1, -1)
        if z is None:
            return f, Df
        return f, Df, z[0] * (A.T @ (A * (1.0 / y ** 2)[:, None]))
    return F


def ball_oracle(x0, r2):
    """One nonlinear constraint |x|^2 - r2 <= 0, starting at x0."""
    def F(x=None, z=None):
        if x is None:
            return 1, x0
        f = (x @ x - r2).reshape(1)
        Df = (2.0 * x).reshape(1, -1)
        if z is None:
            return f, Df
        return f, Df, 2.0 * z[0] * torch.eye(x.shape[0], dtype=x.dtype,
                                             device=x.device)
    return F


def ball_radius2(seed=0):
    """r^2 of phase 13's l+q+s cpl: r = 1.1 |x0| with x0 = lqs_x0, so x0
    is strictly feasible; the ball cuts off the cone LP's solution, which
    the phase checks by znl > 1e-8."""
    return (1.1 * np.linalg.norm(lqs_x0(seed))) ** 2


def gp_userguide():
    """examples/gp.py: the userguide's box (section 9.3), (K, F, g)."""
    Aflr, Awall = 1000.0, 100.0
    alpha, beta, gamma, delta = 0.5, 2.0, 0.5, 2.0
    F = np.array([[-1., 1., 1., 0., -1., 1., 0., 0.],
                  [-1., 1., 0., 1., 1., -1., 1., -1.],
                  [-1., 0., 1., 1., 0., 0., -1., 1.]]).T
    g = np.log([1.0, 2 / Awall, 2 / Awall, 1 / Aflr, alpha, 1 / beta,
                gamma, 1 / delta])
    return [1, 2, 1, 1, 1, 1, 1], F, g


def gp_data(n=N_GP, K=K_GP, seed=0):
    """A seeded GP, (K, F, g): the objective's 8 rows standard normal,
    g0 standard normal; the 2n constraint rows [M; -M] (M standard
    normal n x n) shuffled over the 64 blocks, which bounds the feasible
    set, and g = log(uniform(0.5, 1) / 8), so lse(g_i) < 0: x = 0 is
    strictly feasible."""
    rng = np.random.default_rng(seed)
    F0, g0 = rng.standard_normal((K[0], n)), rng.standard_normal(K[0])
    Mx = rng.standard_normal((n, n))
    Fc = np.vstack([Mx, -Mx])[rng.permutation(2 * n)]
    gc = np.log(rng.uniform(0.5, 1.0, sum(K) - K[0]) / K[1])
    return list(K), np.vstack([F0, Fc]), np.concatenate([g0, gc])


ACENT2_G = np.array([
    [0., -1., 0., 0., -21., -11., 0., -11., 10., 8., 0., 8., 5.],
    [0., 0., -1., 0., 0., 10., 16., 10., -10., -10., 16., -10., 3.],
    [0., 0., 0., -1., -5., 2., -17., 2., -6., 8., -17., -7., 6.]]).T
ACENT2_H = np.array([1.0, 0.0, 0.0, 0.0, 20., 10., 40., 10., 80., 10.,
                     40., 10., 15.])
ACENT2_DIMS = {"l": 0, "q": [4], "s": [3]}


def acent2_oracle(x=None, z=None):
    """examples/acent2.py: minimize -sum log(1 - x_i^2), None outside
    |x_i| < 1."""
    if x is None:
        return 0, np.zeros(3)
    if float(torch.max(torch.abs(x))) >= 1.0:
        return None
    u = 1.0 - x ** 2
    f = -torch.sum(torch.log(u)).reshape(1)
    Df = (2.0 * x / u).reshape(1, -1)
    if z is None:
        return f, Df
    return f, Df, torch.diag(2.0 * z[0] * (1.0 + x ** 2) / u ** 2)


def smooth_data(n=N_OF, seed=3):
    """Q = B B'/n + I and a: f(x) = (sum exp(a x) - 2n, x'Qx - 4)."""
    rng = np.random.default_rng(seed)
    Bm = rng.standard_normal((n, n))
    return Bm @ Bm.T / n + np.eye(n), 0.5 * rng.standard_normal(n)


def smooth_fn(Q, a):
    def f(x):
        return torch.stack([torch.sum(torch.exp(a * x)) - 2.0 * x.shape[0],
                            x @ Q @ x - 4.0])
    return f


def smooth_by_hand(Q, a, x, z):
    """f, Df and H = z0 d2f0 + z1 d2f1 of smooth_fn, written out."""
    ex = torch.exp(a * x)
    f = torch.stack([ex.sum() - 2.0 * x.shape[0], x @ Q @ x - 4.0])
    Df = torch.stack([a * ex, 2.0 * Q @ x])
    return f, Df, z[0] * torch.diag(a * a * ex) + 2.0 * z[1] * Q


def stiffness_standin(seed=0, n=N_SP, nnz=NNZ_SP, band=BAND_SP,
                      complex_=False):
    """A seeded stand-in for bcsstk13, whose .mtx file is not in the repo:
    (S, shift) with S a scipy CSC matrix of order n in full storage,
    symmetric positive definite (Hermitian where complex_), with `nnz`
    stored lower nonzeros, the diagonal included.  Its pattern: a 2-D
    9-point grid of ceil(n/3) nodes with 3 dof per node, each coupled node
    pair a dense 3x3 block, topped up with random couplings i - j in
    [1, band].  Its values: M standard normal on that pattern (real and
    imaginary parts where complex_, a real diagonal) and Hermitian, and
    S = M + M^H + shift I with shift = 10 max_i sum_j |M_ij|, the diagonal
    dominance bench_configs.cfg_bcsstk gives bcsstk13 (:227, :242)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    nodes = -(-n // 3)
    side = int(np.ceil(np.sqrt(nodes)))
    a = np.arange(nodes)
    r, c = np.divmod(a, side)
    p, q = (v.ravel() for v in np.meshgrid(np.arange(3), np.arange(3),
                                           indexing="ij"))
    rows, cols = [], []
    for dr, dc in ((0, 0), (0, 1), (1, -1), (1, 0), (1, 1)):
        b = a + dr * side + dc
        ok = (c + dc >= 0) & (c + dc < side) & (b < nodes)
        i = 3 * b[ok, None] + p[None, :]
        j = 3 * a[ok, None] + q[None, :]
        keep = (i >= j) & (i < n)
        rows.append(i[keep])
        cols.append(j[keep])
    i, j = np.concatenate(rows), np.concatenate(cols)
    keys = set((i * n + j).tolist())
    need = nnz - len(keys)
    free = band * n - band * (band + 1) // 2 - int(
        ((i - j >= 1) & (i - j <= band)).sum())
    if not 0 <= need <= free:
        raise ValueError(f"{nnz} lower entries: the grid has {len(keys)} "
                         f"and the band {free} more")
    extra = []
    while need > 0:
        ii = rng.integers(1, n, 4 * need)
        jj = ii - rng.integers(1, band + 1, 4 * need)
        for k in (ii * n + jj)[jj >= 0].tolist():
            if k not in keys:
                keys.add(k)
                extra.append(k)
                need -= 1
                if need == 0:
                    break
    k = np.concatenate([i * n + j, np.array(extra, dtype=np.int64)])
    i, j = np.divmod(k, n)
    v = rng.standard_normal(len(k))
    if complex_:
        v = v + 1j * np.where(i > j, rng.standard_normal(len(k)), 0.0)
    low = sp.csc_matrix((v, (i, j)), shape=(n, n))
    M = low + sp.tril(low, -1).conj().T
    shift = 10.0 * float(abs(M).sum(1).max())
    S = (M + M.conj().T + shift * sp.eye(n)).tocsc()
    S.sort_indices()
    return S, shift


def sparse_lp(S, seed=0):
    """Phase 14(c)'s LP, as tests/test_sparse_kkt.py and
    tests/test_tile_chol.py build theirs: G = [S; I; -I] (m = 3n), x0 =
    0.1 randn, h = [S x0 + uniform(0.5, 1.5); 4; 4] so that x0 is strictly
    feasible, and c = -G' z0 with z0 uniform(0.1, 1) so that the LP is
    bounded -> (c, G, h) as numpy arrays."""
    n = S.shape[0]
    rng = np.random.default_rng(seed)
    Sd = S.toarray()
    G = np.vstack([Sd, np.eye(n), -np.eye(n)])
    x0 = rng.standard_normal(n) * 0.1
    h = np.concatenate([Sd @ x0 + rng.uniform(0.5, 1.5, n),
                        np.full(n, 4.0), np.full(n, 4.0)])
    return -G.T @ rng.uniform(0.1, 1.0, 3 * n), G, h


def kkt_tiles(S, ts=TS_SP):
    """The tile analysis of K = G' W^-2 G for G = [S; I; -I]: the pattern
    of |S|'|S| + I, in S's own order."""
    import scipy.sparse as sp
    from kvxopt_tpu_torch.ops.tile_chol import (TileCholesky,
                                                tile_pattern_from_sparse)
    A = abs(sp.csc_matrix(S))
    pattern = tile_pattern_from_sparse((A.T @ A + sp.eye(S.shape[0]))
                                       .tocsc(), ts)
    return TileCholesky(pattern, S.shape[0], ts)


def tile_kktsolver(S, tile):
    """kktsolver(W) of phase 14(c) for G = [S; I; -I], S a dense tensor:
    K = S' D1^-2 S + D2^-2 + D3^-2 formed on S's device (d = W.d in three
    parts), then tiles_from_dense, factor and solve of `tile`, whose
    analysis was made once, outside the IPM loop."""
    n = S.shape[0]

    def kktsolver(W):
        d = W.d
        Ss = S / d[:n, None]
        K = Ss.mT @ Ss
        K.diagonal().add_(1.0 / d[n:2 * n] ** 2 + 1.0 / d[2 * n:] ** 2)
        X = tile.factor(tile.tiles_from_dense(K))

        def solve(bx, by, bz):
            w = bz / d ** 2
            ux = tile.solve(X, bx + S.mT @ w[:n] + w[n:2 * n] - w[2 * n:])
            return ux, by, (torch.cat([S @ ux, ux, -ux]) - bz) / d ** 2
        return solve
    return kktsolver


def nonlinear_calls(dev):
    """name -> a call of phase 13's solves as a user makes it: numpy data
    (config.default_device), the oracles' own data as tensors on
    `dev`."""
    from kvxopt_tpu_torch import solvers
    from kvxopt_tpu_torch.solvers.cvxprog import oracle_from_function
    A, b = (torch.as_tensor(a, device=dev) for a in acent_data())
    c, G, h = lqs_lp(0)
    x0 = torch.as_tensor(lqs_x0(0), device=dev)
    Q, a = (torch.as_tensor(v, device=dev) for v in smooth_data())
    ofs = oracle_from_function(smooth_fn(Q, a), torch.zeros(
        N_OF, dtype=torch.float64, device=dev))
    return {
        "cp acent": lambda: solvers.cp(acent_oracle(A, b)),
        "cpl l+q+s+ball": lambda: solvers.cpl(
            c, ball_oracle(x0, ball_radius2()), G, h, LQS_DIMS),
        "gp userguide": lambda: solvers.gp(*gp_userguide()),
        "gp seeded": lambda: solvers.gp(*gp_data()),
        "cp acent2": lambda: solvers.cp(acent2_oracle, ACENT2_G, ACENT2_H,
                                        ACENT2_DIMS),
        "cpl oracle_from_function": lambda: solvers.cpl(-np.ones(N_OF),
                                                        ofs),
    }


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


def k1_agrees(label, K, L, Dinv):
    """K1's (L, Dinv) of K against its plain version: max|L-Lref|/max|Lref|
    < 1e-5 and max|Dinv*Lkk-I| < 1e-4 over the diagonal blocks -> the
    largest |L-Lref|."""
    from kvxopt_tpu_torch.ops import chol_ls as cl
    n = K.shape[-1]
    Lr, _ = cl.batched_cholesky_ls_ref(K)
    torch.cuda.synchronize()
    errL = float((L - Lr).abs().max())
    relL = errL / float(Lr.abs().max())
    eyeerr = 0.0
    for kb in range(Dinv.shape[0]):
        lo, hi = kb * 128, min(kb * 128 + 128, n)
        Iblk = Dinv[kb, :, :hi - lo, :hi - lo] @ L[:, lo:hi, lo:hi]
        eyeerr = max(eyeerr, float((Iblk - torch.eye(
            hi - lo, device=K.device)).abs().max()))
    print(f"{label}: max|L-Lref|/max|Lref|={relL:.3e} "
          f"(tol 1e-5), max|Dinv*Lkk-I|={eyeerr:.3e} (tol 1e-4)")
    check(relL < 1e-5 and eyeerr < 1e-4, f"{label}: disagrees with plain")
    return errL


def phase1(dev):
    from kvxopt_tpu_torch.ops import chol_ls as cl
    rows = {}
    for Bn, n in ((B, N), (3, 200), (B, P_EQ), (4, 100), (4, 20)):
        K = spd_batch(Bn, n, 1, dev)
        L, Dinv = cl.batched_cholesky_ls(K)
        errL = k1_agrees(f"K1 B={Bn} n={n}", K, L, Dinv)
        if (Bn, n) == (B, N):
            rows["K1"] = dict(
                err=errL, ms=median_ms(lambda: cl.batched_cholesky_ls(K)),
                plain=median_ms(lambda: cl.batched_cholesky_ls_ref(K)),
                lib=median_ms(lambda: torch.linalg.cholesky_ex(K)))
            print(f"time K1 B={B} n={N}: kernel {rows['K1']['ms']:.4f} ms, "
                  f"plain {rows['K1']['plain']:.4f} ms, cholesky_ex "
                  f"{rows['K1']['lib']:.4f} ms (median of 20)")

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
    rows["K2"] = phase1_k2(dev)
    rows["K3"] = phase1_k3(dev)
    return rows


# (B, n, k) where K2 can go wrong: the solves' shapes, ragged n (200, and
# 130 for 4-byte copies), ragged k, k > n, and n = 4096 (the solved tile
# in shared memory at k = 1, in device memory at k = 32)
K2_CHECKS = ((B, N, 1), (B, N, P_EQ), (B, P_EQ, 1), (B, P_EQ, P_EQ),
             (3, 200, 1), (2, 130, 3), (2, 128, 37), (2, 256, 300),
             (2, 4096, 1), (2, 4096, P_EQ))


def rhs_views(b):
    """rhs as the solver passes it and as views with other strides: a
    transposed copy read back through a transposed view, and slices of a
    wider tensor, 16-byte aligned (+4) or not (+3); k = 1 also as 3-D."""
    Bn, n = b.shape[:2]
    k = b.shape[2] if b.ndim == 3 else 0
    out = {"contiguous": b}
    if k == 0:
        out["3-D"] = b[:, :, None]
    out["transposed"] = b.mT.contiguous().mT if k else b.t().contiguous().t()
    for ofs in (3, 4):
        wide = torch.zeros((Bn, n, k + 8) if k else (Bn, n + 8),
                           device=b.device)
        wide[..., ofs:ofs + (k or n)] = b
        out[f"slice+{ofs}"] = wide[..., ofs:ofs + (k or n)]
    return out


def phase1_k2(dev):
    """K2 against its plain version at K2_CHECKS with every view of R
    (relative residual and difference < 1e-5, one launch per call), then
    its times beside the plain version and torch.cholesky_solve."""
    from kvxopt_tpu_torch import ops
    from kvxopt_tpu_torch.ops import chol_ls as cl
    g = torch.Generator(device=dev).manual_seed(14)
    err = None
    for Bn, n, k in K2_CHECKS:
        K = spd_batch(Bn, n, 13, dev)
        L, Dinv = cl.batched_cholesky_ls(K)
        b = torch.randn((Bn, n) if k == 1 else (Bn, n, k), generator=g,
                        device=dev)
        xr = cl.chol_solve_ls_ref(L, Dinv, b)
        b3 = b.reshape(Bn, n, k).double()
        for view, r in rhs_views(b).items():
            before = ops.LAUNCHES["K2"]
            x = cl.chol_solve_ls(L, Dinv, r)
            torch.cuda.synchronize()
            check(ops.LAUNCHES["K2"] == before + 1, "K2: not one launch")
            check(x.shape == r.shape and x.is_contiguous(), "K2 output")
            x3 = x.reshape(Bn, n, k).double()
            res = float(torch.linalg.norm(K.double() @ x3 - b3) /
                        torch.linalg.norm(b3))
            dx = float((x.reshape(xr.shape) - xr).abs().max())
            rel = dx / float(xr.abs().max())
            print(f"K2 B={Bn} n={n} k={k} R {view}: residual {res:.3e}, "
                  f"max|x-xref|/max|xref|={rel:.3e} (tol 1e-5)")
            check(res < 1e-5 and rel < 1e-5, "K2 disagrees with plain")
            if (Bn, n, k, view) == (B, N, 1, "contiguous"):
                err = dx
        del K, L, Dinv
    t = k2_times(dev)
    for (Bn, n, k), r in t.items():
        bms, by = bound(*solve_work(Bn, n, k, 2))
        print(f"bound K2 B={Bn} n={n} k={k}: {bms:.4f} ms ({by})")
    return dict(t[(B, N, 1)], err=err)


# (B, n, k) where K3's tiling can go wrong: k = n at the factor-refinement
# shape, ragged k, k > n, the Schur complement's shape
K3_CHECKS = ((B, N, N), (2, 128, 37), (2, 200, 200), (2, 256, 300),
             (B, P_EQ, P_EQ))
K3_TIMES = ((B, N, N), (B, 1024, 1024), (B, P_EQ, P_EQ))


def k3_views(b):
    """R as the solver passes it and as views with other strides: the
    transposed R of the factor refinement's second solve (kkt.py) and
    column slices of a wider tensor, 16-byte aligned or not."""
    Bn, n, k = b.shape
    out = {"contiguous": b}
    if n == k:
        out["transposed"] = b.transpose(1, 2)
    for ofs in (3, 4):
        wide = torch.zeros((Bn, n, k + 8), device=b.device)
        wide[:, :, ofs:ofs + k] = b
        out[f"slice+{ofs}"] = wide[:, :, ofs:ofs + k]
    return out


def phase1_k3(dev):
    """K3 against its plain version at K3_CHECKS in both modes and with
    strided R, then times, TFLOP/s on the B n^2 k count and device times
    from one profiler window per mode at K3_TIMES."""
    from kvxopt_tpu_torch.ops import chol_ls as cl
    rng = np.random.default_rng(7)
    row = None
    for Bn, n, k in K3_CHECKS:
        L, Dinv = cl.batched_cholesky_ls(spd_batch(Bn, n, 8, dev))
        b = torch.as_tensor(rng.standard_normal((Bn, n, k)).astype(
            np.float32), device=dev)
        for trans in (False, True):
            for view, r in k3_views(b).items():
                x = cl.tri_solve_ls(L, Dinv, r, trans=trans)
                xr = cl.tri_solve_ls_ref(L, Dinv, r, trans=trans)
                torch.cuda.synchronize()
                check(x.shape == r.shape, "K3 output shape")
                err = float((x - xr).abs().max())
                rel = err / (float(xr.abs().max()) + 1.0)
                print(f"K3 B={Bn} n={n} k={k} trans={trans} R {view}: "
                      f"max|x-xref|/(max|xref|+1)={rel:.3e} (tol 1e-4)")
                check(rel < 1e-4, "K3 disagrees with plain")
                if (Bn, n, k, trans, view) == (B, N, N, False, "contiguous"):
                    row = dict(err=err)

    for Bn, n, k in K3_TIMES:
        L, Dinv = cl.batched_cholesky_ls(spd_batch(Bn, n, 9, dev))
        b = torch.randn((Bn, n, k), device=dev)
        flop = Bn * n * n * k
        for trans in (False, True):
            mode = "bwd" if trans else "fwd"
            a = median_ms(lambda: cl.tri_solve_ls(L, Dinv, b, trans=trans))
            p = median_ms(lambda: cl.tri_solve_ls_ref(L, Dinv, b,
                                                      trans=trans))
            print(f"time K3 B={Bn} n={n} k={k} {mode}: kernel {a:.4f} ms "
                  f"({flop / a / 1e9:.3f} TFLOP/s), plain {p:.4f} ms "
                  f"({flop / p / 1e9:.3f} TFLOP/s) (median of 20; "
                  "TFLOP/s = B n^2 k / t)")
            if (Bn, n, k, trans) == (B, N, N, False):
                row.update(ms=a, plain=p, lib=median_ms(
                    lambda: torch.linalg.solve_triangular(L, b, upper=False)))
                print(f"time solve_triangular B={Bn} n={n} k={k}: "
                      f"{row['lib']:.4f} ms (median of 20)")
            if (Bn, n, k) != (B, N, N):
                continue
            reps = 10

            def both():
                for _ in range(reps):
                    cl.tri_solve_ls(L, Dinv, b, trans=trans)
                for _ in range(reps):
                    cl.tri_solve_ls_ref(L, Dinv, b, trans=trans)

            _, kern, _, _, why = trace(both)
            mine = [e for e in kern if "tri_kernel" in e.key]
            rest = [e for e in kern if "tri_kernel" not in e.key]
            dk = sum(e.self_device_time_total for e in mine) / reps / 1e3
            dp = sum(e.self_device_time_total for e in rest) / reps / 1e3
            if why or dk == 0 or dp == 0:
                print(f"profile K3 B={Bn} n={n} k={k} {mode}: device time "
                      f"not measured ({why or 'no device events'})")
                continue
            print(f"profile K3 B={Bn} n={n} k={k} {mode}: device {dk:.4f} "
                  f"ms per call ({flop / dk / 1e9:.3f} TFLOP/s), plain "
                  f"{dp:.4f} ms ({flop / dp / 1e9:.3f} TFLOP/s) in " +
                  ", ".join(f"{e.count}x {e.key[:60]}" for e in rest))
    return row


# K2 at the solves' shapes: the PCG's one column and K^-1 A' (k = p) at
# n=512, the Schur PCG at n=32, and the headline n=1024
K2_TIMES = ((B, N, 1), (B, N, P_EQ), (B, P_EQ, 1), (B, P_EQ, P_EQ),
            (B, 1024, 1))
# K2's kernel name in the profiler
K2_KEYS = ("chol_solve_kernel",)


# spin kernels that open each profiler trace: a trace that follows a large
# one drops the records of its first few dozen kernels (the host's launch
# calls stay whole)
PRIME = 256


def trace(fn, host_ops=False):
    """fn() once under torch.profiler -> (wall s, fn's device events, the
    host's calls {name: count}, fn's kernel launches, why).  The trace
    holds the device's events and the host's CUDA runtime calls, and with
    host_ops the host's operators too (they make the trace of a call that
    runs many small operations slow to read).  It opens with PRIME spin
    kernels and a sync, which what it returns leaves out.  why is None
    where the trace holds as many of fn's kernels as the host launched,
    else why no device time can be read from it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(PRIME):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    on_dev = [e for e in ev if e.device_type == DeviceType.CUDA
              and "spin_kernel" not in e.key]
    calls = {e.key: e.count for e in ev if e.device_type == DeviceType.CPU}
    if calls.get("cudaDeviceSynchronize"):
        calls["cudaDeviceSynchronize"] -= 1       # the opening sync
    launches = sum(n for k, n in calls.items()
                   if "Launch" in k and "Kernel" in k) - PRIME
    kernels = sum(e.count for e in on_dev
                  if not e.key.startswith(("Memcpy", "Memset")))
    why = ("no device events" if not on_dev else
           "no launch calls in the trace" if launches < 0 else
           f"trace lost {launches - kernels} of {launches} kernels"
           if kernels < launches else None)
    return wall, on_dev, calls, launches, why


def profile_split(fn, reps=20, flush=None):
    """Device time per call by kernel name from one profiler trace of
    `reps` warm calls: {name: ms}, empty (and the reason printed) where
    the trace gives no device time.  `flush` runs before each call,
    inside the trace."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()

    _, kern, _, _, why = trace(calls)
    if why:
        print(f"profile: device time not measured ({why})")
        return {}
    out = {}
    for e in kern:
        if e.self_device_time_total > 0:
            out[e.key] = out.get(e.key, 0.0) + \
                e.self_device_time_total / reps / 1e3
    return out


def profile_ms(fn, reps=20, keys=(), flush=None):
    """Device time per call from one profiler window of `reps` calls:
    (all kernels, the kernels whose name holds one of `keys`).  With
    `flush` (run before each call, outside `keys`) only the second is
    meaningful.  None where the profiler saw no device events."""
    split = profile_split(fn, reps, flush)
    mine = sum(v for k, v in split.items() if any(s in k for s in keys))
    return (sum(split.values()), mine) if split else None


# K1's and K4's kernels in the profiler, this tree's and those of the
# earlier design (chol_diag/panel/trailing_kernel per panel), so that
# tools/kernel_compare.py can time an older checkout
K1_KEYS = ("chol_warp_kernel", "chol_block_kernel", "chol_cluster_kernel",
           "chol_tile_kernel", "chol_diag_kernel", "chol_panel_kernel",
           "chol_trailing_kernel")
# K1 and K4 at the solves' shapes (pass 1's K, the Schur complement, a
# ragged n), at one diagonal block (the chain's step), and the factor-only
# scaling rows
K1_TIMES = ((B, N), (B, P_EQ), (3, 200), (B, 128))
K1_SCALING = ((16, 1024), (8, 2048), (2, 4096))


def k1_times(dev, shapes=K1_TIMES):
    """K1, K4, the plain version and torch.linalg.cholesky_ex at `shapes`:
    host-timed median of 20 (10 at n > 512), and warm device time per call
    from one profiler window each, split by kernel (the wrapper's torch
    copies included in the call's total)."""
    from kvxopt_tpu_torch.ops import chol as ch, chol_ls as cl
    rows = {}
    for Bn, n in shapes:
        K = spd_batch(Bn, n, 11, dev)
        reps = 20 if n <= 512 else 10
        fns = {"K1": lambda: cl.batched_cholesky_ls(K),
               "K4": lambda: ch.batched_cholesky(K),
               "plain": lambda: cl.batched_cholesky_ls_ref(K),
               "cholesky_ex": lambda: torch.linalg.cholesky_ex(K)}
        row = {}
        for name, fn in fns.items():
            ms = median_ms(fn, reps)
            split = profile_split(fn, reps)
            dev_ms = sum(split.values()) if split else None
            kern = sum(v for k, v in split.items()
                       if any(s in k for s in K1_KEYS))
            row[name] = dict(ms=ms, dev=dev_ms, dev_kernels=kern,
                             split={k[:60]: v for k, v in split.items()})
            dtxt = ("device not measured" if dev_ms is None else
                    f"device {dev_ms:.4f} ms per call (" + ", ".join(
                        f"{k[:40]} {v:.4f}" for k, v in sorted(
                            split.items(), key=lambda kv: -kv[1])) + ")")
            print(f"time {name} B={Bn} n={n}: host {ms:.4f} ms (median of "
                  f"{reps}); {dtxt}", flush=True)
        rows[(Bn, n)] = row
        print(f"bound K1 B={Bn} n={n}: "
              "{:.4f} ms ({})".format(*bound(*factor_work(Bn, n, True))),
              flush=True)
        del K
    return rows


def k2_times(dev):
    """K2, its plain version and torch.cholesky_solve (one cuSOLVER call
    for the same function) at K2_TIMES: host-timed median of 20, and
    device time per call from one profiler window each, K2's kernel warm
    (back to back) and cold (a 64 MB write evicts L2 before each call)."""
    from kvxopt_tpu_torch.ops import chol_ls as cl
    scratch = torch.empty(16 * 2 ** 20, device=dev)
    rows = {}
    for Bn, n, k in K2_TIMES:
        K = spd_batch(Bn, n, 10, dev)
        L, Dinv = cl.batched_cholesky_ls(K)
        b = torch.randn((Bn, n) if k == 1 else (Bn, n, k), device=dev)
        b3 = b if k > 1 else b[..., None]

        def kern():
            return cl.chol_solve_ls(L, Dinv, b)

        def lib():
            return torch.cholesky_solve(b3, L)

        t = dict(ms=median_ms(kern),
                 plain=median_ms(lambda: cl.chol_solve_ls_ref(L, Dinv, b)),
                 lib=median_ms(lib))
        warm = profile_ms(kern, keys=K2_KEYS)
        cold = profile_ms(kern, keys=K2_KEYS, flush=scratch.zero_)
        libd = profile_ms(lib)
        if warm is not None and cold is not None and libd is not None:
            t.update(dev_call=warm[0], dev=warm[1], dev_cold=cold[1],
                     dev_lib=libd[0])
            dtxt = (f"; device: K2 call {warm[0]:.4f} ms, kernel "
                    f"{warm[1]:.4f} warm, {cold[1]:.4f} cold, cholesky_solve "
                    f"{libd[0]:.4f}")
        else:
            dtxt = "; device time not measured"
        rows[(Bn, n, k)] = t
        print(f"time K2 B={Bn} n={n} k={k}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, cholesky_solve {t['lib']:.4f} ms "
              f"(host, median of 20){dtxt}", flush=True)
    return rows


def phase2(dev):
    """K4 against its plain version and K1's L, then K4's own path: the
    ops entry point, with the counts set to 0 just before it."""
    from kvxopt_tpu_torch import ops
    from kvxopt_tpu_torch.ops import chol as ch, chol_ls as cl
    row = None
    for Bn, n in ((B, N), (3, 200)):
        K = spd_batch(Bn, n, 4, dev)
        L = ch.batched_cholesky(K)
        Lr = ch.batched_cholesky_ref(K)
        L1 = cl.batched_cholesky_ls(K)[0]
        torch.cuda.synchronize()
        err = float((L - Lr).abs().max())
        rel = err / float(Lr.abs().max())
        d1 = float((L - L1).abs().max()) / float(Lr.abs().max())
        print(f"K4 B={Bn} n={n}: max|L-Lref|/max|Lref|={rel:.3e} (tol "
              f"1e-5), max|L-L_K1|/max|Lref|={d1:.3e} (tol 1e-5)")
        check(rel < 1e-5 and d1 < 1e-5, "K4 disagrees with plain or K1")
        check(tuple(L.shape) == (Bn, n, n) and torch.equal(L, torch.tril(L)),
              "K4 output is not tril (B, n, n)")
        if (Bn, n) == (B, N):
            row = dict(err=err,
                       ms=median_ms(lambda: ch.batched_cholesky(K)),
                       plain=median_ms(lambda: ch.batched_cholesky_ref(K)),
                       lib=median_ms(lambda: torch.linalg.cholesky_ex(K)))
            print(f"time K4 B={B} n={N}: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain']:.4f} ms, cholesky_ex {row['lib']:.4f} ms "
                  "(median of 20)")

    K = spd_batch(B, N, 5, dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    L = ops.batched_cholesky(K)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    K64 = K.double()
    res = float(torch.linalg.norm(L.double() @ L.double().mT - K64) /
                torch.linalg.norm(K64))
    print(f"K4 path ops.batched_cholesky B={B} n={N}: launches {launches}, "
          f"|LL'-K|/|K| = {res:.3e} (tol 1e-6)")
    check(launches["K4"] >= 1, "K4 never launched on its path")
    check(res < 1e-6, "ops.batched_cholesky does not factor K")
    return row, launches["K4"]


# K5 at portfolio-b32's and portfolio-single's solves: n = 1010, k = 1
# (the Newton solves) and k = 11 (K^-1 A' with p = 11); then wider
# right-hand sides at B = 32, on both sides of ipm_chol.K5_MAX_K = 64, where
# the plain version takes over
K5_TIMES = ((32, 1010, 1), (32, 1010, 11), (1, 1010, 1), (1, 1010, 11),
            (32, 1010, 16), (32, 1010, 64), (32, 1010, 128))
K5_KEYS = ("chol_solve64_kernel",)
# the plain version's kernels: cuBLAS's batched and single trsm and trsv
TRSM_KEYS = ("trsm", "trsv")


def k5_work(Bn, n, k):
    """Bytes and flops of K5 at (B, n, k): the lower triangle of each
    factor read once (the kernel reads it once per sweep), R read and X
    written once; n^2 k flops a sweep and lane."""
    return 8 * Bn * (n * (n + 1) // 2 + 2 * n * k), 2 * Bn * n * n * k


def portfolio_call(dev, kernel):
    """One portfolio-b32 call (the benchmark's problem, seed 1, after one
    warm call): `kernel`'s launches by ops.LAUNCHES, the shapes it ran
    at, and the program's record."""
    from benchmark.problems import portfolio
    from kvxopt_tpu_torch import ConeDims, ops, parallel, trace
    from kvxopt_tpu_torch.solvers.coneprog import OPTIMAL
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "benchmark", "configs", "portfolio.json")) as f:
        cfg = json.load(f)
    gen = torch.Generator(device=dev).manual_seed(1)
    d = portfolio.make(cfg, gen, 32, dev, torch.float64)
    solve = parallel.batched_qp_solver(ConeDims(l=cfg["n"]))
    args = [d[key] for key in ("P", "q", "G", "h", "A", "b")]
    solve(*args)
    torch.cuda.synchronize()
    ops.reset_launches()
    out = solve(*args)
    status = out[5].cpu()
    rec = trace.calls()[-1]
    shapes = {f"{kn},{n},{k}": c for (kn, n, k), c in
              ops.LAUNCH_SHAPES.items() if kn == kernel}
    print(f"{kernel} in one portfolio-b32 call: launches "
          f"{ops.LAUNCHES[kernel]}, ipm.steps "
          f"{rec.counters.get('ipm.steps')}, kkt.factor "
          f"{rec.spans['kkt.factor'][0]}, shapes {shapes}, optimal "
          f"{int((status == OPTIMAL).sum())}/32", flush=True)
    check(ops.LAUNCHES[kernel] > 0,
          f"{kernel}: the portfolio-b32 call did not go through {kernel}")
    return ops.LAUNCHES[kernel], rec


def k5(dev):
    """K5 against its plain version at K5_TIMES, then its times: host
    median of 20 for K5, the plain version (two solve_triangular calls)
    and torch.cholesky_solve, device time per call from one profiler
    window each (K5 warm, and cold behind a 64 MB write), beside its
    bound; then its launches in one portfolio-b32 call.  -> the K5 row
    of the kernels line (the first shape) and those launches."""
    from kvxopt_tpu_torch.ops import chol_ls as cl, chol_solve64 as c64
    scratch = torch.empty(16 * 2 ** 20, device=dev)
    row = None
    for Bn, n, k in K5_TIMES:
        g = torch.Generator(device=dev).manual_seed(11)
        G = torch.randn((Bn, 2 * n, n), generator=g, device=dev,
                        dtype=torch.float64)
        L = torch.linalg.cholesky(G.mT @ G + n * torch.eye(
            n, device=dev, dtype=torch.float64))
        b = torch.randn((Bn, n) if k == 1 else (Bn, n, k), generator=g,
                        device=dev, dtype=torch.float64)
        b3 = b if k > 1 else b[..., None]
        x = c64.chol_solve64(L, b)
        xr = cl.chol_solve_ls_ref(L, None, b)
        err = float((x - xr).abs().max() / xr.abs().max())
        check(err < 1e-12, f"K5 B={Bn} n={n} k={k}: disagrees with plain "
              f"({err:.3e})")

        def kern():
            return c64.chol_solve64(L, b)

        def plain():
            return cl.chol_solve_ls_ref(L, None, b)

        def lib():
            return torch.cholesky_solve(b3, L)

        t = dict(err=err, ms=median_ms(kern), plain=median_ms(plain),
                 lib=median_ms(lib))
        warm = profile_ms(kern, keys=K5_KEYS)
        cold = profile_ms(kern, keys=K5_KEYS, flush=scratch.zero_)
        pl = profile_ms(plain, keys=TRSM_KEYS)
        libd = profile_ms(lib)
        bd, by = bound(*k5_work(Bn, n, k))
        t.update(bound=bd, bound_by=by)
        if None not in (warm, cold, pl, libd):
            t.update(dev=warm[1], dev_cold=cold[1], dev_plain=pl[1],
                     dev_lib=libd[0])
            dtxt = (f"; device: K5 {warm[1]:.4f} ms warm, {cold[1]:.4f} "
                    f"cold ({100 * bd / cold[1]:.1f}% of the bound), plain "
                    f"trsm/trsv {pl[1]:.4f}, cholesky_solve {libd[0]:.4f}")
        else:
            dtxt = "; device time not measured"
        print(f"time K5 B={Bn} n={n} k={k}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, cholesky_solve {t['lib']:.4f} ms (host, "
              f"median of 20); bound {bd:.4f} ms ({by}); max|x-xref|/"
              f"max|xref| {err:.2e}{dtxt}", flush=True)
        if row is None:
            row = t
    return row, portfolio_call(dev, "K5")[0]


# K6 at the batch cells' factors: n = 1010 at B = 32 (portfolio-b32),
# B = 100 (portfolio-frontier) and B = 1 (portfolio-single), and the
# Schur complement's n = p = 11
K6_TIMES = ((32, 1010), (100, 1010), (1, 1010), (32, 11))
K6_KEYS = ("chol64_kernel", "chol64_warp_kernel")
# cholesky_ex's kernels: cuSOLVER's potrf and its getrf at B = 1
POTRF_KEYS = ("potrf", "getrf")


def k6_work(Bn, n):
    """Bytes and flops of K6 at (B, n): K read and L written once, n^2
    doubles each a lane; n^3 / 3 flops a lane."""
    return 16 * Bn * n * n, Bn * n ** 3 / 3


def k6(dev):
    """K6 against its plain version at K6_TIMES by backward error
    (||L L' - K|| / ||K|| <= 10 n u per lane) and by its factor
    (max|L - Lref| / max|Lref| < 1e-12, the diagonal positive), then its
    times: host median of 20 for K6, the plain version (cholesky_nan) and
    torch.linalg.cholesky_ex, device time per call from one profiler
    window each (K6 warm, and cold behind a 64 MB write), beside its
    bound; then its launches in one portfolio-b32 call, two a
    factorization.  -> the K6 row of the kernels line (the first shape)
    and those launches."""
    from kvxopt_tpu_torch.ops import chol64, chol_ls as cl
    scratch = torch.empty(16 * 2 ** 20, device=dev)
    row = None
    for Bn, n in K6_TIMES:
        g = torch.Generator(device=dev).manual_seed(11)
        G = torch.randn((Bn, 2 * n, n), generator=g, device=dev,
                        dtype=torch.float64)
        K = G.mT @ G + n * torch.eye(n, device=dev, dtype=torch.float64)
        L = chol64.cholesky64(K)
        Lr = cl.cholesky_nan(K)
        back = float((torch.linalg.matrix_norm(L @ L.mT - K) /
                      torch.linalg.matrix_norm(K)).max())
        err = float((L - Lr).abs().max() / Lr.abs().max())
        check(back <= 10 * n * 2.0 ** -52 and
              bool((torch.triu(L, 1) == 0).all()),
              f"K6 B={Bn} n={n}: backward error {back:.3e}")
        # L L' alone does not fix the signs of L's columns: the factor
        # itself is held to the plain version, its diagonal positive
        check(err < 1e-12 and
              bool((torch.diagonal(L, dim1=-2, dim2=-1) > 0).all()),
              f"K6 B={Bn} n={n}: disagrees with plain ({err:.3e})")

        def kern():
            return chol64.cholesky64(K)

        def plain():
            return cl.cholesky_nan(K)

        def lib():
            return torch.linalg.cholesky_ex(K)

        t = dict(err=err, ms=median_ms(kern), plain=median_ms(plain),
                 lib=median_ms(lib))
        warm = profile_ms(kern, keys=K6_KEYS)
        cold = profile_ms(kern, keys=K6_KEYS, flush=scratch.zero_)
        pl = profile_ms(plain, keys=POTRF_KEYS)
        libd = profile_ms(lib, keys=POTRF_KEYS)
        bd, by = bound(*k6_work(Bn, n))
        t.update(bound=bd, bound_by=by)
        if None not in (warm, cold, pl, libd):
            t.update(dev=warm[1], dev_cold=cold[1], dev_plain=pl[0],
                     dev_lib=libd[0])
            dtxt = (f"; device: K6 {warm[1]:.4f} ms warm, {cold[1]:.4f} "
                    f"cold ({100 * bd / cold[1]:.1f}% of the bound), plain "
                    f"{pl[0]:.4f} (potrf {pl[1]:.4f}), cholesky_ex "
                    f"{libd[0]:.4f} (potrf {libd[1]:.4f})")
        else:
            dtxt = "; device time not measured"
        print(f"time K6 B={Bn} n={n}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, cholesky_ex {t['lib']:.4f} ms (host, "
              f"median of 20); bound {bd:.4f} ms ({by}); backward error "
              f"{back:.2e}; max|L-Lref|/max|Lref| {err:.2e}{dtxt}",
              flush=True)
        if row is None:
            row = t
    launches, rec = portfolio_call(dev, "K6")
    check(launches == 2 * rec.spans["kkt.factor"][0],
          "K6: not two launches a factorization in portfolio-b32")
    return row, launches


# K7 at the batch cells' products: (B, m, n, G and C0 shared) for
# portfolio-frontier, portfolio-b32 and portfolio-single
K7_TIMES = ((100, 1000, 1010, True), (32, 1000, 1010, False),
            (1, 1000, 1010, True))
K7_KEYS = ("gram64_kernel",)
# the GEMM of the formed scaled G: cuBLAS's f64 kernels
GEMM_KEYS = ("gemm",)


def k7_work(Bn, m, n, shared):
    """Bytes and flops of K7 at (B, m, n): G read once (once for all
    lanes where shared) and K's lower triangle written once; the syrk's
    m n^2 flops a lane."""
    g = m * n * (1 if shared else Bn)
    return 8 * (g + Bn * n * (n + 1) // 2), Bn * m * n * n


def k7(dev):
    """K7 against its plain version at K7_TIMES, d spread over decades:
    K's lower triangle within 2 (m + 4) u (|C0| + |G|' diag(w) |G|) of
    the plain version's, entry by entry; then its times: host median of
    20 for K7, the plain version (the formed scaled G, C0 + Gs' Gs, reg)
    and torch.matmul's GEMM Gs' Gs alone, device time per call from one
    profiler window each (K7 warm, and cold behind a 64 MB write), beside
    its bound; then its launches in one portfolio-b32 call, one a
    factorization of K.  -> the K7 row of the kernels line (the first
    shape) and those launches."""
    from kvxopt_tpu_torch.ops import gram64 as g7
    scratch = torch.empty(16 * 2 ** 20, device=dev)
    row = None
    for Bn, m, n, shared in K7_TIMES:
        g = torch.Generator(device=dev).manual_seed(11)
        G = torch.randn((m, n) if shared else (Bn, m, n), generator=g,
                        device=dev, dtype=torch.float64)
        d = torch.exp(2.0 * torch.randn((Bn, m), generator=g, device=dev,
                                        dtype=torch.float64))
        R = torch.randn((n, n) if shared else (Bn, n, n), generator=g,
                        device=dev, dtype=torch.float64)
        C0 = R @ R.mT
        K = g7.gram64(C0, G, d, 1e-9)
        Kr = g7.gram64_ref(C0, G, d, 1e-9)
        absb = g7.gram64_ref(C0.abs(), G.abs(), d, 0.0)
        low = torch.tril(torch.ones(n, n, dtype=torch.bool, device=dev))
        over = float(((K - Kr).abs() - 2 * (m + 4) * 2.0 ** -52 * absb)
                     [..., low].max())
        err = float(((K - Kr).abs()[..., low]).max() / Kr.abs().max())
        check(over <= 0.0, f"K7 B={Bn} m={m} n={n}: beyond its bound "
              f"({err:.3e})")
        Gs = G / d[..., None]

        def kern():
            return g7.gram64(C0, G, d, 1e-9)

        def plain():
            return g7.gram64_ref(C0, G, d, 1e-9)

        def lib():
            return Gs.mT @ Gs

        t = dict(err=err, ms=median_ms(kern), plain=median_ms(plain),
                 lib=median_ms(lib))
        warm = profile_ms(kern, keys=K7_KEYS)
        cold = profile_ms(kern, keys=K7_KEYS, flush=scratch.zero_)
        pl = profile_ms(plain, keys=GEMM_KEYS)
        libd = profile_ms(lib, keys=GEMM_KEYS)
        bd, by = bound(*k7_work(Bn, m, n, shared))
        t.update(bound=bd, bound_by=by)
        if None not in (warm, cold, pl, libd):
            t.update(dev=warm[1], dev_cold=cold[1], dev_plain=pl[0],
                     dev_lib=libd[0])
            dtxt = (f"; device: K7 {warm[1]:.4f} ms warm, {cold[1]:.4f} "
                    f"cold ({100 * bd / cold[1]:.1f}% of the bound), plain "
                    f"{pl[0]:.4f} (GEMM {pl[1]:.4f}), torch.matmul "
                    f"{libd[0]:.4f}")
        else:
            dtxt = "; device time not measured"
        print(f"time K7 B={Bn} m={m} n={n} shared={shared}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain']:.4f} ms, torch.matmul "
              f"{t['lib']:.4f} ms (host, median of 20); bound {bd:.4f} ms "
              f"({by}); max|K-Kref|/max|Kref| {err:.2e}{dtxt}", flush=True)
        if row is None:
            row = t
        del G, d, R, C0, K, Kr, absb, Gs
    launches, rec = portfolio_call(dev, "K7")
    check(launches == rec.spans["kkt.factor"][0],
          "K7: not one launch a factorization in portfolio-b32")
    return row, launches


def scaling_rows(dev):
    """Factor-only rows as bench.py's kernel-scaling rows:
    TFLOP/s = B n^3 / 3 / t for K1, K4 and the plain version."""
    from kvxopt_tpu_torch.ops import chol as ch, chol_ls as cl
    for Bn, n in ((16, 1024), (8, 2048), (2, 4096)):
        K = spd_batch(Bn, n, 6, dev)
        Lr = ch.batched_cholesky_ref(K)
        L4 = ch.batched_cholesky(K)
        torch.cuda.synchronize()
        rel = float((L4 - Lr).abs().max() / Lr.abs().max())
        check(rel < 1e-4, f"K4 disagrees with plain at B={Bn} n={n}")
        del L4, Lr
        flop = Bn * n ** 3 / 3
        t = {"K1": median_ms(lambda: cl.batched_cholesky_ls(K), 10),
             "K4": median_ms(lambda: ch.batched_cholesky(K), 10),
             "plain": median_ms(lambda: ch.batched_cholesky_ref(K), 10)}
        print(f"scaling B={Bn} n={n}: " + ", ".join(
            f"{k} {v:.4f} ms ({flop / v / 1e9:.3f} TFLOP/s)"
            for k, v in t.items()) +
            f" (median of 10; K4 vs plain {rel:.2e})", flush=True)


# H100 SXM peaks (NVIDIA's data sheet, at 700 W): device memory and f32
# FFMA outside the tensor cores
HBM_BYTES_S, F32_FLOP_S = 3.35e12, 67e12


def bound(nbytes, flops):
    """(least time in ms, what bounds it): the larger of the bytes over
    the memory rate and the operations over the f32 peak."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOP_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def solve_work(Bn, n, k, sweeps):
    """Bytes and flops of K2 (sweeps=2) or K3 (1) at (B, n, k): the
    strictly block-lower part of L and the lower triangle of each valid
    Dinv block read once, R read and X written once; per column and sweep
    the band and Dinv products (2 flops per multiply-add), n (n + 1) / 2
    multiply-adds in all."""
    hs = [min(128, n - bi) for bi in range(0, n, 128)]
    band = sum(h * bi for h, bi in zip(hs, range(0, n, 128)))
    diag = sum(h * (h + 1) // 2 for h in hs)
    nbytes = 4 * Bn * (band + diag + 2 * n * k)
    return nbytes, 2 * sweeps * Bn * k * (band + diag)


def factor_work(Bn, n, inverses):
    """Bytes and flops of K1 (inverses) or K4: A read and L written once
    (and Dinv written), B n^3/3 flops (and the blocks' inverses)."""
    hs = [min(128, n - bi) for bi in range(0, n, 128)]
    nbytes = 4 * Bn * (2 * n * n + (sum(h * h for h in hs) if inverses
                                     else 0))
    flops = Bn * (n ** 3 + (sum(h ** 3 for h in hs) if inverses else 0)) / 3
    return nbytes, flops


def kernel_bounds():
    """Each kernel's bound at the shape of its row in the kernels line."""
    return {"K1": bound(*factor_work(B, N, True)),
            "K2": bound(*solve_work(B, N, 1, 2)),
            "K3": bound(*solve_work(B, N, N, 1)),
            "K4": bound(*factor_work(B, N, False)),
            "K5": bound(*k5_work(*K5_TIMES[0])),
            "K6": bound(*k6_work(*K6_TIMES[0])),
            "K7": bound(*k7_work(*K7_TIMES[0]))}


def residuals(P, q, G, h, x, s, z, A=None, b=None, y=None):
    """Relative stationarity, Gx+s=h and (with A) Ax=b residuals."""
    rd = np.einsum("bij,bj->bi", P, x) + q + np.einsum("bji,bj->bi", G, z)
    if A is not None:
        rd = rd + np.einsum("bji,bj->bi", A, y)
    rp = np.einsum("bij,bj->bi", G, x) + s - h
    out = [np.linalg.norm(rd, axis=1) / (1 + np.linalg.norm(q, axis=1)),
           np.linalg.norm(rp, axis=1) / (1 + np.linalg.norm(h, axis=1))]
    if A is not None:
        ra = np.einsum("bij,bj->bi", A, x) - b
        out.append(np.linalg.norm(ra, axis=1) /
                   (1 + np.linalg.norm(b, axis=1)))
    return out


def solve_phase(name, dev, dims, data):
    """The two-pass mixed driver on the card, its counts set to 0 just
    before the solve and read just after."""
    from kvxopt_tpu_torch import cones, ops
    from kvxopt_tpu_torch.convert import problem_to_torch, state_to_numpy
    from kvxopt_tpu_torch.parallel import batched_qp_solver_mixed
    eq = len(data) == 6
    solve = batched_qp_solver_mixed(dims, with_eq=eq)
    args = problem_to_torch(*data, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    ops.reset_launches()
    out = solve(*args)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    shapes = dict(ops.LAUNCH_SHAPES)
    pass2 = solve.stats["pass2_lanes"]
    x, y, s, z, it, status, m = state_to_numpy(out)
    print(f"{name}: status {status.tolist()}, iterations {it.tolist()}, "
          f"lanes re-solved in pass 2: {pass2}")
    print(f"{name} pass-1 status {solve.stats['pass1_status']}")
    print(f"{name} launches during the solve: {launches}")
    print(f"{name} launches by (kernel, n, k): "
          f"{sorted(shapes.items())}")
    check((status == 1).all(), f"{name}: not every lane optimal")
    res = residuals(*data[:4], x, s, z, *(data[4:] + (y,) if eq else ()))
    names = ["stationarity", "Gx+s=h", "Ax=b"]
    print(f"{name} max residuals: " + ", ".join(
        f"{k} {r.max():.3e}" for k, r in zip(names, res)) + " (tol 1e-6)")
    check(all(r.max() < 1e-6 for r in res), f"{name}: residuals too large")
    ts_, tz_ = cones.max_step2(dims, out[2], out[3])
    print(f"{name} max_step(s) {float(ts_.max()):.3e}, max_step(z) "
          f"{float(tz_.max()):.3e} (<= 0: in the cone)")
    check(bool((ts_ <= 0).all() and (tz_ <= 0).all()),
          f"{name}: s or z outside the cone")
    check(all(launches[k] > 0 for k in ("K1", "K2", "K3")),
          f"{name}: a kernel of the path never launched")
    ts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(*args)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    print(f"{name} wall time: median {np.median(ts):.4f} s over 3 warm "
          f"batch solves {['%.4f' % t for t in ts]}, mean iterations "
          f"{it.mean():.2f}")
    walls = breakdown(name, dims, args)
    walls["two-pass"] = float(np.median(ts))
    return (x, it, status), launches, shapes, walls


# cuSOLVER's kernels behind torch.linalg.eigh / eigvalsh (Jacobi for
# small batched matrices, else tridiagonal reduction and divide and
# conquer) and behind cholesky_ex, by substrings of their names
EIGH_KEYS = ("syevj", "syevd", "sytrd", "stedc", "ormtr", "steqr")
POTRF_KEYS = ("potrf",)
# host-side events that say how often pass 1 waits for the card, and the
# torch.linalg calls that may wait (eigh checks its info on the host)
HOST_KEYS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaMemcpyAsync", "aten::linalg_eigh", "aten::linalg_eigvalsh",
             "aten::linalg_cholesky_ex", "aten::linalg_svd")


def breakdown(name, dims, args):
    """Each pass alone on all lanes, and the device's share of pass 1:
    K1-K3's and cuSOLVER's eigh and potrf device time and launches, and
    the host's synchronizing calls per IPM iteration.  Returns each
    pass's wall {"pass 1": s, "pass 2": s}."""
    from kvxopt_tpu_torch.parallel import batched_qp_solver
    from kvxopt_tpu_torch.solvers.coneprog import Options
    fast = batched_qp_solver(dims, "chol2_mixed_nofb", Options(ozaki=True))
    slow = batched_qp_solver(dims, "chol2")
    iters = None
    walls = {}
    for pname, fn in (("pass 1 chol2_mixed_nofb", fast),
                      ("pass 2 chol2 (f64)", slow)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        walls[pname[:6]] = time.perf_counter() - t0
        print(f"{name} breakdown {pname} on all {B} lanes: "
              f"{walls[pname[:6]]:.4f} s, iterations "
              f"{out[4].tolist()}, status {out[5].tolist()}")
        iters = iters or int(out[4].max())
    # the host's operators only where pass 1 calls torch.linalg's eigh
    # (s cones): their trace is slow to read, and the CUDA runtime's
    # calls are in every trace
    wall, kern, calls, _, why = trace(lambda: fast(*args),
                                      host_ops=bool(dims.s))
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    if why or busy == 0:
        print(f"{name} profile pass 1: device time not measured "
              f"({why or 'no device events'})")
        return walls
    print(f"{name} profile pass 1 (profiler on): wall {wall:.4f} s, device "
          f"busy {busy:.4f} s ({100 * busy / wall:.1f}%), {len(kern)} "
          "kernels")
    for kname, keys in (("K1", K1_KEYS), ("K2", K2_KEYS),
                        ("K3", ("tri_kernel",)), ("eigh", EIGH_KEYS),
                        ("potrf", POTRF_KEYS)):
        mine = [e for e in kern if any(k in e.key.lower() for k in keys)]
        t = sum(e.self_device_time_total for e in mine) / 1e6
        print(f"{name} profile pass 1: {kname} {t * 1e3:.2f} ms in "
              f"{sum(e.count for e in mine)} launches, "
              f"{100 * t / busy:.2f}% of device busy time")
    host = {k: v for k, v in calls.items() if k in HOST_KEYS}
    print(f"{name} profile pass 1 host calls over {iters} IPM iterations: " +
          ", ".join(f"{k} {v} ({v / iters:.1f} per iteration)"
                    for k, v in sorted(host.items())))
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
              f"{e.key[:90]}")
    return walls


def slice_data(name):
    """(dims, data) of a solve phase: its 16 seeded problems, stacked."""
    from kvxopt_tpu_torch import ConeDims
    dims, make = {
        "slice": (ConeDims(l=M), large_problem),
        "slice l+q+eq": (ConeDims(l=L_EQ, q=Q_EQ), lqeq_problem),
        "slice l+q+s": (ConeDims(l=L_S, q=Q_S, s=S_S), lqs_problem)}[name]
    return dims, tuple(np.stack(a) for a in zip(*(make(s) for s in SEEDS)))


def chol_check(dev, x_mixed):
    """Phase 8: batched_qp_solver with no strategy named (chol, as with q
    or s cones in the JAX package; f64 Cholesky through cuSOLVER) on
    phase 7's problems: every lane optimal, x within 1e-6 (1 + |x|) of
    the mixed driver's."""
    from kvxopt_tpu_torch.convert import problem_to_torch, state_to_numpy
    from kvxopt_tpu_torch.parallel import batched_qp_solver
    dims, data = slice_data("slice l+q+s")
    args = problem_to_torch(*data, device=dev)
    solve = batched_qp_solver(dims)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = state_to_numpy(solve(*args))
    secs = time.perf_counter() - t0
    x, it, status = out[0], out[4], out[5]
    dx = np.linalg.norm(x - x_mixed, axis=1) / (
        1 + np.linalg.norm(x_mixed, axis=1))
    print(f"slice l+q+s default chol: {secs:.4f} s (first call), status "
          f"{status.tolist()}, iterations {it.tolist()}, max "
          f"|x_chol-x_mixed|/(1+|x_mixed|) {dx.max():.3e} (tol 1e-6)")
    check((status == 1).all(), "default chol: not every lane optimal")
    check(dx.max() <= 1e-6, "default chol: x differs from the mixed driver")


def nan_check(dev):
    """Phase 7's trap: one lane with NaN in an s block.  max_step,
    max_step_eig and compute_scaling ('eigh' and 'svd') on the card give
    NaN on that lane, as jnp.linalg does, and the CPU's values (1e-10)
    on the others; no cuSOLVER call raises."""
    from kvxopt_tpu_torch import ConeDims, cones
    dims = ConeDims(l=2, q=(3,), s=(3, 2, 3))
    rng = np.random.default_rng(5)
    s, z = (np.tile(cones.cone_e(dims, torch.float64).numpy(), (3, 1)) +
            0.1 * rng.standard_normal((3, dims.size)) for _ in range(2))
    s, z = (cones.symm(dims, torch.from_numpy(a)).numpy() for a in (s, z))
    s[1, dims.sofs[-1] + 1] = np.nan

    def run(device):
        S, Z = (torch.tensor(a, device=device) for a in (s, z))
        out = [cones.max_step(dims, S), cones.max_step_eig(dims, S)[0]]
        for method in ("eigh", "svd"):
            out.append(cones.compute_scaling(dims, S, Z, method)[1])
        return [t.cpu().numpy() for t in out]
    for g, c in zip(run(dev), run("cpu")):
        g, c = g.reshape(3, -1), c.reshape(3, -1)
        check(np.isnan(g[1]).any() and np.isfinite(g[[0, 2]]).all(),
              "NaN in an s block: not NaN on that lane alone on the card")
        check(np.abs(g[[0, 2]] - c[[0, 2]]).max() <=
              1e-10 * (1 + np.abs(c[[0, 2]]).max()),
              "NaN in an s block: other lanes differ from the CPU")
    print("slice l+q+s NaN in one lane's s block: max_step, max_step_eig, "
          "compute_scaling (eigh, svd) NaN on that lane only, as on the CPU")


def ldl_check(dev):
    """Phase 9: the ldl and ldl2 strategies through make_qp_solver at
    B=4 n=64 l=64 q=(16,16) s=(8,8) on the card and on CPU tensors: every
    lane optimal, the same status, iterations within 1, x within 1e-6.
    Not at full width: ldl_nopiv steps column by column."""
    from kvxopt_tpu_torch import ConeDims
    from kvxopt_tpu_torch.convert import problem_to_torch, state_to_numpy
    from kvxopt_tpu_torch.parallel import make_qp_solver
    shape = (64, 64, (16, 16), (8, 8))
    data = tuple(np.stack(a) for a in zip(*(lqs_problem(s, *shape)
                                            for s in range(4))))
    dims = ConeDims(l=shape[1], q=shape[2], s=shape[3])
    for name in ("ldl", "ldl2"):
        solve = make_qp_solver(dims, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = state_to_numpy(solve(*problem_to_torch(*data, device=dev)))
        secs = time.perf_counter() - t0
        c = state_to_numpy(solve(*problem_to_torch(*data, device="cpu")))
        dx = np.linalg.norm(g[0] - c[0], axis=1) / (
            1 + np.linalg.norm(c[0], axis=1))
        print(f"{name} B=4 n=64 l+q+s: card {secs:.4f} s, status "
              f"{g[5].tolist()}, iterations {g[4].tolist()}; cpu status "
              f"{c[5].tolist()}, iterations {c[4].tolist()}; max "
              f"|x_gpu-x_cpu|/(1+|x_cpu|) {dx.max():.3e} (tol 1e-6)")
        check((g[5] == 1).all() and (g[5] == c[5]).all(),
              f"{name}: not optimal, or status differs from the CPU")
        check((np.abs(g[4] - c[4]) <= 1).all() and dx.max() <= 1e-6,
              f"{name}: iterations or x differ from the CPU")


def warm_times(fn, reps=3):
    """Host wall seconds of `reps` warm calls, each ending in a sync."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return ts


def device_busy(fn):
    """One call under `trace` -> namespace: wall (s); busy, the device's
    time (s), None where the trace gives none; launches and copies, the
    host's CUDA runtime calls; busy_text and device_text, the busy share
    and the device's time or why they are not measured."""
    from types import SimpleNamespace
    wall, on_dev, calls, launches, why = trace(fn)
    busy = None if why else sum(e.self_device_time_total
                                for e in on_dev) / 1e6
    copies = sum(n for k, n in calls.items()
                 if k.startswith(("cudaMemcpy", "cudaMemset")))
    return SimpleNamespace(
        wall=wall, busy=busy, launches=launches, copies=copies, why=why,
        busy_text=f"device busy not measured ({why})" if why else
        f"device busy {busy:.4f} s ({100 * busy / wall:.1f}%)",
        device_text=f"device time not measured ({why})" if why else
        f"device {1e3 * busy:.4f} ms")


def count_syncs(fn):
    """The host's waits for the card in one call: the synchronizing
    operations (a tensor read to the host, .item(), .tolist(), a
    data-dependent shape) that torch.cuda's sync debug mode reports."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def on_card(name, *tensors):
    check(all(t.device.type == "cuda" for t in tensors if t is not None),
          f"{name}: a result tensor is not on the card")


LP_OPTIONS = {"abstol": 1e-7, "feastol": 1e-7}
LQS_DIMS = {"l": L_S, "q": list(Q_S), "s": list(S_S)}


def lp_batch(dev):
    """Phase 11, "lp batch": batched_lp_solver(ConeDims(l=2k)) on the 16
    LPs of grid_scenarios (n=384, m=768, f64, abstol and feastol 1e-7),
    numpy data and no device named, the kernel counts set to 0 just
    before the solve and read just after: every lane optimal; with x, s,
    y and z over tau, G'z + c and Gx + s - h below 1e-6 relative; s and z
    in the cone; 3 warm wall times and the device's busy share over one
    solve."""
    from kvxopt_tpu_torch import ConeDims, cones, ops
    from kvxopt_tpu_torch.convert import lp_state_to_numpy
    from kvxopt_tpu_torch.parallel import batched_lp_solver
    name = "lp batch"
    dims = ConeDims(l=2 * K_GRID)
    c, G, h = grid_scenarios()
    solve = batched_lp_solver(dims, options=LP_OPTIONS)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = solve(c, G, h)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    on_card(name, *out[:8], *out[8].values())
    check(out[0].device.index == dev.index, f"{name}: not on {dev}")
    x, y, s, z, tau, kappa, it, status, m = lp_state_to_numpy(out)
    x, s, z = (a / tau[:, None] for a in (x, s, z))
    print(f"{name} B={len(SEEDS)} n={K_GRID} m={2 * K_GRID}: status "
          f"{status.tolist()}, iterations {it.tolist()}, first call "
          f"{first:.4f} s, kernel launches during the solve {launches} "
          "(the f64 chol2 path runs none)")
    check((status == 1).all(), f"{name}: not every lane optimal")
    rd = np.linalg.norm(np.einsum("bji,bj->bi", G, z) + c, axis=1) / (
        1 + np.linalg.norm(c, axis=1))
    rp = np.linalg.norm(np.einsum("bij,bj->bi", G, x) + s - h, axis=1) / (
        1 + np.linalg.norm(h, axis=1))
    print(f"{name} max residuals: G'z+c {rd.max():.3e}, Gx+s=h "
          f"{rp.max():.3e} (tol 1e-6)")
    check(rd.max() < 1e-6 and rp.max() < 1e-6, f"{name}: residuals too large")
    ts_, tz_ = cones.max_step2(dims, out[2], out[3])
    print(f"{name} max_step(s) {float(ts_.max()):.3e}, max_step(z) "
          f"{float(tz_.max()):.3e} (<= 0: in the cone)")
    check(bool((ts_ <= 0).all() and (tz_ <= 0).all()),
          f"{name}: s or z outside the cone")
    ts = warm_times(lambda: solve(c, G, h))
    print(f"{name} wall time: median {np.median(ts):.4f} s, min "
          f"{min(ts):.4f}, max {max(ts):.4f} over 3 warm batch solves "
          f"(numpy data in, the host-to-card copy included)")
    pf = device_busy(lambda: solve(c, G, h))
    print(f"{name} profile (profiler on): wall {pf.wall:.4f} s, "
          f"{pf.busy_text}")
    return x, it, status


QP_KEYS = frozenset((
    "status", "x", "y", "s", "z", "iterations", "primal objective",
    "dual objective", "gap", "relative gap", "primal infeasibility",
    "dual infeasibility", "primal slack", "dual slack"))
LP_KEYS = QP_KEYS | {"residual as primal infeasibility certificate",
                     "residual as dual infeasibility certificate"}
# the JAX package's socp/sdp add these beside s and z where those exist
SOCP_KEYS = LP_KEYS | {"zl", "zq", "sl", "sq"}
SDP_KEYS = LP_KEYS | {"zl", "zs", "sl", "ss"}


def userguide_data():
    """The userguide LP (tests/test_conelp.py), SOCP (the same file) and
    SDP (bench_configs._userguide_sdp_data), and the primal- and
    dual-infeasible LPs of tests/test_conelp.py."""
    lp = (np.array([-4.0, -5.0]),
          np.array([[2.0, 1.0], [1.0, 2.0], [-1.0, 0.0], [0.0, -1.0]]),
          np.array([3.0, 3.0, 0.0, 0.0]))
    G1 = -np.array([[-12.0, -6.0, 5.0], [-13.0, 3.0, 5.0],
                    [-12.0, 12.0, -6.0]])
    G2 = -np.array([[-3.0, 6.0, -10.0], [-3.0, 6.0, 2.0], [1.0, 9.0, 2.0],
                    [-1.0, -19.0, 3.0]])
    socp = (np.array([-2.0, 1.0, 5.0]), [G1, G2],
            [np.array([-12.0, -3.0, -2.0]), np.array([27.0, 0.0, 3.0, -42.0])])
    sdp = (np.array([1.0, -1.0, 1.0]),
           [np.array([[-7.0, -11.0, -11.0, 3.0], [7.0, -18.0, -18.0, 8.0],
                      [-2.0, -8.0, -8.0, 1.0]]).T,
            np.array([[-21.0, -11.0, 0.0, -11.0, 10.0, 8.0, 0.0, 8.0, 5.0],
                      [0.0, 10.0, 16.0, 10.0, -10.0, -10.0, 16.0, -10.0, 3.0],
                      [-5.0, 2.0, -17.0, 2.0, -6.0, 8.0, -17.0, 8.0, 6.0]]).T],
           [np.array([[33.0, -9.0], [-9.0, 26.0]]),
            np.array([[14.0, 9.0, 40.0], [9.0, 91.0, 10.0],
                      [40.0, 10.0, 15.0]])])
    pinf = (np.array([1.0]), np.array([[1.0], [-1.0]]), np.array([-1.0, -1.0]))
    dinf = (np.array([-1.0]), np.array([[-1.0]]), np.array([0.0]))
    return lp, socp, sdp, pinf, dinf


def front_ends(dev):
    """Phase 12, "front ends": single-instance solves through
    kvxopt_tpu_torch.solvers with numpy data and no device named, the
    kernel counts set to 0 before each call and read after; every result
    has the JAX function's key set and its tensors on the card, and each
    call's warm median of 3 is printed."""
    from kvxopt_tpu_torch import ConeDims, cones, ops, solvers
    from kvxopt_tpu_torch.convert import problem_to_torch
    from kvxopt_tpu_torch.parallel import batched_qp_solver

    def run(name, fn, keys, status="optimal"):
        torch.cuda.synchronize()
        ops.reset_launches()
        sol = fn()
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        check(set(sol) == keys, f"front ends {name}: keys {sorted(sol)}")
        on_card(f"front ends {name}", *(sol[k] for k in "xysz"))
        ts = warm_times(fn)
        print(f"front ends {name}: status {sol['status']}, iterations "
              f"{sol['iterations']}, warm median {1e3 * np.median(ts):.2f} "
              f"ms (min {1e3 * min(ts):.2f}, max {1e3 * max(ts):.2f}, 3 "
              f"calls), kernel launches {launches}", flush=True)
        check(sol["status"] == status, f"front ends {name}: status "
              f"{sol['status']}, expected {status}")
        return sol

    def host(t):
        return t.cpu().numpy()

    # coneqp and qp on lane 0 of phase 3's orthant problems, against the
    # batched chol2 solve of that lane
    _, data = slice_data("slice")
    xref = batched_qp_solver(ConeDims(l=M), "chol2")(
        *problem_to_torch(*data, device=dev))[0][0].cpu().numpy()
    P, q, G, h = (a[0] for a in data)
    for name, fn in (
            ("coneqp orthant n=512", lambda: solvers.coneqp(P, q, G, h,
                                                            {"l": M})),
            ("qp orthant n=512", lambda: solvers.qp(P, q, G, h))):
        x = host(run(name, fn, QP_KEYS)["x"])
        dx = np.linalg.norm(x - xref) / (1 + np.linalg.norm(xref))
        print(f"front ends {name}: |x-x_chol2|/(1+|x_chol2|) {dx:.3e} "
              "(tol 1e-6)")
        check(dx <= 1e-6, f"front ends {name}: x differs from chol2")

    # conelp on an l+q+s cone LP, default strategy qr
    c, G, h = lqs_lp(0)
    dims = ConeDims.from_dict(LQS_DIMS)
    sol = run("conelp l+q+s n=512", lambda: solvers.conelp(c, G, h, LQS_DIMS),
              LP_KEYS)
    x, s, z = (host(sol[k]) for k in "xsz")
    rd = np.linalg.norm(G.T @ z + c) / (1 + np.linalg.norm(c))
    rp = np.linalg.norm(G @ x + s - h) / (1 + np.linalg.norm(h))
    ts_, tz_ = cones.max_step2(dims, sol["s"][None], sol["z"][None])
    print(f"front ends conelp l+q+s: G'z+c {rd:.3e}, Gx+s=h {rp:.3e} (tol "
          f"1e-6), max_step(s) {float(ts_):.3e}, max_step(z) "
          f"{float(tz_):.3e} (<= 0: in the cone, s eigenvalues included)")
    check(rd < 1e-6 and rp < 1e-6, "front ends conelp: residuals too large")
    check(float(ts_) <= 0 and float(tz_) <= 0,
          "front ends conelp: s or z outside the cone")
    lqs = (x[None], np.array([sol["iterations"]]), np.array([sol["status"]]))

    # the userguide problems and the infeasible LPs, at their tests'
    # tolerances
    lp, socp, sdp, pinf, dinf = userguide_data()
    sol = run("lp userguide", lambda: solvers.lp(*lp), LP_KEYS)
    check(np.abs(host(sol["x"]) - [1.0, 1.0]).max() <= 1e-6 and
          abs(sol["primal objective"] + 9.0) <= 1e-6, "lp userguide: x")
    sol = run("socp userguide", lambda: solvers.socp(
        socp[0], Gq=socp[1], hq=socp[2]), SOCP_KEYS)
    check(np.abs(host(sol["x"]) - [-5.0147, -5.7669, -8.5217]).max() <= 2e-3
          and len(sol["zq"]) == 2, "socp userguide: x")
    sol = run("sdp userguide", lambda: solvers.sdp(
        sdp[0], Gs=sdp[1], hs=sdp[2]), SDP_KEYS)
    check(np.abs(host(sol["x"]) - [-0.3677, 1.8983, -0.8874]).max() <= 1e-3
          and [tuple(t.shape) for t in sol["zs"]] == [(2, 2), (3, 3)],
          "sdp userguide: x")
    sol = run("lp primal infeasible", lambda: solvers.lp(*pinf), LP_KEYS,
              "primal infeasible")
    zc = host(sol["z"])
    check(sol["x"] is None and (zc >= -1e-8).all() and
          np.abs(pinf[1].T @ zc).max() <= 1e-6 and
          abs(float(pinf[2] @ zc) + 1.0) <= 1e-6,
          "lp primal infeasible: certificate")
    sol = run("lp dual infeasible", lambda: solvers.lp(*dinf), LP_KEYS,
              "dual infeasible")
    xc, sc = host(sol["x"]), host(sol["s"])
    check(sol["z"] is None and (sc >= -1e-8).all() and
          abs(float(dinf[0] @ xc) + 1.0) <= 1e-6 and
          np.abs(dinf[1] @ xc + sc).max() <= 1e-6,
          "lp dual infeasible: certificate")
    print("front ends: every certificate meets its identities (h'z = -1, "
          "G'z = 0, z >= 0; c'x = -1, Gx + s = 0, s >= 0)")
    return lqs


def nonlinear(dev):
    """Phase 13, "nonlinear": cp, cpl and gp through
    kvxopt_tpu_torch.solvers as a user calls them (nonlinear_calls), the
    kernel counts set to 0 before each call and read after: every call
    ends optimal with its residuals below 1e-6; per call the warm median
    of 3, iterations, host syncs per iteration and the device's busy
    share over one profiled call.  Returns name -> (x, iterations,
    status, primal objective) for the CPU comparison."""
    from kvxopt_tpu_torch import ConeDims, cones, ops
    from kvxopt_tpu_torch.solvers.cvxprog import oracle_from_function
    calls = nonlinear_calls(dev)
    out = {}

    def host(t):
        return t.detach().cpu().numpy()

    for name, fn in calls.items():
        torch.cuda.synchronize()
        ops.reset_launches()
        sol = fn()
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        on_card(f"nonlinear {name}", *(sol[k] for k in
                                       ("x", "y", "snl", "sl", "znl", "zl")))
        ts = warm_times(fn)
        pf = device_busy(fn)
        syncs = count_syncs(fn)
        it = max(1, sol["iterations"])
        print(f"nonlinear {name}: status {sol['status']}, iterations "
              f"{sol['iterations']}, primal objective "
              f"{sol['primal objective']!r}, warm median "
              f"{1e3 * np.median(ts):.2f} ms (min {1e3 * min(ts):.2f}, max "
              f"{1e3 * max(ts):.2f}, 3 calls), kernel launches {launches}",
              flush=True)
        print(f"nonlinear {name} profile (profiler on): wall {pf.wall:.4f} "
              f"s, {pf.busy_text}; host syncs {syncs} in one call, "
              f"{syncs / it:.1f} per iteration")
        check(sol["status"] == "optimal",
              f"nonlinear {name}: status {sol['status']}")
        check(not any(launches[k] for k in F32_KERNELS),
              f"nonlinear {name}: a kernel of K1-K4 ran on the f64 path")
        out[name] = (host(sol["x"]), sol["iterations"], sol["status"],
                     sol["primal objective"])
        if name == "cp acent":
            A, b = acent_data()
            x = out[name][0]
            y = b - A @ x
            g = np.linalg.norm(A.T @ (1.0 / y)) / (1 + np.linalg.norm(b))
            print(f"nonlinear {name} m={M_AC} n={N_AC}: min(b - Ax) "
                  f"{y.min():.3e} (> 0), |A'(1/(b-Ax))|/(1+|b|) {g:.3e} "
                  "(tol 1e-6)")
            check(y.min() > 0 and g <= 1e-6, f"nonlinear {name}: not the "
                  "analytic center")
        elif name == "cpl l+q+s+ball":
            c, G, h = lqs_lp(0)
            dims = ConeDims.from_dict(LQS_DIMS)
            x, znl, zl, sl = (host(sol[k]) for k in ("x", "znl", "zl", "sl"))
            rd = np.linalg.norm(c + 2.0 * znl[0] * x + G.T @ zl) / (
                1 + np.linalg.norm(c))
            rp = np.linalg.norm(G @ x + sl - h) / (1 + np.linalg.norm(h))
            ts_, tz_ = cones.max_step2(dims, sol["sl"][None],
                                       sol["zl"][None])
            print(f"nonlinear {name} n={N} l={L_S} q={list(Q_S)} "
                  f"s={list(S_S)}: znl {znl[0]!r} (> 1e-8: the ball is "
                  f"active), |x|^2 - r^2 {float(x @ x) - ball_radius2():.3e}, "
                  f"c + Df'znl + G'zl {rd:.3e}, Gx + sl - h {rp:.3e} (tol "
                  f"1e-6), max_step(sl) {float(ts_):.3e}, max_step(zl) "
                  f"{float(tz_):.3e} (<= 0)")
            check(znl[0] > 1e-8, f"nonlinear {name}: the ball is not active")
            check(rd < 1e-6 and rp < 1e-6,
                  f"nonlinear {name}: residuals too large")
            check(float(ts_) <= 0 and float(tz_) <= 0,
                  f"nonlinear {name}: sl or zl outside the cone")
        elif name == "gp userguide":
            hwd = np.exp(out[name][0])
            print(f"nonlinear {name}: h = {hwd[0]:f}, w = {hwd[1]:f}, "
                  f"d = {hwd[2]:f} (documented 2.8873, 5.7746, 11.5431)")
            check(np.allclose(hwd, [2.8873, 5.7746, 11.5431], rtol=1e-3),
                  f"nonlinear {name}: not the documented box")
        elif name == "gp seeded":
            K, F, g = gp_data()
            x = out[name][0]
            y = F @ x + g
            ofs = np.cumsum([0] + K)
            lse = [np.log(np.exp(y[i:j] - y[i:j].max()).sum()) + y[i:j].max()
                   for i, j in zip(ofs[:-1], ofs[1:])]
            print(f"nonlinear {name} n={N_GP} K=[{K[0]}]*{len(K)}: max "
                  f"constraint lse {max(lse[1:]):.3e} (<= 1e-7), objective "
                  f"{lse[0]!r}")
            check(max(lse[1:]) <= 1e-7 and abs(lse[0] - sol[
                "primal objective"]) <= 1e-6 * (1 + abs(lse[0])),
                f"nonlinear {name}: infeasible or objective wrong")
        elif name == "cp acent2":
            x = out[name][0]
            print(f"nonlinear {name}: x {x.tolist()}")
            check(np.abs(x).max() < 1.0, f"nonlinear {name}: x outside the "
                  "domain")
        stamp(f"phase 13 {name}")

    # oracle_from_function against the hand-coded f, Df and H
    Q, a = (torch.as_tensor(v, device=dev) for v in smooth_data())
    F = oracle_from_function(smooth_fn(Q, a), torch.zeros(
        N_OF, dtype=torch.float64, device=dev))
    g = torch.Generator().manual_seed(11)
    x = (0.3 * torch.randn(N_OF, generator=g, dtype=torch.float64)).to(dev)
    z = torch.rand(2, generator=g, dtype=torch.float64).to(dev) + 0.5
    err = max(float((u - v).abs().max() / (1 + v.abs().max()))
              for u, v in zip(F(x, z), smooth_by_hand(Q, a, x, z)))
    print(f"nonlinear oracle_from_function n={N_OF}: max |autodiff - by "
          f"hand| / (1 + |by hand|) over f, Df, H {err:.3e} (tol 1e-10)")
    check(err <= 1e-10, "oracle_from_function disagrees with the "
          "hand-coded derivatives")
    return out


def nonlinear_cpu():
    """Phase 13's solves on the CPU -> name -> (x, iterations, status,
    primal objective, seconds)."""
    from kvxopt_tpu_torch import config
    config.set_default_device("cpu")
    out = {}
    for name, fn in nonlinear_calls(torch.device("cpu")).items():
        t0 = time.perf_counter()
        sol = fn()
        out[name] = (sol["x"].numpy(), sol["iterations"], sol["status"],
                     sol["primal objective"], time.perf_counter() - t0)
    return out


def nonlinear_compare(pending, gpu):
    """Phase 13's solves on the card against the same calls on the CPU:
    the same status, iterations within 1, x within 1e-6 (1 + |x|), the
    primal objective within 1e-7 (1 + |obj|)."""
    try:
        cpu = pending.get()
    except Exception as e:  # noqa: BLE001  (the worker's error, reported)
        fail(f"nonlinear: the CPU solves raised {e!r}")
    for name, (xg, itg, stg, pg) in gpu.items():
        x, it, st, p, secs = cpu[name]
        dx = np.linalg.norm(xg - x) / (1 + np.linalg.norm(x))
        dp = abs(pg - p) / (1 + abs(p))
        print(f"nonlinear {name} cpu: {secs:.2f} s, status {st}, "
              f"iterations {it} (card {itg}), |x_gpu-x_cpu|/(1+|x_cpu|) "
              f"{dx:.3e} (tol 1e-6), objective {dp:.3e} (tol 1e-7)",
              flush=True)
        check(st == stg and abs(it - itg) <= 1 and dx <= 1e-6 and
              dp <= 1e-7, f"nonlinear {name}: differs from the CPU")


def sparse_rhs(n, complex_=False, seed=5):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, 2))
    return b + 1j * rng.standard_normal((n, 2)) if complex_ else b


def cholmod_sys(F, b):
    """solve(F, B, sys) for sys 0-8 on copies of b -> list of numpy."""
    from kvxopt_tpu_torch import cholmod, matrix
    out = []
    for s in range(9):
        B = matrix(b.copy())
        cholmod.solve(F, B, sys=s)
        out.append(np.asarray(B))
    return out


def cholmod_card(name, S, dev):
    """Phase 14(a) on one matrix: cholmod.symbolic once, numeric (the
    first call and a warm median of 3 refactorizations), solve; the
    factor's tensors on the card, the solve's relative residual below
    1e-8, P A P' = L L^H to 1e-10 relative -> (sys 0-8 outputs, times)."""
    import scipy.sparse as sp
    from kvxopt_tpu_torch import cholmod, matrix, spmatrix
    n = S.shape[0]
    As = spmatrix._from_csc(S)
    b = sparse_rhs(n, np.iscomplexobj(S.data))
    F = cholmod.symbolic(As)
    t0 = time.perf_counter()
    cholmod.numeric(As, F)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    check(F._device and F._X.device.type == "cuda",
          f"sparse {name}: the tile factor is not on the card")
    t = F._tile
    refac = warm_times(lambda: cholmod.numeric(As, F))
    solve = warm_times(lambda: cholmod.solve(F, matrix(b.copy())))
    X = torch.from_numpy(t.tiles_from_csc(sp.tril(S[F.perm][:, F.perm])
                                          .tocsc())).to(dev)
    pf = device_busy(lambda: t.factor_ex(X))
    outs = cholmod_sys(F, b)
    x = outs[0]
    res = np.linalg.norm(S @ x - b) / np.linalg.norm(b)
    L = np.asarray(cholmod.getfactor(F))
    PAP = S.toarray()[F.perm][:, F.perm]
    ferr = np.abs(L @ L.conj().T - PAP).max() / np.abs(PAP).max()
    print(f"sparse {name} n={n} lower nnz {sp.tril(S).nnz} dtype "
          f"{S.dtype}: tiles NT={t.NT} of T(T+1)/2={t.T * (t.T + 1) // 2} "
          f"(T={t.T}, ts={t.ts}, AMD order), first numeric {1e3 * first:.2f}"
          f" ms, refactorization on the card {1e3 * np.median(refac):.4f} ms"
          f" (min {1e3 * min(refac):.4f}, max {1e3 * max(refac):.4f}, 3 "
          f"warm), solve (2 rhs) {1e3 * np.median(solve):.4f} ms; one "
          f"factor_ex: {pf.launches} kernel launches, {pf.copies} copies, "
          f"{pf.device_text}; residual {res:.3e} (tol 1e-8), "
          f"|PAP' - LL^H|/|PAP| "
          f"{ferr:.3e} (tol 1e-10)", flush=True)
    check(res < 1e-8, f"sparse {name}: solve residual too large")
    check(ferr < 1e-10, f"sparse {name}: P A P' != L L^H")
    return outs, dict(refac=np.median(refac), solve=np.median(solve),
                      launches=pf.launches)


def scenario_batch(S, shift, dev, Bn=B_SP, npad=NPAD_SP, seed=0):
    """cfg_bcsstk's scenario batch (bench_configs.py:239-245) on the
    stand-in, made on the card: K = S padded to npad with shift on the pad
    diagonal, plus uniform(0, 1e-3) I per matrix; b standard normal ->
    (K (B, npad, npad), b (B, npad)), f64."""
    rng = np.random.default_rng(seed)
    n = S.shape[0]
    K = torch.zeros((npad, npad), dtype=torch.float64, device=dev)
    K[:n, :n] = torch.from_numpy(S.toarray()).to(dev)
    K.diagonal()[n:] = shift
    jit = torch.from_numpy(rng.uniform(0, 1e-3, Bn)).to(dev)
    Ks = K + jit[:, None, None] * torch.eye(npad, dtype=K.dtype, device=dev)
    return Ks, torch.from_numpy(rng.standard_normal((Bn, npad))).to(dev)


def rel_res(K, x, b):
    """max over the batch of |K x - b| / |b|, in f64."""
    r = torch.einsum("bij,bj->bi", K, x.double()) - b.double()
    return float((r.norm(dim=-1) / b.double().norm(dim=-1)).max())


def scenario_routes(S, shift, dev):
    """Phase 14(b): the tile route (one batched TileCholesky factor of the
    16 matrices in f64, natural order, then 2 solves) and cfg_bcsstk's
    dense route (ops.best_chol_factor_solve on K padded to 2048 in f32:
    K1, then K2 twice), with residuals and ms per matrix; K1's and K2's
    launches counted over one driven run of the dense route, whose factor
    and solves are then held against their plain versions on the same
    inputs (K1 as in phase 1; K2 to 1e-5 relative)."""
    import scipy.sparse as sp
    from kvxopt_tpu_torch import ops
    from kvxopt_tpu_torch.ops import best_chol_factor_solve, chol_ls as cl
    from kvxopt_tpu_torch.ops.tile_chol import (TileCholesky,
                                                tile_pattern_from_sparse)
    n = S.shape[0]
    Ks, bs = scenario_batch(S, shift, dev)
    Bn, npad = Ks.shape[:2]
    tile = TileCholesky(tile_pattern_from_sparse(sp.csc_matrix(S), TS_SP),
                        n, TS_SP)
    X = tile.tiles_from_dense(Ks[:, :n, :n])
    check(X.shape == (Bn, tile.NT, TS_SP, TS_SP) and X.is_cuda,
          "sparse scenarios: tiles not (B, NT, 128, 128) on the card")

    def tile_route():
        L = tile.factor(X)
        y = tile.solve(L, bs[:, :n])
        return y, tile.solve(L, y)

    K32, b32 = Ks.float(), bs.float()

    def dense_route():
        f, solve = best_chol_factor_solve(K32)
        y = solve(f, b32)
        return f, y, solve(f, y)

    y, x = tile_route()
    rt = max(rel_res(Ks[:, :n, :n], y, bs[:, :n]),
             rel_res(Ks[:, :n, :n], x, y))
    torch.cuda.synchronize()
    ops.reset_launches()
    f, y, x = dense_route()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(launches["K1"] >= 1 and launches["K2"] >= 2,
          "sparse scenarios: K1 or K2 did not run on the dense route")
    L, Dinv = f
    k1_agrees(f"sparse scenarios K1 B={Bn} n={npad}", K32, L, Dinv)
    for r, out in ((b32, y), (y, x)):
        xr = cl.chol_solve_ls_ref(L, Dinv, r)
        rel = float((out - xr).abs().max() / xr.abs().max())
        print(f"sparse scenarios K2 B={Bn} n={npad} k=1: "
              f"max|x-xref|/max|xref|={rel:.3e} (tol 1e-5)")
        check(rel < 1e-5, "sparse scenarios: K2 disagrees with plain")
    rd = max(rel_res(Ks, y, bs), rel_res(Ks, x, y))
    tt, td = warm_times(tile_route), warm_times(dense_route)
    pf = device_busy(tile_route)
    print(f"sparse scenarios B={Bn}: tile route f64 natural order NT="
          f"{tile.NT} of {tile.T * (tile.T + 1) // 2}, factor + 2 solves "
          f"{1e3 * np.median(tt) / Bn:.4f} ms per matrix (median of 3 "
          f"warm batches; {pf.launches} kernel launches, {pf.copies} copies,"
          f" {pf.device_text} per batch), residual {rt:.3e} (tol 1e-8); "
          f"dense route "
          f"f32 n={npad} (K1 + 2 K2) {1e3 * np.median(td) / Bn:.4f} ms "
          f"per matrix, residual {rd:.3e} (tol 1e-4), launches in one run "
          f"{launches}", flush=True)
    check(rt < 1e-8, "sparse scenarios: tile route residual too large")
    check(rd < 1e-4, "sparse scenarios: dense route residual too large")
    return launches


def sparse_lp_card(S, dev):
    """Phase 14(c): conelp with tile_kktsolver on the card (the analysis
    once, outside the loop) against the same LP through conelp's default
    chol2 on the card: optimal, residuals below 1e-6, x within 1e-6
    (1 + |x|); warm median of 3, iterations, busy share, host syncs per
    iteration -> (x, iterations, status)."""
    from kvxopt_tpu_torch import solvers
    n = S.shape[0]
    c, G, h = (torch.from_numpy(a).to(dev) for a in sparse_lp(S))
    dims = {"l": 3 * n}
    tile = kkt_tiles(S)
    kkt = tile_kktsolver(G[:n], tile)

    def run():
        return solvers.conelp(c, G, h, dims, kktsolver=kkt)

    def ref():
        return solvers.conelp(c, G, h, dims)

    sol, chol2 = run(), ref()
    on_card("sparse lp", sol["x"], sol["z"])
    ts, tr = warm_times(run), warm_times(ref)
    pf = device_busy(run)
    syncs = count_syncs(run)
    it = max(1, sol["iterations"])
    x, s, z = (sol[k].cpu().numpy() for k in ("x", "s", "z"))
    xr = chol2["x"].cpu().numpy()
    cn, Gn, hn = (a.cpu().numpy() for a in (c, G, h))
    rd = np.linalg.norm(Gn.T @ z + cn) / (1 + np.linalg.norm(cn))
    rp = np.linalg.norm(Gn @ x + s - hn) / (1 + np.linalg.norm(hn))
    dx = np.linalg.norm(x - xr) / (1 + np.linalg.norm(xr))
    print(f"sparse lp n={n} m={3 * n}, K tiles NT={tile.NT} of "
          f"{tile.T * (tile.T + 1) // 2}: status {sol['status']}, iterations "
          f"{sol['iterations']}, warm median {1e3 * np.median(ts):.2f} ms "
          f"(min {1e3 * min(ts):.2f}, max {1e3 * max(ts):.2f}, 3 calls); "
          f"chol2 {chol2['status']}, {chol2['iterations']} iterations, "
          f"{1e3 * np.median(tr):.2f} ms; residuals G'z+c {rd:.3e}, "
          f"Gx+s-h {rp:.3e} (tol 1e-6); |x - x_chol2|/(1+|x_chol2|) "
          f"{dx:.3e} (tol 1e-6)", flush=True)
    print(f"sparse lp profile (profiler on): wall {pf.wall:.4f} s, "
          f"{pf.busy_text}; host syncs {syncs} in one call, "
          f"{syncs / it:.1f} per iteration", flush=True)
    check(sol["status"] == chol2["status"] == "optimal",
          "sparse lp: not optimal")
    check(rd < 1e-6 and rp < 1e-6, "sparse lp: residuals too large")
    check(dx <= 1e-6, "sparse lp: x differs from chol2's")
    return x, sol["iterations"], sol["status"]


def sparse(dev):
    """Phase 14, "sparse": (a) cholmod's tile path on the card, the
    stand-in and a small Hermitian case; (b) the scenario batch of
    cfg_bcsstk on the tile and the dense routes; (c) the sparse-KKT LP.
    Returns (the card's results for sparse_compare, K1/K2 launches of
    (b))."""
    from kvxopt_tpu_torch import cholmod, native
    print(f"sparse: host compiler {sh(['which', 'g++'])}: "
          f"{sh(['g++', '--version']).splitlines()[0]}", flush=True)
    old = dict(cholmod.options)
    cholmod.options.update({"supernodal": 2, "device": "auto",
                            "tilesize": TS_SP})
    try:
        S, shift = stiffness_standin(0)
        gpu = {"d": cholmod_card("cholmod stand-in", S, dev)}
        print(f"sparse: native host library {native._build()}", flush=True)
        Z, _ = stiffness_standin(1, N_SPZ, NNZ_SPZ, complex_=True)
        gpu["z"] = cholmod_card("cholmod hermitian", Z, dev)
    finally:
        cholmod.options.clear()
        cholmod.options.update(old)
    stamp("phase 14(a)")
    launches = scenario_routes(S, shift, dev)
    stamp("phase 14(b)")
    gpu["lp"] = sparse_lp_card(S, dev)
    return gpu, launches


def sparse_cpu():
    """Phase 14's CPU side: cholmod's host LDL' (options['device'] False)
    on the stand-in (sys 0-8, the refactorization's median of 3) and on
    the Hermitian case, scipy splu factor + 2 solves on the stand-in, and
    phase 14(c)'s LP with tile_kktsolver on CPU tensors."""
    import scipy.sparse.linalg as spla
    from kvxopt_tpu_torch import cholmod, solvers, spmatrix
    out = {}
    cholmod.options.update({"supernodal": 2, "device": False})
    S, _ = stiffness_standin(0)
    for key, M in (("d", S), ("z", stiffness_standin(1, N_SPZ, NNZ_SPZ,
                                                      complex_=True)[0])):
        As = spmatrix._from_csc(M)
        F = cholmod.symbolic(As)
        cholmod.numeric(As, F)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            cholmod.numeric(As, F)
            ts.append(time.perf_counter() - t0)
        out[key] = (cholmod_sys(F, sparse_rhs(M.shape[0],
                                              np.iscomplexobj(M.data))),
                    float(np.median(ts)))
    b = sparse_rhs(S.shape[0])[:, 0]
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        lu = spla.splu(S.tocsc())
        lu.solve(lu.solve(b))
        ts.append(time.perf_counter() - t0)
    out["splu"] = float(np.median(ts))
    n = S.shape[0]
    c, G, h = (torch.from_numpy(a) for a in sparse_lp(S))
    t0 = time.perf_counter()
    sol = solvers.conelp(c, G, h, {"l": 3 * n}, kktsolver=tile_kktsolver(
        G[:n], kkt_tiles(S)))
    out["lp"] = (sol["x"].numpy(), sol["iterations"], sol["status"],
                 time.perf_counter() - t0)
    return out


def sparse_compare(pending, gpu):
    """Phase 14 against the CPU: every sys code 0-8 of the tile path on
    the card within 1e-8 relative of the host LDL'; the LP's status, its
    iterations within 1 and x within 1e-6 (1 + |x|)."""
    try:
        cpu = pending.get()
    except Exception as e:  # noqa: BLE001  (the worker's error, reported)
        fail(f"sparse: the CPU side raised {e!r}")
    for key in ("d", "z"):
        outs, stats = gpu[key]
        host, refac = cpu[key]
        err = max(np.abs(g - h).max() / np.abs(h).max()
                  for g, h in zip(outs, host))
        print(f"sparse cholmod {key}: sys 0-8, card tile path against host "
              f"LDL' max relative {err:.3e} (tol 1e-8); refactorization "
              f"card {1e3 * stats['refac']:.4f} ms, host LDL' "
              f"{1e3 * refac:.4f} ms" + (
                  f", scipy splu factor + 2 solves {1e3 * cpu['splu']:.4f} ms"
                  if key == "d" else "") + " (CPU numbers from the worker, "
              "beside the card's phases)", flush=True)
        check(err < 1e-8, f"sparse cholmod {key}: differs from host LDL'")
    (xg, itg, stg), (x, it, st, secs) = gpu["lp"], cpu["lp"]
    dx = np.linalg.norm(xg - x) / (1 + np.linalg.norm(x))
    print(f"sparse lp cpu: {secs:.2f} s, status {st}, iterations {it} (card "
          f"{itg}), |x_gpu-x_cpu|/(1+|x_cpu|) {dx:.3e} (tol 1e-6)", flush=True)
    check(st == stg and abs(it - itg) <= 1 and dx <= 1e-6,
          "sparse lp: differs from the CPU")


@contextlib.contextmanager
def spy(module, name):
    """Inside the block, module.name's calls go through and their results
    are kept, in order, in the list the block gets."""
    fn, seen = getattr(module, name), []

    def wrapper(*args, **kwargs):
        seen.append(fn(*args, **kwargs))
        return seen[-1]
    setattr(module, name, wrapper)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def solve_recorded(prob, **kwargs):
    """prob.solve(**kwargs) as a user calls it -> the result dictionary of
    the solvers.lp call it makes (op.solve keeps only the status)."""
    from kvxopt_tpu_torch import solvers
    with spy(solvers, "lp") as seen:
        prob.solve(**kwargs)
    return seen[0]


def pwl_data(m=M_PWL, n=N_PWL, seed=0):
    """Phase 15(a)'s seeded data: A (m, n) and b (m, 1) standard normal,
    u (m, 1) uniform(0, 1), c (n, 1) standard normal, as
    examples/normappr.py and roblp.py draw them with gsl."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)), rng.standard_normal((m, 1)),
            rng.uniform(size=(m, 1)), rng.standard_normal((n, 1)))


def mps_exact(a):
    """a's entries as the MPS writer prints them (% 7.5E, six significant
    digits), so that a file holds the problem exactly."""
    return np.array([float("%.5E" % v) for v in a.ravel()]).reshape(a.shape)


def pwl_models(m=M_PWL, n=N_PWL, seed=0, exact=False):
    """name -> (op, its variables): examples/normappr.py's three problems
    (max|Ax+b|, sum|Ax+b|, the dead-zone penalty) and examples/roblp.py's
    two (A x + sum|x| <= u in PWL form and with the auxiliary y), built
    through matrix from pwl_data (through mps_exact where exact)."""
    from kvxopt_tpu_torch import matrix
    from kvxopt_tpu_torch import modeling as md
    An, bn, un, cn = (mps_exact(a) if exact else a
                      for a in pwl_data(m, n, seed))
    A, b, u, c = matrix(An), matrix(bn), matrix(un), matrix(cn)
    out = {}
    for name, f in (
            ("normappr inf", lambda r: md.max(abs(r))),
            ("normappr l1", lambda r: md.sum(abs(r))),
            ("normappr deadzone", lambda r: md.sum(md.max(
                0, abs(r) - 0.75, 2 * abs(r) - 2.25)))):
        x = md.variable(n)
        out[name] = (md.op(f(A * x + b)), [x])
    x = md.variable(n)
    out["roblp pwl"] = (md.op(md.dot(c, x), A * x + md.sum(abs(x)) <= u),
                        [x])
    x, y = md.variable(n), md.variable(n)
    out["roblp aux"] = (md.op(md.dot(c, x), [A * x + md.sum(y) <= u,
                                             -y <= x, x <= y]), [x, y])
    return out


def osqp_problem(n=N_OSQP, m=M_OSQP, seed=0):
    """Phase 15(c)'s strongly convex QP with a budget row: P = F'F/n +
    0.1 I with F (n, n) standard normal, q standard normal, G (m, n)
    standard normal, h = G x0 + uniform(0.5, 1.5) with x0 = 1/n, and
    A = 1', b = 1 (x0 is strictly feasible)."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, n))
    P = F.T @ F / n + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    h = G @ np.full(n, 1.0 / n) + rng.uniform(0.5, 1.5, m)
    return P, q, G, h, np.ones((1, n)), np.ones(1)


# tests/test_modeling.py's integer-marker MPS: x1 integer, x2 continuous;
# the optimum is x = (5, 0.5)
INT_MPS = """NAME          INTTEST
ROWS
 N  cost
 L  R1
COLUMNS
    MARKER0  'MARKER'  'INTORG'
    X1  cost  -1.0  R1  2.0
    MARKER1  'MARKER'  'INTEND'
    X2  cost  -1.0  R1  3.0
RHS
    R1  11.5
BOUNDS
 UP  BND  X1  10.0
 UP  BND  X2  2.9
ENDATA
"""


def scratch_dir():
    """A temporary directory inside the checkout's ignored build folder."""
    import tempfile
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "kvxopt_tpu_torch", "build")
    os.makedirs(root, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=root)


def modeling(dev):
    """Phase 15, "modeling": (a) the PWL models of pwl_models through
    op.solve() on the card; (b) an MPS round trip and an integer-marker
    MPS through op.solve() to glpk.ilp; (c) qp(solver='osqp') on
    osqp_problem and lp(solver='osqp') on (a)'s max|Ax+b| LP; (d) the
    DSDP bridge on the userguide SDP.  Returns the card's results for
    modeling_compare."""
    from kvxopt_tpu_torch import dsdp, osqp, solvers
    from kvxopt_tpu_torch import modeling as md, ops

    def host(t):
        return t.detach().cpu().numpy()

    gpu = {}
    for name, (prob, xs) in pwl_models().items():
        torch.cuda.synchronize()
        ops.reset_launches()
        sol = solve_recorded(prob)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        on_card(f"modeling {name}", *(sol[k] for k in "xysz"))
        check(sol["status"] == prob.status == "optimal",
              f"modeling {name}: status {prob.status}")
        check(not any(launches[k] for k in F32_KERNELS),
              f"modeling {name}: a kernel of K1-K4 ran on the f64 path")
        values = [np.asarray(v.value).ravel() for v in xs]
        objective = float(prob.objective.value()[0])
        s, z = host(sol["s"]), host(sol["z"])
        comp = float(s @ z) / (1 + abs(sol["primal objective"]))
        t0 = time.perf_counter()
        G = prob._build_lp()[2]
        build = time.perf_counter() - t0
        ts = warm_times(prob.solve)
        pf = device_busy(prob.solve)
        syncs = count_syncs(prob.solve)
        it = max(1, sol["iterations"])
        print(f"modeling {name} (m={M_PWL}, n={N_PWL}; canonical LP "
              f"{G.shape[1]} variables, {G.shape[0]} inequalities): status "
              f"{prob.status}, iterations {sol['iterations']}, objective "
              f"{objective!r}, op.solve warm median "
              f"{1e3 * np.median(ts):.2f} ms (min {1e3 * min(ts):.2f}, max "
              f"{1e3 * max(ts):.2f}, 3 calls), _build_lp "
              f"{1e3 * build:.2f} ms, kernel launches {launches}",
              flush=True)
        print(f"modeling {name} profile (profiler on): wall {pf.wall:.4f} "
              f"s, {pf.busy_text}; host syncs {syncs} in one call, "
              f"{syncs / it:.1f} per iteration; min z {z.min():.3e} (>= 0), "
              f"s'z/(1+|pcost|) {comp:.3e} (tol 1e-6)", flush=True)
        check(z.min() >= 0 and s.min() >= 0 and comp <= 1e-6,
              f"modeling {name}: multipliers negative or complementarity "
              "too large")
        gpu[name] = (prob.status, sol["iterations"], values, objective)
        stamp(f"phase 15(a) {name}")

    # (b) an MPS round trip at the example's size, on data the file holds
    # exactly, and integer markers
    prob, _ = pwl_models(200, 50, exact=True)["roblp pwl"]
    prob.solve()
    check(prob.status == "optimal", "modeling mps: roblp not optimal")
    obj = float(prob.objective.value()[0])
    with scratch_dir() as d:
        path = os.path.join(d, "roblp.mps")
        prob.tofile(path)
        size = os.path.getsize(path)
        back = md.op()
        back.fromfile(path)
        back.solve()
        path = os.path.join(d, "int.mps")
        with open(path, "w") as f:
            f.write(INT_MPS)
        ilp = md.op()
        ilp.fromfile(path)
        ilp.solve()
    obj2 = float(back.objective.value()[0])
    xi = np.asarray(ilp.variables()[0].value).ravel()
    print(f"modeling mps: roblp (m=200, n=50) tofile {size} bytes, fromfile "
          f"and op.solve on the card: status {back.status}, objective "
          f"{obj2!r} against {obj!r} ({abs(obj2 - obj) / abs(obj):.3e}, "
          f"tol 1e-8); integer-marker MPS through glpk.ilp: status "
          f"{ilp.status}, x {xi.tolist()} (expected [5.0, 0.5])", flush=True)
    check(back.status == "optimal" and abs(obj2 - obj) <= 1e-8 * abs(obj),
          "modeling mps: the read-back problem differs")
    check(ilp.status == "optimal" and np.abs(xi - [5.0, 0.5]).max() <= 1e-6,
          "modeling mps: the integer-marker problem's x")
    stamp("phase 15(b)")

    # (c) OSQP on the card
    P, q, G, h, A, b = osqp_problem()

    def qp_osqp(options=None):
        return solvers.qp(P, q, G, h, A, b, solver="osqp", options=options)
    ops.reset_launches()
    with spy(osqp, "_admm_core") as seen:
        sol = qp_osqp()
    torch.cuda.synchronize()
    it = int(seen[0][3])
    check(seen[0][0].device.type == "cuda", "modeling osqp: not on the card")
    check(not any(ops.LAUNCHES[k] for k in F32_KERNELS),
          "modeling osqp: a kernel of K1-K4 ran")
    ts = warm_times(qp_osqp)
    syncs = count_syncs(qp_osqp)
    # the profiled call stops at OSQP_PROFILED iterations: a trace of the
    # whole solve holds ~100k kernels and takes long to read
    pf = device_busy(lambda: qp_osqp({"osqp": {"max_iter": OSQP_PROFILED}}))
    wall = float(np.median(ts))
    x = np.asarray(sol["x"]).ravel()
    print(f"modeling osqp qp n={N_OSQP} m={M_OSQP}+1: status "
          f"{sol['status']}, iterations {it}, primal objective "
          f"{sol['primal objective']!r}, warm median {1e3 * wall:.2f} ms "
          f"(min {1e3 * min(ts):.2f}, max {1e3 * max(ts):.2f}, 3 calls), "
          f"{1e3 * wall / max(1, it):.4f} ms per iteration; host syncs "
          f"{syncs} in one call (chunks of {osqp.CHUNK}); profile of "
          f"{OSQP_PROFILED} iterations: wall {pf.wall:.4f} s, "
          f"{pf.busy_text}", flush=True)
    if sol["status"] == "optimal":
        ref = solvers.qp(P, q, G, h, A, b)
        d = abs(sol["primal objective"] - ref["primal objective"]) / abs(
            ref["primal objective"])
        print(f"modeling osqp qp: native qp status {ref['status']}, "
              f"iterations {ref['iterations']}, objective "
              f"{ref['primal objective']!r}; relative difference {d:.3e} "
              "(tol 1e-4)", flush=True)
        check(ref["status"] == "optimal" and d <= 1e-4,
              "modeling osqp: objective differs from the native qp")
    gpu["osqp"] = (sol["status"], it, x)
    cvec, _, Gl, hl = pwl_models()["normappr inf"][0]._build_lp()[:4]
    with spy(osqp, "_admm_core") as seen:
        lo = solvers.lp(cvec, Gl, hl, solver="osqp")
    nat = solvers.lp(cvec, Gl, hl)
    print(f"modeling osqp lp (normappr inf, {Gl.shape[1]} variables, "
          f"{Gl.shape[0]} inequalities): status {lo['status']}, iterations "
          f"{int(seen[0][3])}, objective {lo.get('primal objective')!r}; "
          f"native lp status {nat['status']}, iterations "
          f"{nat['iterations']}, objective {nat['primal objective']!r}",
          flush=True)
    stamp("phase 15(c)")

    # (d) the DSDP bridge against the native sdp on the card: dsdp.sdp at
    # its default gap tolerance (1e-5) and at the 1e-8 that
    # sdp(solver='dsdp') sets, and the route itself
    c, Gs, hs = userguide_data()[2]
    nat = solvers.sdp(c, Gs=Gs, hs=hs)
    on_card("modeling sdp", nat["x"])
    pn = nat["primal objective"]
    print(f"modeling dsdp: native sdp on the card {nat['status']}, "
          f"objective {pn!r}", flush=True)
    check(nat["status"] == "optimal", "modeling dsdp: native sdp status")
    for label, tol, call in (
            ("dsdp.sdp", 1e-5, lambda: dsdp.sdp(c, None, None, Gs, hs)),
            ("dsdp.sdp DSDP_GapTolerance 1e-8", 1e-6, lambda: dsdp.sdp(
                c, None, None, Gs, hs, options={"DSDP_GapTolerance": 1e-8})),
            ("sdp(solver='dsdp')", 1e-6, lambda: solvers.sdp(
                c, Gs=Gs, hs=hs, solver="dsdp"))):
        out = call()
        if isinstance(out, dict):
            status, obj = out["status"], out["primal objective"]
        else:
            status, obj = out[0], float(c @ np.asarray(out[1]).ravel())
        err = abs(obj - pn) / abs(pn)
        print(f"modeling dsdp: {label} {status}, objective {obj!r}, "
              f"relative to the native sdp {err:.3e} (tol {tol:g})",
              flush=True)
        check(status in ("optimal", "DSDP_PDFEASIBLE") and err <= tol,
              f"modeling dsdp: {label} differs from the native sdp")
    return gpu


def modeling_cpu():
    """Phase 15's CPU side: (a)'s models through op.solve() on the CPU
    and with solver='glpk' (HiGHS), and (c)'s OSQP solve on the CPU ->
    name -> results and seconds."""
    from kvxopt_tpu_torch import config, osqp, solvers
    config.set_default_device("cpu")
    out = {}
    for name, (prob, xs) in pwl_models().items():
        t0 = time.perf_counter()
        sol = solve_recorded(prob)
        secs = time.perf_counter() - t0
        values = [np.asarray(v.value).ravel() for v in xs]
        objective = float(prob.objective.value()[0])
        t0 = time.perf_counter()
        prob.solve(solver="glpk")
        out[name] = (sol["status"], sol["iterations"], values, objective, secs,
                     prob.status, float(prob.objective.value()[0]),
                     time.perf_counter() - t0)
    P, q, G, h, A, b = osqp_problem()
    t0 = time.perf_counter()
    with spy(osqp, "_admm_core") as seen:
        sol = solvers.qp(P, q, G, h, A, b, solver="osqp")
    out["osqp"] = (sol["status"], int(seen[0][3]),
                   np.asarray(sol["x"]).ravel(), time.perf_counter() - t0)
    return out


def modeling_compare(pending, gpu):
    """Phase 15 against the CPU: per model the same status, iterations
    within 1, every variable within 1e-7 (1 + |value|), and the objective
    within 1e-6 relative of HiGHS's (solver='glpk'); OSQP the same status,
    iterations within 2 and x within 1e-6 relative."""
    try:
        cpu = pending.get()
    except Exception as e:  # noqa: BLE001  (the worker's error, reported)
        fail(f"modeling: the CPU side raised {e!r}")
    for name, card in gpu.items():
        if name == "osqp":
            continue
        stg, itg, vg, og = card
        st, it, v, o, secs, gst, go, gsecs = cpu[name]
        dv = max(np.linalg.norm(a - b) / (1 + np.linalg.norm(b))
                 for a, b in zip(vg, v))
        dg = abs(og - go) / max(1.0, abs(go))
        print(f"modeling {name} cpu: {secs:.2f} s, status {st}, iterations "
              f"{it} (card {itg}), |value_gpu-value_cpu|/(1+|value_cpu|) "
              f"{dv:.3e} (tol 1e-7); HiGHS (solver='glpk') {gsecs:.2f} s, "
              f"status {gst}, objective {go!r}, card's objective against it "
              f"{dg:.3e} (tol 1e-6)", flush=True)
        check(st == stg and abs(it - itg) <= 1 and dv <= 1e-7,
              f"modeling {name}: differs from the CPU")
        check(gst == "optimal" and dg <= 1e-6,
              f"modeling {name}: objective differs from HiGHS's")
    stg, itg, xg = gpu["osqp"]
    st, it, x, secs = cpu["osqp"]
    dx = np.linalg.norm(xg - x) / np.linalg.norm(x)
    print(f"modeling osqp cpu: {secs:.2f} s, status {st}, iterations {it} "
          f"(card {itg}), |x_gpu-x_cpu|/|x_cpu| {dx:.3e} (tol 1e-6)",
          flush=True)
    check(st == stg and abs(it - itg) <= 2 and dx <= 1e-6,
          "modeling osqp: differs from the CPU")


# phase 16, "seq and misc": the sequential batch driver with chol2_mixed's
# per-lane f64 fallback; misc on the card; options['profile']
SEQ_CUT_S = 60.0    # a first group=1 run longer than this times lanes 0-7


def lane_fallbacks(seq, args):
    """Per lane, (iterations, K1 factorizations, factorizations that took
    the f64 fallback): each lane solved alone through `seq`, K1's
    launches read from its count and the route's f64 factors counted by
    wrapping kkt.chol_factor, which K1's factors pass too (on the orthant
    without equality rows the mixed strategy factors in f64 only for the
    fallback)."""
    from kvxopt_tpu_torch import kkt, ops
    plain = kkt.chol_factor
    calls = [0]

    def counted(K):
        calls[0] += K.dtype == torch.float64
        return plain(K)

    kkt.chol_factor = counted
    try:
        out = []
        for i in range(args[1].shape[0]):
            calls[0] = 0
            k1 = ops.LAUNCHES["K1"]
            st = seq(*(a[i:i + 1] for a in args))
            out.append((int(st[4][0]), ops.LAUNCHES["K1"] - k1, calls[0]))
    finally:
        kkt.chol_factor = plain
    return out


def path_inputs(run):
    """The inputs that `run` gives K1, K2 and K3 (ops.chol_ls's wrappers,
    which ops.ipm_chol calls through the module): the first call's
    arguments for each (kernel, B, n, k), cloned."""
    from kvxopt_tpu_torch.ops import chol_ls as cl
    names = {"K1": "batched_cholesky_ls", "K2": "chol_solve_ls",
             "K3": "tri_solve_ls"}
    plain = {k: getattr(cl, f) for k, f in names.items()}
    seen = {}

    def capture(kname):
        def wrapped(*a, **kw):
            t = a[0] if kname == "K1" else a[-1]
            key = (kname, t.shape[0], t.shape[1],
                   t.shape[2] if t.ndim == 3 and kname != "K1" else 0)
            if key not in seen:
                seen[key] = tuple(x.clone() for x in a)
            return plain[kname](*a, **kw)
        return wrapped

    for k, f in names.items():
        setattr(cl, f, capture(k))
    try:
        run()
    finally:
        for k, f in names.items():
            setattr(cl, f, plain[k])
    return seen


def seq_kernels_agree(seq1, seq2, args):
    """K1-K3 at the shapes and on the inputs that the sequential driver
    gives them (lane 0 through group=1, lanes 0-1 through group=2),
    against their plain versions at phase 1's tolerances: K1 with
    k1_agrees, K2 1e-5 relative, K3 in both modes 1e-4 of max|xref|+1."""
    from kvxopt_tpu_torch.ops import chol_ls as cl
    seen = path_inputs(lambda: seq1(*(a[:1] for a in args)))
    seen.update(path_inputs(lambda: seq2(*(a[:2] for a in args))))
    print(f"seq kernel inputs (kernel, B, n, k): {sorted(seen)}")
    for Bn in (1, 2):
        check(("K1", Bn, N, 0) in seen, f"seq: no K1 input at B={Bn}")
    for (kname, Bn, n, k), a in sorted(seen.items()):
        label = f"seq {kname} B={Bn} n={n} k={k}"
        if kname == "K1":
            L, Dinv = cl.batched_cholesky_ls(a[0])
            k1_agrees(label, a[0], L, Dinv)
            continue
        modes = (False,) if kname == "K2" else (False, True)
        for trans in modes:
            if kname == "K2":
                x, xr = cl.chol_solve_ls(*a), cl.chol_solve_ls_ref(*a)
            else:
                x = cl.tri_solve_ls(*a, trans=trans)
                xr = cl.tri_solve_ls_ref(*a, trans=trans)
            torch.cuda.synchronize()
            err = float((x - xr).abs().max())
            scale, tol = ((float(xr.abs().max()), 1e-5) if kname == "K2"
                          else (float(xr.abs().max()) + 1.0, 1e-4))
            print(f"{label} trans={trans}: max|x-xref|/"
                  f"{'max|xref|' if kname == 'K2' else '(max|xref|+1)'}="
                  f"{err / scale:.3e} (tol {tol:g})")
            check(err / scale < tol, f"{label}: disagrees with plain")


def seq_checks(name, out, data, x3):
    """Every lane optimal, KKT residuals below 1e-6 and x within 1e-6
    (1 + |x|) of phase 3's."""
    from kvxopt_tpu_torch.convert import state_to_numpy
    x, _, s, z, it, status, _ = state_to_numpy(out)
    print(f"{name}: status {status.tolist()}, iterations {it.tolist()}")
    check((status == 1).all(), f"{name}: not every lane optimal")
    res = residuals(*data[:4], x, s, z)
    dx = np.linalg.norm(x - x3[:len(x)], axis=1) / (
        1 + np.linalg.norm(x3[:len(x)], axis=1))
    print(f"{name} max residuals: stationarity {res[0].max():.3e}, Gx+s=h "
          f"{res[1].max():.3e} (tol 1e-6); max |x-x3|/(1+|x3|) "
          f"{dx.max():.3e} (tol 1e-6)")
    check(all(r.max() < 1e-6 for r in res), f"{name}: residuals too large")
    check(dx.max() <= 1e-6, f"{name}: x differs from phase 3's")


def seq_profile(seq, args):
    """One lane through `seq` under the profiler: device busy share, K1-K3's
    device ms and launches, and the kernels that take the most time."""
    wall, kern, _, _, why = trace(lambda: seq(*(a[:1] for a in args)))
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    if why or busy == 0:
        print(f"seq profile lane 0: device time not measured "
              f"({why or 'no device events'})")
        return
    print(f"seq profile lane 0 (profiler on): wall {wall:.4f} s, device "
          f"busy {busy:.4f} s ({100 * busy / wall:.1f}%)")
    for kname, keys in (("K1", K1_KEYS), ("K2", K2_KEYS),
                        ("K3", ("tri_kernel",))):
        mine = [e for e in kern if any(k in e.key.lower() for k in keys)]
        t = sum(e.self_device_time_total for e in mine) / 1e3
        print(f"seq profile lane 0: {kname} {t:.3f} ms in "
              f"{sum(e.count for e in mine)} launches "
              f"({100 * t / 1e3 / busy:.2f}% of device busy time)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def seq_driver(dev, x3, walls3):
    """Phase 16(a): batched_qp_solver_seq (chol2_mixed, group=1, then
    group=2) on phase 3's 16 problems.  Returns the group=1 run's kernel
    launches, its counts set to 0 just before it and read just after."""
    from kvxopt_tpu_torch import ops
    from kvxopt_tpu_torch.convert import problem_to_torch
    from kvxopt_tpu_torch.parallel import batched_qp_solver_seq
    dims, data = slice_data("slice")
    args = problem_to_torch(*data, device=dev, dtype=torch.float64)
    seq1 = batched_qp_solver_seq(dims)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = seq1(*args)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches, shapes = dict(ops.LAUNCHES), dict(ops.LAUNCH_SHAPES)
    print(f"seq group=1 first run on {B} lanes: {first:.4f} s")
    print(f"seq group=1 launches during the solve: {launches}")
    print(f"seq group=1 launches by (kernel, n, k): {sorted(shapes.items())}")
    seq_checks("seq group=1", out, data, x3)
    at_n = {k for (k, n, _), c in shapes.items() if n == N and c}
    check({"K1", "K2", "K3"} <= at_n,
          f"seq: K1-K3 not all launched at n={N} ({sorted(at_n)})")
    for i, (it, k1, fb) in enumerate(lane_fallbacks(seq1, args)):
        print(f"seq lane {i}: iterations {it}, f64 fallback in {fb} of "
              f"{k1} K1 factorizations")
        check(fb < k1, f"seq lane {i}: every K1 factorization fell back")
    lanes = B
    if first > SEQ_CUT_S:
        lanes = B // 2
        print(f"seq: cut to lanes 0-{lanes - 1} for the timed runs "
              f"(first run over {SEQ_CUT_S:.0f} s)")
    args = tuple(a[:lanes] for a in args)
    data = tuple(a[:lanes] for a in data)
    t1 = warm_times(lambda: seq1(*args))
    seq2 = batched_qp_solver_seq(dims, group=2)
    seq_checks("seq group=2", seq2(*args), data, x3)
    seq_kernels_agree(seq1, seq2, args)
    t2 = warm_times(lambda: seq2(*args))
    print(f"seq walls on {lanes} lanes, warm median of 3: group=1 "
          f"{np.median(t1):.4f} s {['%.4f' % t for t in t1]}, group=2 "
          f"{np.median(t2):.4f} s {['%.4f' % t for t in t2]}; phase 3 on "
          f"{B} lanes: two-pass {walls3['two-pass']:.4f} s, pass 1 alone "
          f"{walls3['pass 1']:.4f} s, pass 2 alone {walls3['pass 2']:.4f} s")
    seq_profile(seq1, args)
    return launches


def rel_err(a, b):
    """max |a - b| over max |b| (a and b tensors or floats)."""
    a, b = (torch.as_tensor(v, dtype=torch.float64).cpu() for v in (a, b))
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def misc_calls(s, z, u, W=None, lam=None):
    """misc's vector functions on s, z and u (all on one device), with the
    scaling W, lambda computed from (s, z) unless given: {name: result};
    r and rti, free up to the sign of each singular vector, as r r'."""
    from kvxopt_tpu_torch import misc
    d = LQS_DIMS
    pk = misc.pack(s, d)
    out = {"pack": pk, "unpack": misc.unpack(pk, d),
           "sdot": misc.sdot(s, z, d), "snrm2": misc.snrm2(s, d)}
    Wc, lamc = misc.compute_scaling(s, z, None, d)
    out.update({"lambda": lamc, "d": Wc.d,
                "beta": torch.stack(Wc.beta), "v": torch.cat(Wc.v)})
    for f in ("r", "rti"):
        out[f + " " + f + "'"] = torch.cat([(a @ a.T).flatten()
                                           for a in getattr(Wc, f)])
    W = Wc if W is None else W
    lam = lamc if lam is None else lam
    for trans in "NT":
        for inverse in "NI":
            out[f"scale {trans}{inverse}"] = misc.scale(u, W, d, trans,
                                                        inverse)
    out["scale2"] = misc.scale2(lam, u, d)
    out["scale2 inverse"] = misc.scale2(lam, u, d, inverse="I")
    return out, Wc, lamc


# sdot and compute_scaling's outputs at an optimum, where s and z are
# nearly complementary: s'z is a sum of terms whose magnitudes add up to
# ~1e7 times s'z (lane 0 of phase 7's l+q+s problems), and the q blocks'
# hyperbolic norms and the s blocks' eigenvalues cancel alike, so each
# loses digits differently in the card's and the CPU's summation order
# (the CPU's own s'z moves by 1e-10 to 1e-9 under a reordering of its
# terms).  misc_on_card holds them there to 1e-6, prints sdot's condition
# and how far a relative change of 1e-15 in s and z moves them on the
# CPU alone; at the interior pair (s + e, z + e) every output is held to
# 1e-10
MISC_COND = ("sdot", "lambda", "beta", "v", "r r'", "rti rti'")


def cone_identity(dims, like):
    """The identity e of the cone of `dims` (ones, (1, 0, ..), vec(I)) as
    a vector like `like`."""
    parts = [torch.ones(dims["l"])]
    for m in dims["q"]:
        parts.append(torch.eye(m)[0])
    for m in dims["s"]:
        parts.append(torch.eye(m).flatten())
    return torch.cat(parts).to(like)


def misc_agree(label, s, z, u, dev, tol_cond):
    """misc_calls on (s, z, u) on `dev` against CPU tensors, on the card's
    W: max|card-cpu|/max|cpu| of each output; all held to 1e-10, the
    MISC_COND outputs to tol_cond -> those outputs' largest gap."""
    from kvxopt_tpu_torch.cones import NTScaling
    gpu, Wg, lamg = misc_calls(s.to(dev), z.to(dev), u.to(dev))
    on_card(label, *(v for v in gpu.values() if torch.is_tensor(v)))
    Wcpu = NTScaling(*(f.cpu() if torch.is_tensor(f)
                       else tuple(a.cpu() for a in f) for f in Wg))
    cpu, _, _ = misc_calls(s.cpu(), z.cpu(), u.cpu(), Wcpu, lamg.cpu())
    errs = {k: rel_err(gpu[k], cpu[k]) for k in gpu}
    print(f"{label} on the card against CPU tensors, max|card-cpu|/"
          "max|cpu|: " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
          + f" (tol 1e-10; {', '.join(MISC_COND)} {tol_cond:g})")
    check(all(e <= (tol_cond if k in MISC_COND else 1e-10)
              for k, e in errs.items()), f"{label}: the card and the CPU "
          "differ")
    return max(errs[k] for k in MISC_COND)


def scaling_sensitivity(s, z):
    """compute_scaling on the CPU at (s, z) and at s and z each changed by
    a relative 1e-15 of random sign: the largest max|change|/max|out| over
    the MISC_COND outputs."""
    g = torch.Generator().manual_seed(17)
    s, z = s.cpu(), z.cpu()
    sp, zp = (a * (1 + 1e-15 * torch.randn(a.shape, generator=g,
                                           dtype=a.dtype).sign())
              for a in (s, z))
    a, _, _ = misc_calls(s, z, s)
    b, _, _ = misc_calls(sp, zp, s)
    return max(rel_err(b[k], a[k]) for k in MISC_COND)


def misc_on_card(dev):
    """Phase 16(b): misc.kkt_chol through coneqp (the H=P wrapper) against
    kktsolver='chol' on lane 0 of phase 7's l+q+s problems, then misc's
    functions on that solution's s and z on the card against CPU
    tensors, on one scaling W."""
    from kvxopt_tpu_torch import misc, solvers
    P, q, G, h = lqs_problem(SEEDS[0])
    f = misc.kkt_chol(G, LQS_DIMS, None)
    t0 = time.perf_counter()
    sm = solvers.coneqp(P, q, G, h, LQS_DIMS,
                        kktsolver=lambda W, H=None, Df=None: f(W, H=P))
    tm = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc = solvers.coneqp(P, q, G, h, LQS_DIMS, kktsolver="chol")
    tc = time.perf_counter() - t0
    on_card("misc coneqp", sm["x"], sm["s"], sm["z"])
    x, xc = sm["x"].cpu().numpy(), sc["x"].cpu().numpy()
    dx = np.linalg.norm(x - xc) / (1 + np.linalg.norm(xc))
    print(f"misc.kkt_chol through coneqp: {sm['status']} in "
          f"{sm['iterations']} iterations, {tm:.4f} s; kktsolver='chol': "
          f"{sc['status']} in {sc['iterations']}, {tc:.4f} s; "
          f"|x-x_chol|/(1+|x_chol|) {dx:.3e} (tol 1e-7)")
    check(sm["status"] == sc["status"] == "optimal" and
          sm["iterations"] == sc["iterations"],
          "misc.kkt_chol: status or iterations differ from 'chol'")
    check(dx <= 1e-7, "misc.kkt_chol: x differs from 'chol'")
    s, z = sc["s"], sc["z"]
    g = torch.Generator().manual_seed(16)
    u = torch.randn(s.shape, generator=g, dtype=s.dtype)
    e = cone_identity(LQS_DIMS, s)
    misc_agree("misc at (s + e, z + e)", s + e, z + e, u, dev, 1e-10)
    gap = misc_agree("misc at the optimum", s, z, u, dev, 1e-6)
    sens = scaling_sensitivity(s, z)
    t = (s * z).cpu().reshape(-1)
    cond = float(t.abs().sum() / t.sum().abs().clamp(min=1e-300))
    print(f"misc at the optimum: {', '.join(MISC_COND)} move by {sens:.2e} "
          f"on the CPU when s and z change by 1e-15 relative; the card's "
          f"gap {gap:.2e} is {gap / max(sens, 1e-300):.3g} times that; "
          f"sdot's condition sum|s_i z_i|/|s'z| {cond:.3g}")


def profile_option(dev):
    """Phase 16(c): solvers.qp with options['profile'] on lane 0 of phase
    3's problems writes one Chrome trace with CUDA kernel events; the same
    call without the key writes nothing."""
    from kvxopt_tpu_torch import solvers
    P, q, G, h = large_problem(SEEDS[0])
    with scratch_dir() as tmp:
        sol = solvers.qp(P, q, G, h, options={"profile": tmp})
        files = os.listdir(tmp)
        check(len(files) == 1, f"profile: {len(files)} files, expected 1")
        path = os.path.join(tmp, files[0])
        with open(path) as fh:
            tr = json.load(fh)
        events = tr["traceEvents"] if isinstance(tr, dict) else tr
        kernels = sum(e.get("cat") == "kernel" for e in events)
        print(f"profile: qp {sol['status']} in {sol['iterations']} "
              f"iterations wrote {files[0]}, {os.path.getsize(path)} bytes, "
              f"{len(events)} events, {kernels} CUDA kernel events")
        check(kernels > 0, "profile: the trace holds no CUDA kernel events")
        plain = solvers.qp(P, q, G, h)
        check(os.listdir(tmp) == files,
              "profile: a call without the key wrote a file")
        check(sol["status"] == plain["status"] == "optimal",
              "profile: qp not optimal")


def seq_misc(dev, x3, walls3):
    """Phase 16, "seq and misc": (a) seq_driver, (b) misc_on_card, (c)
    profile_option.  Returns (a)'s kernel launches."""
    launches = seq_driver(dev, x3, walls3)
    misc_on_card(dev)
    profile_option(dev)
    return launches


def split(u, k, keys=("a", "b")):
    """A vector as a dict of its first k entries and the rest."""
    return {keys[0]: u[:k], keys[1]: u[k:]}


def join(u, keys=("a", "b")):
    return torch.cat([u[k] for k in keys])


def same_as_dense(name, sol, ref, x, xref):
    """Phase 17's gate: the dense call's status, iterations within 1, x
    within 1e-6 (1 + |x|)."""
    dx = float(torch.linalg.vector_norm(x - xref) /
               (1 + torch.linalg.vector_norm(xref)))
    print(f"{name}: {sol['status']} in {sol['iterations']} iterations "
          f"(dense {ref['status']} in {ref['iterations']}), "
          f"|x-x_dense|/(1+|x_dense|) {dx:.3e} (tol 1e-6)", flush=True)
    check(sol["status"] == ref["status"] == "optimal",
          f"{name}: status {sol['status']}, dense {ref['status']}")
    check(abs(sol["iterations"] - ref["iterations"]) <= 1,
          f"{name}: iterations differ from the dense call's by more than 1")
    check(dx <= 1e-6, f"{name}: x differs from the dense call's")


def custom_spaces(dev):
    """Phase 17(a): coneqp and conelp with custom x spaces (x = {'a': the
    first half, 'b': the rest}, P and G operators on the card, a
    kktsolver over misc's dense chol factor) on phase 7's lane 0 and on
    lqs_lp(0), and coneqp with custom x and y spaces (y split likewise,
    A an operator, b a dict) on phase 5's lane 0; each against the same
    problem's dense call.  Returns phase 7 lane 0's dense x (numpy) and
    iterations."""
    from kvxopt_tpu_torch import misc, solvers

    def T(a):
        return torch.as_tensor(a, device=dev)

    def kktsolver(factor, H=None, y=False):
        def kkt(W, H_=None, Df=None):
            solve = factor(W, H=H)

            def s(bx, by, bz):
                ux, uy, uz = solve(join(bx), join(by, "uw") if y else by, bz)
                return (split(ux, N // 2), split(uy, P_EQ // 2, "uw") if y
                        else uy, uz)
            return s
        return kkt

    def G_op(Gt):
        def G(u, trans=False):
            return split(Gt.T @ u, N // 2) if trans else Gt @ join(u)
        return G

    def P_op(Pt):
        return lambda u: split(Pt @ join(u), N // 2)

    walls = {}
    P, q, G, h = lqs_problem(SEEDS[0])
    Pt, Gt = T(P), T(G)
    t0 = time.perf_counter()
    sol = solvers.coneqp(P_op(Pt), split(T(q), N // 2), G_op(Gt), h,
                         LQS_DIMS, kktsolver=kktsolver(
                             misc.kkt_chol(Gt, LQS_DIMS, None), H=Pt),
                         xnewcopy=dict)
    walls["coneqp x"] = time.perf_counter() - t0
    ref = solvers.coneqp(P, q, G, h, LQS_DIMS)
    same_as_dense("custom coneqp l+q+s", sol, ref, join(sol["x"]), ref["x"])
    xlqs, it7 = ref["x"], ref["iterations"]

    c, G, h = lqs_lp(0)
    Gt = T(G)
    t0 = time.perf_counter()
    sol = solvers.conelp(split(T(c), N // 2), G_op(Gt), h, LQS_DIMS,
                         kktsolver=kktsolver(misc.kkt_chol(Gt, LQS_DIMS,
                                                           None)),
                         xnewcopy=dict)
    walls["conelp x"] = time.perf_counter() - t0
    ref = solvers.conelp(c, G, h, LQS_DIMS, kktsolver="chol")
    same_as_dense("custom conelp l+q+s", sol, ref, join(sol["x"]), ref["x"])

    P, q, G, h, A, b = lqeq_problem(SEEDS[0])
    dims = {"l": L_EQ, "q": list(Q_EQ)}
    Pt, Gt, At = T(P), T(G), T(A)

    def A_op(u, trans=False):
        if trans:
            return split(At.T @ join(u, "uw"), N // 2)
        return split(At @ join(u), P_EQ // 2, "uw")
    t0 = time.perf_counter()
    sol = solvers.coneqp(
        P_op(Pt), split(T(q), N // 2), G_op(Gt), h, dims, A_op,
        split(T(b), P_EQ // 2, "uw"), kktsolver=kktsolver(
            misc.kkt_chol(Gt, dims, At), H=Pt, y=True), xnewcopy=dict,
        ydot=lambda u, v: torch.dot(u["u"], v["u"]) + torch.dot(u["w"],
                                                               v["w"]))
    walls["coneqp x, y"] = time.perf_counter() - t0
    ref = solvers.coneqp(P, q, G, h, dims, A, b)
    same_as_dense("custom coneqp l+q+eq (x and y)", sol, ref, join(sol["x"]),
                  ref["x"])
    dy = float(torch.linalg.vector_norm(join(sol["y"], "uw") - ref["y"]) /
               (1 + torch.linalg.vector_norm(ref["y"])))
    print(f"custom coneqp l+q+eq: |y-y_dense|/(1+|y_dense|) {dy:.3e} "
          "(tol 1e-6)")
    check(dy <= 1e-6, "custom coneqp l+q+eq: y differs from the dense call's")
    print("phase 17(a) walls: " + ", ".join(f"{k} {v:.4f} s"
                                            for k, v in walls.items()))
    return xlqs.cpu().numpy(), it7


def arrow_data(seed=17, Bn=B_AR, nb=NB_AR, nc=NC_AR):
    """Phase 17(d): B SPD blocks D_i = M M' + nb I, borders C_i standard
    normal, corner E = (nc + nb) I, and the right-hand sides (numpy)."""
    rng = np.random.default_rng(seed)
    Mx = rng.standard_normal((Bn, nb, nb))
    D = Mx @ Mx.transpose(0, 2, 1) + nb * np.eye(nb)
    C = rng.standard_normal((Bn, nb, nc))
    E = (nc + nb) * np.eye(nc)
    return D, C, E, rng.standard_normal((Bn, nb)), rng.standard_normal(nc)


def arrow_residual(D, C, E, bblk, bbrd, xblk, xbrd):
    """|K x - b| / |b| of the whole arrow system, on the tensors' device."""
    rb = (torch.einsum("bij,bj->bi", D, xblk) + C @ xbrd - bblk)
    rc = torch.einsum("bij,bi->j", C, xblk) + E @ xbrd - bbrd
    nb_ = torch.sqrt(torch.sum(bblk ** 2) + torch.sum(bbrd ** 2))
    return float(torch.sqrt(torch.sum(rb ** 2) + torch.sum(rc ** 2)) / nb_)


def timed(walls, name, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
    return out


def phase17_rank(rank, world, dev):
    """Phase 17(b)-(e) in one rank of a world of `world` ranks on the card
    (spawned): (b) coneqp through sharded_kkt_solver on phase 7's lane 0,
    at world 2 also with dist_nb=NB_SH; (c) dist_cholesky at N_DC, NB_DC
    against torch.linalg.cholesky; (d) arrow_kkt_factor over the mesh;
    (e) batched_qp_solver_mixed(mesh=) on phase 3's problems, each rank
    solving its slice of the batch, K1-K3's counts set to 0 just before
    and read just after.  Returns rank 0's results and walls (numpy and
    numbers)."""
    from kvxopt_tpu_torch import ConeDims, config, ops, solvers
    from kvxopt_tpu_torch.convert import problem_to_torch, state_to_numpy
    from kvxopt_tpu_torch.parallel import (
        arrow_kkt_factor, batched_qp_solver_mixed, cyclic_unpack,
        dist_cholesky, make_mesh, sharded_kkt_solver)
    from kvxopt_tpu_torch.parallel.dist_chol import gather_stack
    config.set_default_device(dev)
    mesh = make_mesh(world, ("kkt",))
    out, walls = {}, {}

    P, q, G, h = lqs_problem(SEEDS[0])
    Gt, Pt = (torch.as_tensor(a, device=dev) for a in (G, P))
    for nb in (0, NB_SH) if world > 1 else (0,):
        f = sharded_kkt_solver(mesh, "kkt", LQS_DIMS, Gt, Pmat=Pt,
                               dist_nb=nb)
        for run in ("cold", "warm"):   # the rank's first call, then again
            sol = timed(walls, f"(b) sharded coneqp dist_nb={nb} {run}",
                        lambda: solvers.coneqp(P, q, G, h, LQS_DIMS,
                                               kktsolver=f))
        out[f"sharded {nb}"] = (sol["status"], sol["iterations"],
                                sol["x"].cpu().numpy())

    rng = np.random.default_rng(5)
    A5 = torch.as_tensor(rng.standard_normal((N_DC, N_DC)) / np.sqrt(N_DC),
                         device=dev)
    K = A5 @ A5.T + torch.eye(N_DC, dtype=A5.dtype, device=dev)
    Ll, _ = timed(walls, "(c) dist_cholesky",
                  lambda: dist_cholesky(mesh, "kkt", K, NB_DC))
    L = cyclic_unpack(gather_stack(mesh, "kkt", Ll), NB_DC, world)
    Lref = torch.linalg.cholesky(K)
    out["dist_cholesky"] = float((L - Lref).abs().max() / Lref.abs().max())

    D, C, E, bblk, bbrd = (torch.as_tensor(a, device=dev)
                           for a in arrow_data())
    solve, _ = timed(walls, "(d) arrow factor",
                     lambda: arrow_kkt_factor(D, C, E, mesh=mesh))
    xblk, xbrd = timed(walls, "(d) arrow solve", lambda: solve(bblk, bbrd))
    out["arrow"] = arrow_residual(D, C, E, bblk, bbrd, xblk, xbrd)

    dims, data = slice_data("slice")
    args = problem_to_torch(*data, device=dev)
    solve = batched_qp_solver_mixed(dims, mesh=make_mesh(world))
    torch.cuda.synchronize()
    ops.reset_launches()
    res = timed(walls, "(e) batched_qp_solver_mixed(mesh=)",
                lambda: solve(*args))
    out["launches"] = dict(ops.LAUNCHES)
    x, _, _, _, it, status, _ = state_to_numpy(res)
    out["mixed"] = (x, it, status)
    out["walls"] = walls
    return out if rank == 0 else None


def multi_device(dev, gpu3):
    """Phase 17, "custom spaces and the multi-device layer": (a)
    custom_spaces; phase17_rank's (b)-(e) at world 1 over NCCL and at
    world 2 over gloo, both ranks on cuda:0; (d) also without a mesh in
    this process.  (b) is held to the dense chol solve of phase 7's lane
    0 as (a) is, (c) to 1e-10 relative on L, (d) to 1e-10 on the
    residual, (e) to phase 3's lanes (gpu3): status, iterations, x within
    1e-12 (1 + |x|).  Returns (e)'s kernel launches at world 1."""
    from kvxopt_tpu_torch.parallel import arrow_kkt_factor, spawn
    x7, it7 = custom_spaces(dev)
    stamp("phase 17(a)")
    D, C, E, bblk, bbrd = (torch.as_tensor(a, device=dev)
                           for a in arrow_data())
    walls = {}
    solve, _ = timed(walls, "factor", lambda: arrow_kkt_factor(D, C, E))
    xb, xc = timed(walls, "solve", lambda: solve(bblk, bbrd))
    r = arrow_residual(D, C, E, bblk, bbrd, xb, xc)
    print(f"(d) arrow without a mesh, B={B_AR} nb={NB_AR} nc={NC_AR}: "
          f"residual {r:.3e} (tol 1e-10), factor {walls['factor']:.4f} s, "
          f"solve {walls['solve']:.4f} s")
    check(r < 1e-10, "(d) arrow without a mesh: residual too large")
    launches = None
    for world, backend in ((1, "nccl"), (2, "gloo")):
        name = f"world {world} ({backend}, cuda:0)"
        t0 = time.perf_counter()
        try:
            out = spawn(phase17_rank, world, backend, "cuda:0",
                        timeout=WORLD_S)
        except (RuntimeError, TimeoutError) as e:
            fail(f"phase 17 {name}: {e}")
        print(f"phase 17 {name}: {time.perf_counter() - t0:.1f} s with the "
              "ranks' start; " + ", ".join(
                  f"{k} {v:.4f} s" for k, v in out["walls"].items()),
              flush=True)
        for key in sorted(k for k in out if k.startswith("sharded")):
            st, it, x = out[key]
            dx = np.linalg.norm(x - x7) / (1 + np.linalg.norm(x7))
            print(f"(b) {name} coneqp through sharded_kkt_solver "
                  f"dist_nb={key.split()[1]}: {st} in {it} iterations, "
                  f"|x-x_chol|/(1+|x_chol|) {dx:.3e} (tol 1e-6)")
            check(st == "optimal" and abs(it - it7) <= 1 and dx <= 1e-6,
                  f"(b) {name} {key}: differs from the dense chol solve")
        print(f"(c) {name} dist_cholesky n={N_DC} nb={NB_DC}: max|L-L_ref|"
              f"/max|L_ref| {out['dist_cholesky']:.3e} (tol 1e-10); (d) "
              f"arrow over the mesh: residual {out['arrow']:.3e} "
              "(tol 1e-10)")
        check(out["dist_cholesky"] <= 1e-10, f"(c) {name}: L differs")
        check(out["arrow"] < 1e-10, f"(d) {name}: residual too large")
        x, it, status = out["mixed"]
        x3, it3, st3 = gpu3
        dx = (np.linalg.norm(x - x3, axis=1) /
              (1 + np.linalg.norm(x3, axis=1))).max()
        print(f"(e) {name} batched_qp_solver_mixed(mesh=): status "
              f"{status.tolist()}, iterations {it.tolist()}, max "
              f"|x-x_phase3|/(1+|x_phase3|) {dx:.3e} (tol 1e-12), rank 0's "
              f"launches {out['launches']}", flush=True)
        check((status == st3).all() and (it == it3).all() and
              dx <= 1e-12, f"(e) {name}: differs from phase 3's lanes")
        check(all(out["launches"][k] > 0 for k in ("K1", "K2", "K3")),
              f"(e) {name}: a kernel of the path never launched")
        if world == 1:   # the kernels line's count: the world of one
            launches = out["launches"]
    return launches


# phase 19, "examples": the repo's example programs on the card
# (kvxopt_tpu_torch.examples): every script of examples/ and every cvxbook
# problem of examples.book, with numpy data and no device named
L1REGLS_WIDE = (100, 1000)   # (b) l1regls (m, n): operator P and G
MCSDP_WIDE, MCSDP_SMALL = 100, 20   # (b) mcsdp n: KKT order n + n^2
WS_ROWS, WS_N = 2048, 256    # (c) weak_scaling_sharded's defaults
# lapack is a host facade in both packages: these do no device work
HOST_ONLY = ("book smoothrec", "book inputdesign")


def example_calls():
    """Phase 19's calls in order: name -> fn() giving the call's output as
    a user gets it.  The scripts of examples/ (weak_scaling_sharded is
    (c)) through their main() at its defaults; each book problem on its
    <name>_data(), made here once."""
    import importlib
    from kvxopt_tpu_torch.examples import EXAMPLES
    from kvxopt_tpu_torch.examples.book import PROBLEMS
    calls = {}
    for name in EXAMPLES:
        if name != "weak_scaling_sharded":
            calls[name] = importlib.import_module(
                f"kvxopt_tpu_torch.examples.{name}").main
    for mod_name, names in PROBLEMS.items():
        mod = importlib.import_module(
            f"kvxopt_tpu_torch.examples.book.{mod_name}")
        for name in names:
            data = getattr(mod, f"{name}_data")()
            calls[f"book {name}"] = (
                lambda f=getattr(mod, name), d=data: f(d))
    return calls


def _result_dicts(out):
    """The solvers' result dicts inside an example's output, in order."""
    if isinstance(out, dict):
        if "status" in out and "iterations" in out:
            return [out]
        return [r for v in out.values() for r in _result_dicts(v)]
    if isinstance(out, (list, tuple)):
        return [r for v in out for r in _result_dicts(v)]
    return []


def _row(status, iterations, x):
    return (str(status), int(iterations),
            None if x is None else np.asarray(
                x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                dtype=np.float64).ravel())


def example_rows(name, out, lps):
    """(status, iterations, x) of every solve a call made: the lp calls of
    op.solve (lps), then the result dicts of its output; portfolio's
    batch lanes and its sweep; covsel's Newton loop; the lapack facades'
    solutions."""
    if name == "portfolio":
        return ([_row(s, 0, x) for s, x in zip(out["batch_status"],
                                                out["batch_x"])] +
                [_row("sweep", 0, np.r_[out["returns"], out["risks"]])])
    if name == "book covsel":
        return [_row("optimal" if out["decrement"] < 1e-10 else "unknown",
                     out["iterations"], out["K"])]
    if name in HOST_ONLY:
        xs = out if isinstance(out, list) else [out]
        return [_row("host", 0, x) for x in xs]
    return ([_row(s["status"], s["iterations"], s["x"]) for s in lps] +
            [_row(s["status"], s["iterations"], s["x"])
             for s in _result_dicts(out)])


def _result_devices(out, lps):
    return {s["x"].device.type for s in list(lps) + _result_dicts(out)
            if isinstance(s.get("x"), torch.Tensor)}


def need(cond, what):
    if not cond:
        raise AssertionError(what)


def _xs(sol):
    return sol["x"].detach().cpu().numpy().ravel()


def _near(a, b, atol, what):
    need(np.abs(np.asarray(a, dtype=float) - np.asarray(b, dtype=float))
         .max() <= atol, what)


def _robust_residual(A, Aps, b, x, nsamp=400):
    """max over ||u|| <= 1 of ||(A + sum u_i Ap_i) x - b|| by polished
    sampling (tests/test_book_examples4.py)."""
    r0 = A @ x - b
    P = np.stack([Ap @ x for Ap in Aps], axis=1)
    rng = np.random.default_rng(0)
    best = np.linalg.norm(r0)
    for _ in range(nsamp):
        u = rng.standard_normal(P.shape[1])
        u /= np.linalg.norm(u)
        for _ in range(50):
            g = P.T @ (r0 + P @ u)
            if np.linalg.norm(g) < 1e-14:
                break
            u2 = g / np.linalg.norm(g)
            done = np.linalg.norm(u2 - u) < 1e-12
            u = u2
            if done:
                break
        best = max(best, np.linalg.norm(r0 + P @ u))
    return best


def _sphere_ls(A, b, alpha, minimize):
    """min/max ||Ax-b||^2 over ||x||^2 = alpha by bisection on the
    multiplier (tests/test_book_examples5.py)."""
    H, g = A.T @ A, A.T @ b
    w = np.linalg.eigvalsh(H)
    lo, hi = (-w[0], -w[0] + 1e6) if minimize else (-w[-1] - 1e6, -w[-1])
    for _ in range(200):
        lam = 0.5 * (lo + hi)
        x = np.linalg.solve(H + lam * np.eye(len(g)), g)
        if (float(x @ x) > alpha) == minimize:
            lo = lam
        else:
            hi = lam
    r = A @ x - b
    return float(r @ r)


def check_example(name, out, lps):
    """The values tests/test_examples.py and the JAX package's book tests
    assert, on the port's output (AssertionError where one fails); the
    CPU comparison holds the rest (examples_compare)."""
    import importlib
    from scipy.optimize import linprog
    if name.startswith("book "):
        short = name[5:]
        from kvxopt_tpu_torch.examples.book import PROBLEMS
        mod = importlib.import_module("kvxopt_tpu_torch.examples.book." + next(
            m for m, ns in PROBLEMS.items() if short in ns))
        data = getattr(mod, f"{short}_data")()
    sols = _result_dicts(out) + list(lps)
    if name not in ("portfolio", "book covsel", "book consumerpref") and \
            name not in HOST_ONLY:
        need(sols and all(s["status"] == "optimal" for s in sols),
             f"statuses {[s['status'] for s in sols]}")
    if name == "lp":
        _near(_xs(out), [1.0, 1.0], 1e-6, "x")
        _near(out["primal objective"], -9.0, 1e-6, "objective")
    elif name == "socp":
        _near(_xs(out), [-5.0148, -5.7667, -8.5217], 1e-3, "x")
    elif name == "sdp":
        _near(_xs(out), [-0.3677, 1.8983, -0.8874], 1e-3, "x")
        need(all(torch.linalg.eigvalsh(Z).min() > -1e-7 for Z in out["zs"]),
             "zs not PSD")
    elif name == "conelp":
        _near(_xs(out), [-1.2209, 0.0966, 3.5775], 1e-3, "x")
        need(out["primal infeasibility"] < 1e-6 and
             out["dual infeasibility"] < 1e-6, "infeasibilities")
    elif name == "coneqp":
        _near(_xs(out), [0.72558319, 0.61806264, 0.30253528], 1e-5, "x")
    elif name == "gp":
        need(np.allclose(np.exp(_xs(out)), [2.8873, 5.7746, 11.5431],
                         rtol=1e-3), "box")
    elif name == "acent2":
        _near(_xs(out), [0.4110, 0.5588, -0.7201], 1e-3, "x")
    elif name == "l1regls":
        x, _, A, y = out
        g = 2.0 * A.T @ (A @ x - y)
        on = np.abs(x) > 1e-6
        need((np.abs(g) <= 1.0 + 1e-5).all(), "|gradient| > 1")
        _near(g[on], -np.sign(x[on]), 1e-4, "gradient on the support")
    elif name == "portfolio":
        need((out["batch_status"] == 1).all(), "batch statuses")
        need(out["returns"][0] >= out["returns"][-1] - 1e-6, "returns")
    elif name == "normappr":
        (x1, p1), (x2, p2), (x3, p3), A, b = out
        Am, bv = np.asarray(A), np.asarray(b).reshape(-1)
        m, n = Am.shape
        c = np.r_[np.zeros(n), 1.0]
        G = np.block([[Am, -np.ones((m, 1))], [-Am, -np.ones((m, 1))]])
        r = linprog(c, A_ub=G, b_ub=np.r_[-bv, bv], bounds=(None, None),
                    method="highs")
        r1 = Am @ np.asarray(x1.value).ravel() + bv
        need(abs(np.abs(r1).max() - r.fun) < 1e-6, "inf-norm optimum")
        r3 = Am @ np.asarray(x3.value).ravel() + bv
        direct = np.maximum.reduce([np.zeros_like(r3), np.abs(r3) - 0.75,
                                    2 * np.abs(r3) - 2.25]).sum()
        need(abs(direct - np.asarray(p3.objective.value()).ravel()[0])
             < 1e-6, "dead-zone objective")
    elif name in ("roblp", "l1svc"):
        x, x2, _, _ = out
        _near(np.asarray(x.value), np.asarray(x2.value), 1e-6,
              "the two formulations differ")
    elif name == "lp_modeling":
        lp1, _, (x, y, c1, c2, _, _), (x2, _) = out
        _near(lp1.objective.value()[0], -9.0, 1e-6, "objective")
        _near([x.value[0], y.value[0]], [1.0, 1.0], 1e-6, "x, y")
        _near(np.asarray(x2.value).ravel(), [1.0, 1.0], 1e-6, "x2")
        _near([c1.multiplier.value[0], c2.multiplier.value[0]], [1.0, 2.0],
              1e-5, "multipliers")
    elif name == "dsdp_dual_scaling":
        (status, x, _, _, _), ref = out
        need(status == "DSDP_PDFEASIBLE", f"dual scaling {status}")
        need(abs(float(np.asarray(x).ravel() @ [1.0, -1.0, 1.0]) -
                 ref["primal objective"]) < 1e-4, "objective gap")
    elif name == "floorplan":
        _, W, H, _, _, w, hh = out
        need(np.allclose(w * hh, 100.0, rtol=1e-5), "areas")
        need(abs(W + H - 47.94) < 0.2, "W + H")
    elif name == "book huber":
        from scipy.optimize import minimize
        A, v = data

        def loss(x):
            a = np.abs(A @ x - v)
            return np.sum(np.where(a <= 1.0, a * a, 2 * a - 1.0))
        ref = minimize(loss, np.zeros(2), method="Nelder-Mead",
                       options={"xatol": 1e-10, "fatol": 1e-12,
                                "maxiter": 5000})
        _near(_xs(out)[:2], ref.x, 1e-4, "x")
    elif name == "book basispursuit":
        A, y = data
        x = _xs(out)[:A.shape[1]]
        g = 2.0 * A.T @ (A @ x - y)
        nz = np.abs(x) > 1e-6
        need(np.all(np.abs(g) <= 1.0 + 1e-5), "|gradient| > 1")
        _near(g[nz], -np.sign(x[nz]), 1e-5, "gradient on the support")
    elif name == "book regsel":
        A, b = data
        res = [np.linalg.norm(A @ _xs(s)[:A.shape[1]] - b) for s in out]
        need(all(res[i] >= res[i + 1] - 1e-8 for i in range(len(res) - 1)),
             "residuals not decreasing")
        xln = np.linalg.lstsq(A, b, rcond=None)[0]
        _near(res[-1], np.linalg.norm(A @ xln - b), 1e-4, "LS residual")
    elif name == "book maxent":
        G, h, _, _ = data
        p = _xs(out)
        need(np.all(p > 0) and abs(p.sum() - 1.0) < 1e-6 and
             np.all(G @ p <= h + 1e-6), "distribution")
    elif name == "book expdesign":
        x = _xs(out)
        w = np.sum(data * (np.linalg.inv((data * x) @ data.T) @ data),
                   axis=0)
        need(np.max(w) <= 2.0 + 1e-4, "duality")
        _near(w[x > 1e-5], 2.0, 1e-3, "support")
    elif name == "book covsel":
        rows, cols = data["rows"], data["cols"]
        need(out["decrement"] < 1e-10, "Newton decrement")
        _near(np.linalg.inv(out["K"])[rows, cols], data["Y"][rows, cols],
              1e-6, "stationarity")
        need(np.linalg.eigvalsh(out["K"]).min() > 0, "K not PD")
    elif name == "book linsep":
        prob, a, b = out
        X, Y = data
        av, bv = np.asarray(a.value).ravel(), float(np.asarray(b.value)[0])
        need(float(prob.objective.value()[0]) < 1e-6, "objective")
        need(np.all(X.T @ av - bv >= 1 - 1e-6) and
             np.all(Y.T @ av - bv <= -1 + 1e-6), "separation")
    elif name == "book chernoff":
        for sol, (A, b, _) in zip(out, data):
            need(np.all(A @ _xs(sol) <= b + 1e-6), "feasibility")
    elif name == "book placement":
        A, B = data
        for d, sol in enumerate(out):
            _near(_xs(sol), np.linalg.lstsq(A, -B[:, d], rcond=None)[0],
                  1e-5, "x")
    elif name == "book centers":
        G, h, _ = data
        x = _xs(out)
        L = np.array([[x[0], 0.0], [x[1], x[2]]])
        need(np.all(np.linalg.norm(G @ L, axis=1) + G @ x[3:5] <= h + 1e-6),
             "containment")
        A_ub = np.hstack([G, np.linalg.norm(G, axis=1)[:, None]])
        res = linprog([0, 0, -1.0], A_ub=A_ub, b_ub=h,
                      bounds=[(None, None)] * 2 + [(0, None)],
                      method="highs")
        need(abs(np.linalg.det(L)) >= res.x[2] ** 2 * (1 - 1e-6),
             "smaller than the Chebyshev ball")
    elif name == "book l2ac":
        _near(_xs(out[1]), _xs(out[0]), 1e-5, "custom against dense")
    elif name == "book logreg":
        A, c = data
        x = _xs(out)
        p = 1 / (1 + np.exp(-(A @ x)))
        need(np.linalg.norm(c + A.T @ p) < 1e-5, "gradient")
    elif name == "book penalties":
        A, b = data
        n = A.shape[1]
        r1 = A @ np.asarray(out["l1"][1].value).ravel() + b
        r2 = A @ np.asarray(out["deadzone"][1].value).ravel() + b
        need(np.sum(np.abs(r1) < 1e-6) >= n - 1, "l1 residuals")
        need(np.sum(np.abs(r2) <= 0.5 + 1e-6) >= n - 1, "dead band")
        need(np.all(np.abs(A @ _xs(out["barrier"]) + out["b_barrier"])
                    < 1.0), "barrier domain")
    elif name == "book cvxfit":
        _, _, G, _ = mod.cvxfit_problem(data)
        need(np.all(G @ _xs(out) <= 1e-7), "convexity")
    elif name == "book smoothrec":
        corr, delta = data
        D = np.diff(np.eye(len(corr)), axis=0)
        _near(out, np.linalg.solve(np.eye(len(corr)) + delta * D.T @ D,
                                   corr), 1e-9, "x")
    elif name == "book robls":
        A, Aps, b = data
        x_rob = _xs(out)[:A.shape[1]]
        x_ls = np.linalg.lstsq(A, b, rcond=None)[0]
        r_rob = _robust_residual(A, Aps, b, x_rob)
        need(r_rob <= _robust_residual(A, Aps, b, x_ls) + 1e-8,
             "worst case above LS's")
        need(r_rob ** 2 <= out["primal objective"] + 1e-6, "bound")
    elif name == "book ellipsoids":
        x = _xs(out)
        L = np.array([[x[0], 0.0], [x[1], x[2]]])
        nrm = np.linalg.norm(data @ L.T + x[3:5], axis=1)
        need(np.all(nrm <= 1.0 + 1e-6) and np.sum(nrm > 1.0 - 1e-4) >= 2,
             "cover and support")
        R = np.max(np.linalg.norm(data - data.mean(axis=0), axis=1))
        need(np.pi / np.linalg.det(L) <= np.pi * R * R * 1.0001, "volume")
    elif name == "book polapprox":
        V, y = data
        a = _xs(out)[:V.shape[1]]
        _near(np.max(np.abs(V @ a - y)), out["primal objective"], 1e-6,
              "Chebyshev norm")
    elif name == "book consumerpref":
        labels, vals = out
        need(len(labels) == data.shape[1] and np.isfinite(vals).any(),
             "labels")
    elif name == "book inputdesign":
        for u, (delta, eta) in zip(out, mod.INPUTDESIGN_WEIGHTS):
            AA, bb = mod.inputdesign_system(data, delta, eta)
            _near(u, np.linalg.lstsq(AA, bb, rcond=None)[0], 1e-8, "u")
    elif name == "book probbounds":
        rows, _, scale = out
        need(all(0.0 <= r["bound"] <= 1.0 + 1e-8 for r in rows), "bounds")
        need(scale > 0, "degenerate ellipse")
    elif name == "book filterdemo":
        _, hv, att = out
        G1, _, d1 = data
        y1 = G1 @ hv
        need((y1 <= d1 + 1e-7).all() and (y1 >= 1.0 / d1 - 1e-7).all(),
             "pass band")
        need(att < 1.0 / d1, "attenuation")
    elif name == "book rls":
        A, b = data
        for rows, lower in ((out[0], True), (out[1], False)):
            for alpha, value, _ in rows:
                exact = _sphere_ls(A, b, alpha, lower)
                need(abs(value - exact) <= 1e-6 + 1e-5 * abs(exact),
                     f"alpha {alpha}")


def _run_example(fn):
    """fn() with solvers.lp spied on -> (output, the lp results)."""
    from kvxopt_tpu_torch import solvers
    with spy(solvers, "lp") as seen:
        out = fn()
    return out, list(seen)


def _cpu_ms(fn, reps=3):
    """Median ms of `reps` calls of fn on the CPU (warm_times without the
    card's syncs: a CPU worker never touches CUDA)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def l1regls_wide_data(m=L1REGLS_WIDE[0], n=L1REGLS_WIDE[1], seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), rng.standard_normal(m)


def mcsdp_data(n):
    """examples/mcsdp.py's main(n) data."""
    w = np.random.default_rng(3).standard_normal((n, n))
    return 0.5 * (w + w.T)


def wide_calls():
    """(b)'s calls at widths where the card is the route."""
    from kvxopt_tpu_torch.examples import l1regls, mcsdp
    A, y = l1regls_wide_data()
    w = mcsdp_data(MCSDP_WIDE)
    return {f"l1regls {L1REGLS_WIDE}": lambda: l1regls.l1regls(A, y)[1],
            f"mcsdp n={MCSDP_WIDE}": lambda: mcsdp.mcsdp(w)}


def examples_cpu():
    """In a worker process: phase 19's calls on the CPU
    (config.using_device('cpu')), one untimed call then 3 timed -> name ->
    (rows, median ms), (a)'s calls and (b)'s wide ones."""
    from kvxopt_tpu_torch import config
    out = {}
    with config.using_device("cpu"):
        calls = example_calls()
        calls.update(wide_calls())
        for name, fn in calls.items():
            res, lps = _run_example(fn)
            ms = _cpu_ms(lambda: _run_example(fn))
            out[name] = (example_rows(name, res, lps), ms)
    return out


def _record_routes():
    """Wrap config.dispatch_device(_batched) -> (the list of (kind, order,
    route) decisions they make, a function that restores them)."""
    from kvxopt_tpu_torch import config
    seen, saved = [], (config.dispatch_device, config.dispatch_device_batched)

    def wrap(fn, kind):
        def decide(order):
            dev = fn(order)
            where = (dev if dev is not None else config.default_device).type
            seen.append((kind, int(order), where))
            return dev
        return decide
    config.dispatch_device = wrap(saved[0], "single")
    config.dispatch_device_batched = wrap(saved[1], "batched")

    def restore():
        config.dispatch_device, config.dispatch_device_batched = saved
    return seen, restore


# calls whose work goes through no front end's route
NOT_ROUTED = {"book covsel": "cholmod's tile path on config.default_device",
              "book smoothrec": "lapack on the host",
              "book inputdesign": "lapack on the host"}


def _route_text(name, seen):
    """Each dispatch decision of a call, as (kind, KKT order, the device
    it ran on), in order."""
    if not seen:
        return NOT_ROUTED.get(name, "operator-form P or G: no KKT order, "
                              "never routed")
    return "; ".join(f"{kind} order {order} -> {where}"
                     for kind, order, where in dict.fromkeys(seen))


def examples(dev):
    """Phase 19, "examples": (a) every call of example_calls on the card,
    both thresholds 0, numpy data, no device named: the values its tests
    assert (check_example), its result tensors on the card (where it
    gives only numpy, device time seen by the profiler; lapack's host
    facades: no device work), the warm median of 3; K1-K4's counts over (a),
    printed; (b) with config.py's thresholds, the route each call takes,
    then l1regls at L1REGLS_WIDE and mcsdp at MCSDP_WIDE on the card and
    mcsdp at MCSDP_SMALL on the CPU; (c) weak_scaling_sharded at world 1
    over NCCL.  Thresholds 0 again at the end.  Returns name -> (rows,
    card ms) for examples_compare."""
    from kvxopt_tpu_torch import config, ops
    from kvxopt_tpu_torch.examples import mcsdp, weak_scaling_sharded as ws
    set_thresholds(0, 0)
    calls = example_calls()
    gpu = {}
    torch.cuda.synchronize()
    ops.reset_launches()
    for name, fn in calls.items():
        res = {}

        def run():
            res["out"], res["lps"] = _run_example(fn)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        out, lps = res["out"], res["lps"]
        try:
            check_example(name, out, lps)
        except AssertionError as e:
            fail(f"examples (a) {name}: {e}")
        devs = _result_devices(out, lps)
        if name in HOST_ONLY:
            seen = "host facade (lapack), no device work"
            check(not devs, f"examples (a) {name}: a result on a device")
        elif devs:
            check(devs == {"cuda"}, f"examples (a) {name}: results on "
                  f"{sorted(devs)}, not on the card")
            seen = "every result tensor on the card"
        else:
            # portfolio's and covsel's outputs are numpy: the profiler's
            # device time shows their work on the card
            _, on_dev, _, _, why = trace(run)
            check(len(on_dev) > 0, f"examples (a) {name}: the profiler saw "
                  "no device time")
            busy = sum(e.self_device_time_total for e in on_dev) / 1e3
            seen = (f"device {busy:.3f} ms in a profiled call" if why is None
                    else f"device events seen ({why})")
        ms = 1e3 * float(np.median(warm_times(run)))
        rows = example_rows(name, res["out"], res["lps"])
        print(f"examples (a) {name}: statuses "
              f"{[r[0] for r in rows]}, iterations {[r[1] for r in rows]}, "
              f"card warm median {ms:.2f} ms (first call {1e3 * first:.2f} "
              f"ms), {seen}", flush=True)
        gpu[name] = (rows, ms)
    launches = dict(ops.LAUNCHES)
    print(f"examples (a) K1-K4 launches over every call: {launches} (the "
          "examples solve in f64; K1-K4 fire only in chol2_mixed(_nofb) "
          "and ops.batched_cholesky)", flush=True)
    stamp("phase 19(a)")

    set_thresholds(config.HOST_DISPATCH, config.HOST_DISPATCH_BATCHED)
    for name, fn in calls.items():
        seen, restore = _record_routes()
        try:
            out, lps = _run_example(fn)
        finally:
            restore()
        devs = sorted(_result_devices(out, lps)) or ["host"]
        print(f"examples (b) route {name} (thresholds "
              f"{config.host_dispatch_threshold}/"
              f"{config.host_dispatch_threshold_batched}): "
              f"{_route_text(name, seen)}; results on {devs}", flush=True)
    for name, fn in wide_calls().items():
        seen, restore = _record_routes()
        try:
            sol = fn()
        finally:
            restore()
        on_card(f"examples (b) {name}", sol["x"])
        wall, on_dev, _, _, why = trace(fn)
        check(len(on_dev) > 0, f"examples (b) {name}: no device time")
        ms = 1e3 * float(np.median(warm_times(fn)))
        print(f"examples (b) {name}: {_route_text(name, seen)}; status "
              f"{sol['status']}, iterations {sol['iterations']}, card warm "
              f"median {ms:.2f} ms", flush=True)
        check(sol["status"] == "optimal", f"examples (b) {name}: status")
        gpu[name] = ([_row(sol["status"], sol["iterations"], sol["x"])], ms)
    seen, restore = _record_routes()
    try:
        sol = mcsdp.mcsdp(mcsdp_data(MCSDP_SMALL))
    finally:
        restore()
    print(f"examples (b) mcsdp n={MCSDP_SMALL}: {_route_text('', seen)}; "
          f"status "
          f"{sol['status']}, x on {sol['x'].device.type}", flush=True)
    check(sol["status"] == "optimal" and sol["x"].device.type == "cpu",
          f"examples (b) mcsdp n={MCSDP_SMALL}: not solved on the CPU")
    set_thresholds(0, 0)
    stamp("phase 19(b)")

    t, ux = ws.run(1, WS_ROWS, WS_N, reps=5, device="cuda:0",
                   backend="nccl")
    G, s, z, bx, bz = ws.problem(WS_ROWS, WS_N)
    d2 = z / s
    uref = np.linalg.solve(np.eye(WS_N) + G.T @ (d2[:, None] * G),
                           bx + G.T @ (d2 * bz))
    du = np.linalg.norm(ux - uref) / (1 + np.linalg.norm(uref))
    print("examples (c) weak_scaling_sharded, world 1 over NCCL on cuda:0:\n"
          "ndev  rows    factor+solve ms   weak-scaling eff\n"
          f"{1:4d}  {WS_ROWS:6d}  {t * 1e3:12.2f}      {1.0:.2f}\n"
          f"examples (c) |ux-u_dense|/(1+|u_dense|) {du:.3e} (tol 1e-8)",
          flush=True)
    check(du <= 1e-8, "examples (c): the sharded step differs from the "
          "dense solve")
    stamp("phase 19(c)")
    return gpu


def examples_compare(pending, gpu):
    """Phase 19 against the CPU: per call every solve's status, iterations
    within 1, x within 1e-6 (1 + |x|); each call's card and CPU warm
    medians."""
    try:
        cpu = pending.get()
    except Exception as e:  # noqa: BLE001  (the worker's error, reported)
        fail(f"examples: the CPU side raised {e!r}")
    print("examples table: name | card ms | cpu ms (warm medians of 3)")
    for name, (rows, ms) in gpu.items():
        crows, cms = cpu[name]
        check(len(rows) == len(crows), f"examples {name}: {len(rows)} "
              f"solves on the card, {len(crows)} on the CPU")
        dx = 0.0
        for (st, it, x), (cst, cit, cx) in zip(rows, crows):
            check(st == cst and abs(it - cit) <= 1, f"examples {name}: "
                  f"status/iterations {st}/{it} on the card, {cst}/{cit} on "
                  "the CPU")
            if x is not None or cx is not None:
                dx = max(dx, np.linalg.norm(x - cx) /
                         (1 + np.linalg.norm(cx)))
        print(f"examples {name} | {ms:.2f} | {cms:.2f} | max "
              f"|x_card-x_cpu|/(1+|x_cpu|) {dx:.3e} (tol 1e-6)", flush=True)
        check(dx <= 1e-6, f"examples {name}: x differs from the CPU")


# phase 18, "dispatch": the executor dispatch's crossovers and routes
DISPATCH_N = (4, 16, 64, 128, 256, 512)   # (a) single-instance n, m = 2n
DISPATCH_NB = (16, 64, 128, 256, 512)     # (b) batched n, B = 16
DISPATCH_NB_MORE = (1024, 2048)           # (b) where the CPU wins at 512
DISPATCH_NK = (8, 16, 32, 64, 128, 256)   # (c) K1-K3 against torch.linalg
ROUTE_T = 128   # (d) both thresholds of the routing checks


def cpu_model():
    """The host CPU from /proc/cpuinfo: its model name, vendor, family,
    model and stepping, logical CPUs and whether it has AVX-512 and AMX
    (a sandbox may give the model name as "unknown")."""
    info, cpus = {}, 0
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, val = line.partition(":")
            key = key.strip()
            cpus += key == "processor"
            info.setdefault(key, val.strip())
    flags = info.get("flags", "").split()
    return (f"{info.get('model name', 'not given')} ({info.get('vendor_id')}"
            f" family {info.get('cpu family')} model {info.get('model')} "
            f"stepping {info.get('stepping')}, {cpus} logical CPUs, avx512f "
            f"{'avx512f' in flags}, amx {'amx_tile' in flags})")


def set_thresholds(single, batched):
    from kvxopt_tpu_torch import config
    config.host_dispatch_threshold = single
    config.host_dispatch_threshold_batched = batched


def orthant_lp(seed, n):
    """A bounded LP on large_problem(seed, n, 2n)'s G and h: c = -G'z0
    with z0 uniform(0.5, 1.5), so (z0, 0) is dual feasible."""
    _, _, G, h = large_problem(seed, n, 2 * n)
    z0 = np.random.default_rng(seed + 1).uniform(0.5, 1.5, 2 * n)
    return -G.T @ z0, G, h


DISPATCH_REPS = 5
DISPATCH_REPS_E = 3


def card_and_cpu(fn, cpu_fn=None, reps=DISPATCH_REPS):
    """fn() on the card and cpu_fn() on the CPU (by default fn under
    config.using_device('cpu')), dispatch off: per side one untimed call,
    then `reps` warm calls taken in turns, card then CPU -> (card s, cpu
    s, card result, cpu result), each time a median."""
    from kvxopt_tpu_torch import config

    def on_cpu():
        with config.using_device("cpu"):
            return fn()
    sides = (fn, cpu_fn or on_cpu)
    res = [f() for f in sides]
    ts = [[], []]
    for _ in range(reps):
        for t, f in zip(ts, sides):
            t += warm_times(f, reps=1)
    return float(np.median(ts[0])), float(np.median(ts[1])), res[0], res[1]


def crossover(ns, card, cpu):
    """The smallest n of ns from which the card is faster at every larger
    n swept (None where the CPU wins at the largest); card and cpu map a
    label to its times over ns, and every label must be won."""
    x = None
    for i in range(len(ns) - 1, -1, -1):
        if not all(card[k][i] < cpu[k][i] for k in card):
            break
        x = ns[i]
    return x


def threshold_of(x, ns):
    """The threshold a crossover gives: 0 where the card wins at every n
    swept, else the crossover itself ('> max' where there is none)."""
    if x is None:
        return f"> {ns[-1]}"
    return 0 if x == ns[0] else x


def same_solution(label, sol, ref):
    """A routed front-end result against the card-forced call's: same
    status, iterations within 1, x within 1e-6 (1 + |x|)."""
    x, xr = (np.asarray(r["x"].cpu()) for r in (sol, ref))
    dx = np.linalg.norm(x - xr) / (1 + np.linalg.norm(xr))
    print(f"dispatch (d) {label}: on {sol['x'].device.type}, status "
          f"{sol['status']}, iterations {sol['iterations']} (card "
          f"{ref['iterations']}), |x-x_card|/(1+|x_card|) {dx:.3e} (tol "
          "1e-6)", flush=True)
    check(sol["status"] == ref["status"] and
          abs(sol["iterations"] - ref["iterations"]) <= 1 and dx <= 1e-6,
          f"dispatch (d) {label}: differs from the card-forced call")


def dispatch_single(dev):
    """Phase 18(a): solvers.qp and solvers.lp with numpy data on the
    orthant problems at DISPATCH_N, and the userguide LP, SOCP and SDP,
    on the card and on the CPU -> the crossover."""
    from kvxopt_tpu_torch import solvers
    card, cpu = {"qp": [], "lp": []}, {"qp": [], "lp": []}
    for n in DISPATCH_N:
        P, q, G, h = large_problem(0, n, 2 * n)
        c = orthant_lp(0, n)[0]
        for name, fn in (("qp", lambda: solvers.qp(P, q, G, h)),
                         ("lp", lambda: solvers.lp(c, G, h))):
            tc, tp, sc, sp = card_and_cpu(fn)
            card[name].append(tc)
            cpu[name].append(tp)
            check(sc["status"] == sp["status"] == "optimal",
                  f"dispatch (a) {name} n={n}: status {sc['status']} / "
                  f"{sp['status']}")
            print(f"dispatch (a) {name} n={n} m={2 * n} (order {3 * n}): card "
                  f"{1e3 * tc:.4f} ms, cpu {1e3 * tp:.4f} ms (warm median "
                  f"of {DISPATCH_REPS}), iterations {sc['iterations']} / "
                  f"{sp['iterations']}", flush=True)
    lp, socp, sdp = userguide_data()[:3]
    for name, fn in (
            ("lp userguide n=2", lambda: solvers.lp(*lp)),
            ("socp userguide n=3", lambda: solvers.socp(
                socp[0], Gq=socp[1], hq=socp[2])),
            ("sdp userguide n=3", lambda: solvers.sdp(
                sdp[0], Gs=sdp[1], hs=sdp[2]))):
        tc, tp, _, _ = card_and_cpu(fn)
        print(f"dispatch (a) {name}: card {1e3 * tc:.4f} ms, cpu "
              f"{1e3 * tp:.4f} ms (warm median of {DISPATCH_REPS})",
              flush=True)
    orders = [3 * n for n in DISPATCH_N]
    return crossover(orders, card, cpu), orders


def dispatch_batched(dev):
    """Phase 18(b): batched_qp_solver(ConeDims(l=2n), 'chol2') and
    batched_lp_solver on B=16 orthant problems at DISPATCH_NB (and
    DISPATCH_NB_MORE where the CPU still wins at 512), tensors on the
    card against CPU tensors -> the crossover."""
    from kvxopt_tpu_torch import ConeDims
    from kvxopt_tpu_torch.parallel import batched_lp_solver, batched_qp_solver
    card, cpu = {"qp": [], "lp": []}, {"qp": [], "lp": []}
    ns = []

    def sweep(n):
        qp = [np.stack(a) for a in zip(*(large_problem(s, n, 2 * n)
                                         for s in SEEDS))]
        lp = [np.stack(a) for a in zip(*(orthant_lp(s, n) for s in SEEDS))]
        for name, solve, data in (
                ("qp", batched_qp_solver(ConeDims(l=2 * n), "chol2"), qp),
                ("lp", batched_lp_solver(ConeDims(l=2 * n)), lp)):
            on = [[torch.from_numpy(a).to(d) for a in data]
                  for d in (dev, torch.device("cpu"))]
            tc, tp, oc, op = card_and_cpu(lambda: solve(*on[0]),
                                          lambda: solve(*on[1]))
            st = 5 if name == "qp" else 7
            check(bool((oc[st].cpu() == op[st]).all()) and
                  (n not in DISPATCH_NB or bool((op[st] == 1).all())),
                  f"dispatch (b) {name} n={n}: statuses {oc[st].tolist()} "
                  f"on the card, {op[st].tolist()} on the CPU")
            card[name].append(tc)
            cpu[name].append(tp)
            print(f"dispatch (b) batched {name} B={B} n={n} m={2 * n} (order "
                  f"{3 * n}): card "
                  f"{tc:.4f} s, cpu {tp:.4f} s (warm median of "
                  f"{DISPATCH_REPS})", flush=True)
        ns.append(3 * n)

    for n in DISPATCH_NB:
        sweep(n)
    for n in DISPATCH_NB_MORE:
        if card["qp"][-1] < cpu["qp"][-1] and card["lp"][-1] < cpu["lp"][-1]:
            break
        sweep(n)
    return crossover(ns, card, cpu), ns


def dispatch_kernels(dev):
    """Phase 18(c): K1, K2 (k=1) and K3 (k=n) against cholesky_ex,
    cholesky_solve and solve_triangular at B=16 over DISPATCH_NK, host
    median of 20 each -> the n from which the factor and its two solves
    together (the sum of the three) are faster on the kernels at every
    larger n."""
    from kvxopt_tpu_torch.ops import chol_ls as cl
    kern = {"K1": [], "K2": [], "K3": []}
    lib = {"K1": [], "K2": [], "K3": []}
    for n in DISPATCH_NK:
        K = spd_batch(B, n, 12, dev)
        L, Dinv = cl.batched_cholesky_ls(K)
        b = torch.randn((B, n), device=dev)
        R = torch.randn((B, n, n), device=dev)
        rows = (("K1", lambda: cl.batched_cholesky_ls(K),
                 lambda: torch.linalg.cholesky_ex(K)),
                ("K2", lambda: cl.chol_solve_ls(L, Dinv, b),
                 lambda: torch.cholesky_solve(b[..., None], L)),
                ("K3", lambda: cl.tri_solve_ls(L, Dinv, R),
                 lambda: torch.linalg.solve_triangular(L, R, upper=False)))
        for name, fk, fl in rows:
            kern[name].append(median_ms(fk))
            lib[name].append(median_ms(fl))
        tk, tl = (sum(t[k][-1] for k in t) for t in (kern, lib))
        print(f"dispatch (c) B={B} n={n}: " + ", ".join(
            f"{k} {kern[k][-1]:.4f} ms vs {lb} {lib[k][-1]:.4f} ms"
            for k, lb in (("K1", "cholesky_ex"), ("K2", "cholesky_solve"),
                          ("K3", "solve_triangular"))) +
            f"; factor + solves {tk:.4f} ms vs {tl:.4f} ms (host, medians "
            "of 20)", flush=True)
    total = ({"all": [sum(v) for v in zip(*t.values())]} for t in (kern, lib))
    return crossover(DISPATCH_NK, *total)


def dispatch_workloads(dev):
    """Phase 18(e): the repo's own single-instance solves that a size
    rule could route, numpy data as phases 13 and 15 give them: phase
    13's gp and acent2 solves and its l+q+s cpl, and phase 15's five PWL
    models through op.solve, each on the card and on the CPU, warm median
    of DISPATCH_REPS_E, beside its sizes: n variables, mnl nonlinear
    constraints, m rows of G, p rows of A, their sum the KKT order that
    routes it, and the route the default thresholds give it."""
    from kvxopt_tpu_torch import config

    def on_cpu(fn):
        def call():
            with config.using_device("cpu"):
                return fn()
        return call
    calls = nonlinear_calls(dev)
    cpu_calls = nonlinear_calls(torch.device("cpu"))
    rows = []
    for name in ("gp userguide", "gp seeded"):
        K, F, _ = gp_userguide() if name == "gp userguide" else gp_data()
        rows.append((name, calls[name], on_cpu(cpu_calls[name]),
                     (F.shape[1], len(K) - 1, 0, 0)))
    for name, sizes in (("cp acent2", (3, 1, len(ACENT2_H), 0)),
                        ("cpl l+q+s+ball", (N, 1, M, 0))):
        rows.append((name, calls[name], on_cpu(cpu_calls[name]), sizes))
    for name, (prob, _) in pwl_models().items():
        c, _, G, _, A = prob._build_lp()[:5]
        rows.append((f"op.solve {name}", prob.solve, on_cpu(prob.solve),
                     (len(c), 0, G.shape[0], 0 if A is None else A.shape[0])))
    for name, fn, cpu_fn, (n, mnl, m, p) in rows:
        tc, tp, _, _ = card_and_cpu(fn, cpu_fn, reps=DISPATCH_REPS_E)
        order = n + mnl + m + p
        route = "cpu" if order < config.HOST_DISPATCH else "card"
        print(f"dispatch (e) {name}: n={n} mnl={mnl} m={m} p={p} (order "
              f"{order}): card {1e3 * tc:.4f} ms, cpu {1e3 * tp:.4f} ms (warm "
              f"median of {DISPATCH_REPS_E}); the default thresholds send it "
              f"to the {route}, the {'card' if tc < tp else 'cpu'} is "
              "faster", flush=True)


DISPATCH_OFF_CHECK = """
import importlib, os, sys
import numpy as np
import chip_smoke as c
from kvxopt_tpu_torch import config as cfg, solvers
lp = c.userguide_data()[0]
for value, want in (("0", "cuda"), (sys.argv[1], "cpu")):
    os.environ["KVXOPT_TPU_HOST_DISPATCH"] = value
    cfg = importlib.reload(cfg)
    got = solvers.lp(*lp)["x"].device.type
    print(f"KVXOPT_TPU_HOST_DISPATCH={value}: thresholds "
          f"{cfg.host_dispatch_threshold}, "
          f"{cfg.host_dispatch_threshold_batched}; dispatch_device(1) "
          f"{cfg.dispatch_device(1)}, dispatch_device_batched(1) "
          f"{cfg.dispatch_device_batched(1)}; userguide lp on {got}")
    assert got == want, (value, got)
    if value == "0":
        assert cfg.dispatch_device(1) is None
        assert cfg.dispatch_device_batched(1) is None
"""


def dispatch_routes(dev):
    """Phase 18(d): the routing checks, both thresholds ROUTE_T."""
    from kvxopt_tpu_torch import ConeDims, ops, solvers
    from kvxopt_tpu_torch.parallel import batched_lp_solver, batched_qp_solver
    lp, socp, sdp = userguide_data()[:3]
    P, q, G, h = large_problem(0)
    calls = {
        "lp userguide n=2": (lambda: solvers.lp(*lp), "cpu"),
        "socp userguide n=3": (lambda: solvers.socp(
            socp[0], Gq=socp[1], hq=socp[2]), "cpu"),
        "sdp userguide n=3": (lambda: solvers.sdp(
            sdp[0], Gs=sdp[1], hs=sdp[2]), "cpu"),
        f"coneqp orthant n={N}": (lambda: solvers.coneqp(
            P, q, G, h, {"l": M}), "cuda")}
    for label, (fn, want) in calls.items():
        set_thresholds(0, 0)
        ref = fn()
        set_thresholds(ROUTE_T, ROUTE_T)
        sol = fn()
        check(ref["x"].device.type == "cuda" and
              sol["x"].device.type == want,
              f"dispatch (d) {label}: on {sol['x'].device}, expected {want}")
        same_solution(label, sol, ref)

    n = 32
    host = [np.stack(a) for a in zip(*(orthant_lp(s, n) for s in SEEDS))]
    data = [torch.from_numpy(a).to(dev) for a in host]
    solve = batched_lp_solver(ConeDims(l=2 * n))
    set_thresholds(0, 0)
    ref = solve(*data)
    set_thresholds(ROUTE_T, ROUTE_T)
    for label, args, want in (("numpy", host, "cpu"),
                              ("CUDA tensors", data, "cuda")):
        out = solve(*args)
        xsz = [torch.cat([o[k] / o[4][:, None] for k in (0, 2, 3)], 1).cpu()
               for o in (out, ref)]
        dx = float(((xsz[0] - xsz[1]).norm(dim=1) /
                    (1 + xsz[1].norm(dim=1))).max())
        its = [o[6].cpu() for o in (out, ref)]
        print(f"dispatch (d) batched lp B={B} n={n}, {label}: results on "
              f"{out[0].device.type}, iterations {its[0].tolist()} (card "
              f"{its[1].tolist()}), max |(x,s,z)/tau - card's|/(1+|card's|) "
              f"{dx:.3e} (tol 1e-6)", flush=True)
        check(all(a.device.type == want for a in out[:8]) and
              bool((out[7].cpu() == ref[7].cpu()).all()) and
              bool(((its[0] - its[1]).abs() <= 1).all()) and dx <= 1e-6,
              f"dispatch (d) batched lp, {label}: not on {want}, or differs "
              "from the card")

    # a mixed strategy given numpy data, and f32 chol2 given CUDA tensors,
    # both below the threshold: each stays on the card and runs K1
    qp = [np.stack(a) for a in zip(*(large_problem(s, n, 2 * n)
                                     for s in SEEDS))]
    for strategy, label, args in (
            ("chol2_mixed_nofb", "numpy", qp),
            ("chol2", "f32 CUDA tensors",
             [torch.from_numpy(a).to(dev, torch.float32) for a in qp])):
        torch.cuda.synchronize()
        ops.reset_launches()
        out = batched_qp_solver(ConeDims(l=2 * n), strategy)(*args)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        print(f"dispatch (d) batched qp {strategy}, {label}, B={B} n={n}: "
              f"results on {out[0].device.type}, launches {launches}",
              flush=True)
        check(out[0].device.type == "cuda" and launches["K1"] > 0,
              f"dispatch (d) {strategy}, {label}: left the card or ran no K1")

    set_thresholds(0, 0)
    sol = solvers.lp(*lp)
    check(sol["x"].device.type == "cuda",
          "dispatch (d) threshold 0: the userguide lp left the card")
    print("dispatch (d) thresholds 0: userguide lp on the card", flush=True)

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KVXOPT_TPU_HOST_DISPATCH")}
    out = subprocess.run(
        [sys.executable, "-c", DISPATCH_OFF_CHECK, str(ROUTE_T)], env=env,
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    print(out.stdout.strip(), flush=True)
    check(out.returncode == 0, "dispatch (d) KVXOPT_TPU_HOST_DISPATCH in a "
          f"fresh process: {out.stderr.strip()[-2000:]}")


def dispatch(dev):
    """Phase 18, "dispatch": (a)-(c) the sweeps and (e) the repo's own
    solves, each with dispatch off, then (d) the routing checks; the
    measured crossovers beside the defaults of config.py and
    ops/ipm_chol.py (0: no threshold there).  Restores the defaults."""
    from kvxopt_tpu_torch import config
    print(f"dispatch: host {cpu_model()}, torch.get_num_threads() "
          f"{torch.get_num_threads()}, card "
          f"{sh(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'])}",
          flush=True)
    set_thresholds(0, 0)
    x1, n1s = dispatch_single(dev)
    stamp("phase 18(a)")
    xb, nbs = dispatch_batched(dev)
    stamp("phase 18(b)")
    xk = dispatch_kernels(dev)
    stamp("phase 18(c)")
    dispatch_workloads(dev)
    stamp("phase 18(e)")
    for label, x, ns, default in (
            ("host_dispatch_threshold", x1, n1s, config.HOST_DISPATCH),
            ("host_dispatch_threshold_batched", xb, nbs,
             config.HOST_DISPATCH_BATCHED),
            ("ops/ipm_chol.py: the n below which torch.linalg's factor and "
             "solves win", xk, DISPATCH_NK, 0)):
        got = threshold_of(x, ns)
        print(f"dispatch crossover {label}: measured {got} (card faster from "
              f"{x} on, over {list(ns)}), default {default}"
              + ("" if got == default else " (differs)"), flush=True)
    dispatch_routes(dev)
    set_thresholds(config.HOST_DISPATCH, config.HOST_DISPATCH_BATCHED)
    stamp("phase 18(d)")


def cpu_solve(name, threads):
    """In a worker process: the phase's problems on CPU tensors, the
    kernels' plain versions -> (x, iterations, status, seconds); x over
    tau for the LP batch; phase 13's as nonlinear_cpu gives them."""
    os.nice(10)
    torch.set_num_threads(threads)
    if name == "nonlinear":
        return nonlinear_cpu()
    if name == "sparse":
        return sparse_cpu()
    if name == "modeling":
        return modeling_cpu()
    if name == "examples":
        return examples_cpu()
    from kvxopt_tpu_torch import ConeDims, solvers
    from kvxopt_tpu_torch.convert import (lp_state_to_numpy,
                                          problem_to_torch, state_to_numpy)
    from kvxopt_tpu_torch.parallel import (batched_lp_solver,
                                           batched_qp_solver_mixed)
    if name == "lp batch":
        data = problem_to_torch(*grid_scenarios(), device="cpu")
        t0 = time.perf_counter()
        out = lp_state_to_numpy(batched_lp_solver(
            ConeDims(l=2 * K_GRID), options=LP_OPTIONS)(*data))
        return (out[0] / out[4][:, None], out[6], out[7],
                time.perf_counter() - t0)
    if name == "conelp l+q+s":
        data = [torch.from_numpy(a) for a in lqs_lp(0)]
        t0 = time.perf_counter()
        sol = solvers.conelp(*data, LQS_DIMS)
        return (sol["x"].numpy()[None], np.array([sol["iterations"]]),
                np.array([sol["status"]]), time.perf_counter() - t0)
    dims, data = slice_data(name)
    # facref explicit: on the card the "vmap" default resolves it on
    solve = batched_qp_solver_mixed(dims, {"facref": True},
                                    with_eq=len(data) == 6)
    t0 = time.perf_counter()
    out = state_to_numpy(solve(*problem_to_torch(*data, device="cpu")))
    return out[0], out[4], out[5], time.perf_counter() - t0


def start_cpu_solves(names, workers=3):
    """The CPU solves of phases 4, 6, 10 and 11-15 in `workers`
    spawned processes (no CUDA state is forked), sharing the cores the
    card's phases leave; they start in the order of `names`."""
    global POOL
    threads = max(1, ((os.cpu_count() or 4) - 2) // workers)
    POOL = multiprocessing.get_context("spawn").Pool(workers)
    return {n: POOL.apply_async(cpu_solve, (n, threads)) for n in names}


def cpu_phase(name, pending, gpu):
    """The card's solve against the same problems on CPU tensors."""
    try:
        x, it, status, secs = pending.get()
    except Exception as e:  # noqa: BLE001  (the worker's error, reported)
        fail(f"{name}: the CPU plain path raised {e!r}")
    xg, itg, stg = gpu
    dx = np.linalg.norm(xg - x, axis=1) / (1 + np.linalg.norm(x, axis=1))
    print(f"{name} cpu plain path: {secs:.1f} s, status "
          f"{status.tolist()}, iterations {it.tolist()}, max "
          f"|x_gpu-x_cpu|/(1+|x_cpu|) {dx.max():.3e} (tol 1e-6)", flush=True)
    check((status == stg).all(), f"{name}: status differs from the CPU "
          "plain path")
    check((np.abs(it - itg) <= 1).all(), f"{name}: iterations differ by "
          "more than 1")
    check(dx.max() <= 1e-6, f"{name}: x differs from the CPU plain path")


def main():
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    dev = torch.device("cuda:0")
    # phases 1-17 measure the card: executor dispatch off, here and in
    # every process they start; phase 18 restores it
    for var in ("KVXOPT_TPU_HOST_DISPATCH", "KVXOPT_TPU_HOST_DISPATCH_BATCHED"):
        os.environ[var] = "0"
    phase0()
    set_thresholds(0, 0)
    stamp("phase 0")
    # the longest CPU solve first, then the two short ones of phases 11
    # and 12, so that the other two start once those are done
    pending = start_cpu_solves(("slice l+q+s", "lp batch", "conelp l+q+s",
                                "nonlinear", "sparse", "modeling", "slice",
                                "slice l+q+eq", "examples"))
    rows = phase1(dev)
    k1_times(dev)
    stamp("phase 1")
    rows["K4"], k4_launches = phase2(dev)
    scaling_rows(dev)
    stamp("phase 2")
    rows["K5"], k5_launches = k5(dev)
    stamp("phase 2b")
    rows["K6"], k6_launches = k6(dev)
    stamp("phase 2c")
    rows["K7"], k7_launches = k7(dev)
    stamp("phase 2d")

    gpu, _, _, walls3 = solve_phase("slice", dev, *slice_data("slice"))
    stamp("phase 3")
    gpu_eq, _, shapes, _ = solve_phase("slice l+q+eq", dev,
                                    *slice_data("slice l+q+eq"))
    check(shapes.get(("K1", P_EQ, 0), 0) > 0,
          "K1 never factored the Schur complement (n=p)")
    check(shapes.get(("K2", N, P_EQ), 0) > 0,
          "K2 never ran with k=p right-hand sides")
    stamp("phase 5")
    gpu_s, launches, _, _ = solve_phase("slice l+q+s", dev,
                                     *slice_data("slice l+q+s"))
    nan_check(dev)
    stamp("phase 7")
    chol_check(dev, gpu_s[0])
    stamp("phase 8")
    ldl_check(dev)
    stamp("phase 9")
    gpu_lp = lp_batch(dev)
    stamp("phase 11")
    gpu_lqs = front_ends(dev)
    stamp("phase 12")
    gpu_nl = nonlinear(dev)
    stamp("phase 13")
    gpu_sp, sparse_launches = sparse(dev)
    stamp("phase 14")
    gpu_md = modeling(dev)
    stamp("phase 15")
    seq_launches = seq_misc(dev, gpu[0], walls3)
    stamp("phase 16")
    mesh_launches = multi_device(dev, gpu)
    stamp("phase 17")
    gpu_ex = examples(dev)
    stamp("phase 19")
    for name, g in (("slice", gpu), ("slice l+q+eq", gpu_eq),
                    ("slice l+q+s", gpu_s), ("lp batch", gpu_lp),
                    ("conelp l+q+s", gpu_lqs)):
        cpu_phase(name, pending[name], g)
    nonlinear_compare(pending["nonlinear"], gpu_nl)
    sparse_compare(pending["sparse"], gpu_sp)
    modeling_compare(pending["modeling"], gpu_md)
    examples_compare(pending["examples"], gpu_ex)
    POOL.close()
    POOL.join()
    stamp("phases 4, 6, 10 and the CPU sides of 11-15 and 19")
    dispatch(dev)
    stamp("phase 18")

    launches["K4"] = k4_launches
    launches["K5"] = k5_launches
    launches["K6"] = k6_launches
    launches["K7"] = k7_launches
    replaces = {"K1": "kvxopt_tpu/ops/chol_ls.py:358",
                "K2": "kvxopt_tpu/ops/chol_ls.py:517",
                "K3": "kvxopt_tpu/ops/chol_ls.py:592",
                "K4": "kvxopt_tpu/ops/chol.py:139",
                "K5": "none (the JAX package leaves f64 solves to XLA)",
                "K6": "none (the JAX package leaves f64 factors to XLA)",
                "K7": "none (the JAX package leaves chol2's K to XLA)"}
    sources = {"K1": "kvxopt_tpu_torch/csrc/chol_ls.cu",
               "K2": "kvxopt_tpu_torch/csrc/chol_solve.cu",
               "K3": "kvxopt_tpu_torch/csrc/tri_solve.cu",
               "K4": "kvxopt_tpu_torch/csrc/chol.cu",
               "K5": "kvxopt_tpu_torch/csrc/chol_solve64.cu",
               "K6": "kvxopt_tpu_torch/csrc/chol64.cu",
               "K7": "kvxopt_tpu_torch/csrc/gram64.cu"}
    bounds = kernel_bounds()
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k],
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": rows[k]["err"], "ms": rows[k]["ms"],
         "plain_ms": rows[k]["plain"], "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": rows[k]["lib"],
         "launches_phase14": sparse_launches[k],
         "launches_phase16": seq_launches[k],
         "launches_phase17": mesh_launches.get(k, 0)}
        for k in replaces]}))
    print(sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
