"""The repo's example programs on the port.

One module per script of the JAX package's examples/ directory, with the
same file names, functions and main(...) signatures and defaults, and
book/ with the cvxbook problems of the JAX package's
tests/test_book_examples*.py.  Data comes in as numpy arrays, as a user
passes it, and nothing names a device: the front ends place it on
kvxopt_tpu_torch.config.default_device.  A custom kktsolver, P or G
closure builds its tensors on the device of what it is handed (W.d in a
kktsolver, the argument in P and G; _data.OnDevice).

Running them
------------
    python -m kvxopt_tpu_torch.examples.lp

runs on the card, except where the executor dispatch sends a small
solve to the CPU: with KVXOPT_TPU_HOST_DISPATCH at its default (768) a
front-end solve whose KKT system has order n + m + p below it runs on
the CPU (a batch below KVXOPT_TPU_HOST_DISPATCH_BATCHED, 384 per
instance).  At the examples' sizes that is every solve but those of l1,
l1regls and book tv (operator-form P or G: no order, never routed),
normappr's max|Ax + b| LP (order 1250), l1svc's two LPs (order 800) and
covsel's cholmod tile path (no front end; config.default_device); phase
19(b) of chip_smoke.py prints each route.  KVXOPT_TPU_HOST_DISPATCH=0
keeps every solve on the card; set it before the first import.  In a
program:

    from kvxopt_tpu_torch import config
    from kvxopt_tpu_torch.examples import l1regls
    with config.using_device("cpu"):      # everything on the CPU
        x, sol, A, y = l1regls.main()
    config.host_dispatch_threshold = 0    # everything on the card
    config.host_dispatch_threshold_batched = 0

Without a card and with no device named, a call raises: nothing falls
back to the CPU.

What each group exercises
-------------------------
- lp, socp, sdp, conelp, coneqp, gp: the front ends on numpy data (the
  userguide problems of chapters 8 and 9).
- l1, l1regls, qcl1, mcsdp, chebyshev, robls, portfolio: custom KKT
  solvers with operator-form G (l1) and P and G (l1regls), an SOCP, an
  SDP whose KKT order grows as n^2 (mcsdp), LPs and SOCPs built by hand,
  and portfolio's sweep through parallel.batched_qp_solver.
- normappr, roblp, l1svc, lp_modeling, dsdp_dual_scaling: the modeling
  DSL (op.solve over solvers.lp) and the DSDP bridge, which runs its
  dual-scaling method on the host beside solvers.sdp.  normappr, roblp
  and l1svc draw their data with the port's gsl (its bits differ from
  the JAX package's); data(m, n, seed) returns it.
- acent, acent2, floorplan: cp and cpl with hand-written oracles.
- weak_scaling_sharded: sharded_kkt_solver in worlds of 1, 2, 4 and 8
  ranks over parallel.spawn (NCCL on cards of their own, gloo where
  ranks share a card or with --cpu).
- book.examples1 ... book.examples5: the cvxbook problems, each a pair
  <name>_data(seed) -> numpy data and <name>(data) -> the port's
  solution: huber, tv (operator-form P and G with a tridiagonal custom
  kktsolver), basispursuit, regsel, maxent, expdesign, covsel (cholmod's
  symbolic/numeric/solve/diag Newton loop; its tile path on the card);
  linsep, chernoff, placement, centers; l2ac (a matrix-inversion-lemma
  kktsolver for cp), logreg, penalties, cvxfit, smoothrec
  (lapack.ptsv); robls, ellipsoids, polapprox; consumerpref,
  inputdesign (lapack.gels), probbounds, filterdemo, rls.  lapack is a
  host facade in both packages, so smoothrec and inputdesign do no
  device work.

The parity tests are tests/test_torch_examples.py and
tests/test_torch_book_examples*.py (the JAX package's example on the
same numpy data, on the CPU); on the card, phase 19 of chip_smoke.py.
"""

#: the modules of examples/, in the order of the port
EXAMPLES = (
    "lp", "socp", "sdp", "conelp", "coneqp", "gp",
    "l1", "l1regls", "qcl1", "mcsdp", "chebyshev", "robls", "portfolio",
    "normappr", "roblp", "l1svc", "lp_modeling", "dsdp_dual_scaling",
    "acent", "acent2", "floorplan",
    "weak_scaling_sharded",
)
