#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stan_tpu_torch) on one GPU.

Phases, each of which raises on failure:
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build every CUDA kernel from stan_tpu_torch/csrc (one nvcc per source,
     started together), print the build time and the assembler's register
     reports; then build and load the host runtime (csrc/stanfem.cpp, the
     host C++ compiler; no kernel) and print its build time;
  3. stencil_sweep against its plain PyTorch version on the card, on the
     70^3 beam's tables, on a small odd grid, on the 32^3 grid, on one
     x-plane (SX = 1) of it, on a 6x9x140 beam (z over two tiles) and on
     the sharded phases' slab ([3, 20, 73, 73]: one of 4 x-slabs of the
     72-plane beam), with the x-face flags (1,1), (0,1), (1,0), (0,0), in
     float32 and float64, random ghosts;
  4. theta_sweep (one grid) against its plain version on the same two grids
     and on the 32^3 calibration grid (the shape its main path runs), with
     two coefficient pairs, one of them the 32^3 calibration's (λ, μ) at
     θ_true, and theta_sweep_batched at [16, 3, 35, 35, 35] (16 chains
     of the 32^3 grid, 16 distinct pairs) and on the small odd grid; then
     shapes that stress the kernel's tiling: one x-plane (SX = 1) with 16
     chains and with one, and a 6x9x140 beam (y and z extents no tile
     divides, z over two tiles) with 3 chains and with one, and the sharded
     forward's slab ([8, 3, 13, 35, 35]: one chain row of a 2 x 3 mesh on
     one of 3 x-slabs of the 32^3 grid); all four flag pairs, float32 and
     float64, random ghosts; and the placed chains' per-row batches of
     phase 22 ([4, 3, 35, 35, 35] and [8, 3, 35, 35, 35]: 16 chains and
     32 SMC particles over 4 rows), flags (1,1). The kernels line's
     max_abs_err is the float32 error at the single-device path's shape,
     flags (1,1), at a per-row batch, or at a sharded slab under any flag
     pair, whichever is largest;
  5. at the main paths' shapes ([3, 73, 73, 73], the 70^3 grid, for
     stencil_sweep; [3, 35, 35, 35], the 32^3 grid, for theta_sweep, and
     [3, 73, 73, 73] beside it; [16, 3, 35, 35, 35] for
     theta_sweep_batched, and phase 22's per-row [4, ...] and [8, ...]
     beside it), float32 and float64: each kernel's time with the
     L2 cache warm, by CUDA events around back-to-back wrapper calls in
     turns with its plain version (the kernels line's ms) and from CUDA-graph
     replays (ms_graph), and its time with the L2 flushed before each
     launch (ms_cold); its
     bound (the larger of one pass over its bytes at the HBM rate and its
     multiply-adds at the peak rate, data sheet) and share of it; and the
     time of one library call of the same function, torch.sparse.mm with
     K (or [K_λ | K_μ]) assembled as CSR, checked against the kernel;
     then the general operator's two kernels (csrc/general_apply.cu) at
     LE10's shapes (perfbench/plate.py, 331,776 HEX8_G2 elements), float32
     and float64: against the plain version (SWEEP_RTOL) and two applies
     to the bit, ms, ms_graph, ms_cold, the plain version's time, the
     bound of perfbench/rooflines/general_apply.py, the element kernel's
     and the node pass's device time under torch.profiler (a
     "general_apply" JSON line, and a row of the kernels line); then
     against the plain version at the general forward's shape (16 chains
     on the 32^3 beam, one D a chain expanded over the elements);
  6. the linear main path: solve_linear_statics(hex_beam(70, 70, 70),
     device="cuda") in float32 with float64 certification (1,073,733 DOF):
     operator "stencil", converged, certified residual <= 1e-6, at least
     one float32 stencil_sweep launch per CG iteration (base and
     corrections) and no float64 one (the certification's residual is
     read on the host, hostops.masked_f64_apply); prints the
     certification's split: host twin set-up, host sweeps, inner CG on
     the card and the copies between them;
  7. an independent check of that answer: the float64 residual with the
     structured operator (which does not use the kernel), and the support
     reactions balancing the loads;
  8. the cost of the CG loop's per-iteration host sync;
  9. the calibration main path, bench.py's 32^3 calibration (107,811 DOF):
     observations from the port's own forward at θ_true (theta_sweep),
     make_problem(device="cuda", float32, cg_tol=1e-6), then run_hmc with
     16 chains and 8 leapfrog steps (theta_sweep_batched): finite samples,
     acceptance above 0, at least one batched launch per iteration of the
     chain-batched CG loops, no unconverged forward solve at θ_true;
 10. the gradient of the calibration's log posterior on the card in float64
     against central finite differences, at one θ (log E, ν and load);
 11. the 24 result fields of the 70^3 solve (post.fields.compute_all, on
     the card in float64) against the same function on the CPU, to 1e-12
     of each field's largest magnitude, and the .vtu export of increment 1
     into a temporary directory (removed after);
 12. NUTS on the calibration posterior (run_nuts, 16 chains, max_depth 5,
     5 warmup + 3 samples, from the HMC phase's θ0): finite samples,
     acceptance above 0, at least one batched launch per iteration of the
     chain-batched CG loops, evals_per_sample at most 2^5 - 1;
 13. ADVI (10 steps of 8 ELBO draws) and SMC (32 particles, 2 Metropolis
     steps, 2 stages) on the same posterior: finite results, and rising
     temperatures for SMC; each with its batched launches and unconverged
     solves (prior draws of ν near 0.5 may stop at the CG cap);
 14. the direct solvers through solve_linear_statics(device="cuda"): dense
     Cholesky and LU on the card, float32 and float64, on hex_beam(20, 8,
     8) split into TET4 (5,103 DOF, under the 6000-DOF dense limit), and
     the banded float64 host solvers on hex_beam(60, 12, 12) (30,927
     DOF); each float64 answer within 1e-8 of max|u| of a float64 CG solve
     of the same model at tol 1e-13;
 15. Total-Lagrangian nonlinear statics on hex_beam(70, 70, 70), float32,
     2 increments, the tip load scaled from the linear solve of phase 6 so
     that the linear tip deflection is 3% of the side: converged, and the
     float64 relative residual of the returned u, from the internal force
     evaluated in float64 on the card, at most 1e-3;
 16. one 16-chain log-posterior gradient of the 32^3 calibration through
     the stencil, per-element-field (homogeneous broadcast) and general
     forwards, in float32 (timed) and in float64: u and the gradient agree
     to 1e-4 of their largest magnitude in float64, and to 1e-2 in float32
     (the float32 floor of the stencil and field operators);
 17. HMC through make_problem on the 32^3 beam with the elements at x >=
     L/2 a second material (E = 95000): the field forward, 16 chains, 8
     leapfrog steps, 3 warmup + 3 samples, its unconverged solves counted;
 18. the x-slab sharded stencil apply on hex_beam(71, 70, 70) (NNX = 72,
     1,088,856 DOF) over a 1 x 4 mesh (every visible card when there are
     4 or more, else [cuda:0] * 4), against the single-device
     StencilOperator.apply: within 1e-12 of max|f| in float64, 1e-5 in
     float32;
 19. sharded_stencil_pcg on that model in float32 to 1e-6, in turns with
     the single-device solve (ms per CG iteration): iterations within 2%,
     max|u - u_single| <= 1e-4 max|u|, the float64 relative residual of u
     by the structured operator (no kernel); then solve_linear_statics(
     n_domain=4, device="cuda") (sharded-stencilx4 with 4 cards, stencil
     on one); stencil_sweep's launches per flag pair;
 20. the sharded general operator on hex_beam(60, 12, 12) over 4 domains
     (ring exchange) and 3 (all-gather), float64 CG to 1e-12, each within
     1e-8 of max|u| of the single-device general operator's;
 21. the sharded calibration forward on the 32^3 calibration over a 2 x 3
     (chains x domain) mesh: its float64 log posterior and gradient at 16 θ
     within 1e-8 (relative) of make_problem's (cg_tol 1e-12); one float32
     16-chain gradient timed in turns with the unsharded one; then HMC
     through run_chains with its logp_grad_b (float32, 16 chains, 2
     leapfrog steps, 2 warmup + 2 samples): finite samples, acceptance
     above 0, unconverged solves counted, theta_sweep_batched launched;
 22. chain placement: the 32^3 calibration's 16 chains over a 4 x 1 mesh
     (every card when there are 4, else [cuda:0] * 4) through
     make_problem(mesh=): run_hmc(mesh=) in float64 at cg_tol 1e-10 (2
     leapfrog steps, 2 warmup + 2 samples) against the unplaced run of the
     same seed, samples within rtol 1e-4 and atol 1e-5; one float32
     16-chain gradient, placed and unplaced, in turns; run_nuts(mesh=)
     (max_depth 4, 2 + 2) and run_smc(mesh=) (32 particles, 2 stages) in
     float32: finite; each run's theta_sweep_batched launches at least the
     batched loop iterations summed over the rows, and counted by chains
     per launch;
 23. several processes: two workers (this script with a hidden worker
     mode, each at most PROC_TIMEOUT seconds, loading the kernels phase 2
     built) join over torch.distributed, NCCL with a card each when there
     are two or more cards, else gloo with both on cuda:0 (said which).
     Each worker has three devices; they run the 72-plane beam's float32
     x-slab CG on 1 x 4 (two slabs each, the halo between slabs 1 and 2
     across the processes: the iterations and u of phase 19's one-process
     run, each rank's stencil_sweep launches at its flag pairs at least the
     iterations, ms per iteration and the transport's share), the sharded
     general operator (ring x4, all-gather x3; phase 20's iterations and
     u to 1e-10), placed float64 HMC on 2 x 1 (8 chains per rank; the
     samples of one process's 2 x 1 run bit for bit, of phase 22's
     unplaced run to rtol 1e-10, the solve counts summed over the ranks),
     and one float32 16-chain gradient of the 32^3 calibration on 2 x 3
     (one row per rank) against phase 21's one-process gradient.
     No sharded phase calls a plain *_reference sweep on a CUDA tensor;
 24. (run after phase 8) the certified solve: pcg_certified from zero on
     the 70^3 beam (float32 corrections on the StencilOperator, float64
     residual on the float64 StencilOperator's apply: stencil_sweep's
     float and double instantiations), measure=True: converged, float64
     residual <= 1e-6, the host float64 sweep (apply_numpy on
     exact_tables) <= 1.2e-6 and within 1e-3 (relative) of it, at least
     one float32 launch per inner iteration and one float64 launch per
     cycle; its warm seconds against a plain float32 pcg to 1e-6 and
     phase 6's base CG and certification; and phase 6's certified u
     checked by hostops.masked_f64_apply (no kernel) to 1.2e-6, and that
     reading equal to phase 6's certified residual to 1e-8 (absolute). No
     plain *_reference sweep runs on a CUDA tensor in it.
 25. (run after phase 24) the host runtime (native.py over
     csrc/stanfem.cpp, OpenMP) on the 70^3 beam as meshgen builds it (no
     results stored) against the port's Python bodies,
     each pair timed in this process: the STdb written and read by
     stdb.read (the native fast decode) and by from_proto, the .bdf
     written and read by read_bdf (native) and read_bdf_python, the BFS
     order (bfs_node_order) native and numpy, each pair equal field for
     field; one apply_numpy (the native interior sweep) against
     apply_numpy_reference (numpy) to 1e-13 of max|f|. Prints the host's
     CPU model, os.cpu_count(), torch.get_num_threads() and the OpenMP
     runtimes mapped into the process, and phase 6's float32 CG ms per
     iteration again right after the native sweep (phase 6 timed it
     before any had run).
 26. (run after phase 23) the port's benchmark, stan_tpu_torch.bench.run(
     small=True) in this process (n = 12, g = 8; its sampler blocks cut
     to BENCH_LENGTHS): every block ran and none was skipped, the
     certified residual <= 1e-6 and equal to its host cross-check to
     1e-8, each of the three kernels launched; then
     stan_tpu_torch.calib_large at n = 12 (2 chains, 2 + 2). No plain
     *_reference sweep runs on a CUDA tensor in it.
 27. (run after phase 26) the chains-scaling measurement,
     stan_tpu_torch.chains_scaling.measure at grid 3 (float64, cg_tol
     1e-8, 4 leapfrog steps, 4 warmup + 4 draws) on a mesh of 8 rows,
     [cuda:0] * 8 on a one-card host: 1 chain, 8 chains placed
     (run_hmc(mesh=), the rows in turn) and 8 unplaced, each untimed and
     timed; its record printed with the card's name and power limit; the
     placed draws within 1e-9 of max|draw| of the unplaced ones; in each
     timed run theta_sweep launched where a batch holds one chain (the
     1-chain run, the placed rows) and theta_sweep_batched only in the
     unplaced run. No plain *_reference sweep runs on a CUDA tensor in it.

--kernels runs phases 1-5 only (build, every kernel against its plain
version, the timings), prints the kernels line with no launch counts (no
main path ran) and ends with a line that says the run was partial, not
with the ok line: a quick probe of the kernels alone.

Two measurements run only when asked for:
  --profile  100 float32 CG iterations on the 70^3 stencil operator and
             on the 72-plane sharded one, one 16-chain gradient of the 32^3
             posterior near θ_true, and 50 CG iterations on the 70^3
             nonlinear solve's tangent, under
             torch.profiler: wall time, (chain-batched) CG iterations, ms
             per iteration, device busy share, device time by kernel,
             launches per iteration; before the ADVI phase, three one-step
             ADVI fits timed in turn and one under torch.profiler (device
             time by kernel, host time by operator); the sharded
             apply's halo padding (sharded_stencil.halo_pad_rows) timed
             against the reference's form (concatenate, then pad);
  --cli      `python -m stan_tpu_torch.cli calibrate --synthetic --sampler
             hmc --device cuda` on an STdb of the 32^3 beam (needs
             protobuf), at the CLI's default tolerance and at 1e-8 (a
             short run), printing the CLI's counts of unconverged solves;
             then `cli calibrate --sampler nuts` (short), `cli solve` and
             `cli export` on the same STdb; `cli solve --type
             Nonlinear_Statics --increments 2` on it, `cli solve --solver
             Cholesky` on a 12x6x6 beam, `cli calibrate --sampler hmc`
             (short) on the two-material 32^3 beam, `cli calibrate`
             with `[sharding] chains = 2`: exit code 2 and the ERROR line
             with one card, a run that records the mesh with two or more;
             and `cli solve` on an STdb of the 70^3 beam, printing its
             "Read database" and "Write database" seconds, and the
             solved STdb (results stored) read back by stdb.read and by
             from_proto, each timed, required equal.

Prints a JSON line of kernel facts and, last, one JSON line naming the
device; before those, it checks that no module of stan_tpu was loaded.
Exits non-zero, with no result, when there is no CUDA device.

Run from the repository root:
  python3 chip_smoke.py [--profile] [--cli] | [--kernels]

The general path's phases (14-17) run no kernel of their own but the
general operator's (csrc/general_apply.cu, in the general forward's CG):
the device code of the direct solvers, the nonlinear statics and the field
forward is plain torch and torch.linalg, as it is XLA in the JAX package;
the banded solver is float64 host LAPACK in both. So is the sharded
general operator (phase 20); the sharded stencil phases (18, 19,
21) run stencil_sweep and theta_sweep_batched on x-slabs with their face
flags, and phase 22 runs theta_sweep_batched on each row's block of
chains. In phases 18-22 one process drives every device of a mesh; with one
card the mesh repeats cuda:0, so no copy crosses cards there. In phase 23
each of two processes drives its own blocks and the blocks' exchanges
cross between the processes.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import itertools
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from stan_tpu_torch.bench import HBM_BYTES_PER_S, PEAK_FLOPS, card_line

N = 70  # bench.py's beam: 343,000 HEX8 elements, 1,073,733 DOF
G = 32  # bench.py's calibration grid: 35,937 nodes, 107,811 DOF
CHAINS = 16
N_LEAPFROG = 8
N_WARMUP = 10
N_SAMPLES = 5
NUTS_DEPTH, NUTS_WARMUP, NUTS_SAMPLES = 5, 5, 3
VI_STEPS, VI_DRAWS = 10, 8
SMC_PARTICLES, SMC_MCMC, SMC_STAGES = 32, 2, 2
# The general path: direct solvers on a TET4 model under the dense limit
# (1,701 nodes, 5,103 DOF) and on a beam above it (30,927 DOF), held to a
# float64 CG solve; Total-Lagrangian statics at the linear size; the three
# forward problems of the calibration; HMC on a two-material beam.
TET_BEAM, BAND_BEAM = (20, 8, 8), (60, 12, 12)
DIRECT_CG_TOL, DIRECT_GAP = 1e-13, 1e-8
NL_DEFLECTION, NL_INCREMENTS = 0.03, 2
# The three forwards agree to FORWARDS_GAP in float64. In float32 they
# agree only to float32's floor (the stencil and field operators' rounded
# element stiffness no longer annihilates rigid motions exactly): at 32^3
# on an H100, 2.3e-4 of max|u| and 2.2e-3 of the largest gradient entry,
# so float32 is held to FORWARDS_GAP_F32.
FORWARDS_GAP, FORWARDS_GAP_F32 = 1e-4, 1e-2
TWO_MAT_WARMUP, TWO_MAT_SAMPLES = 3, 3
# A float64 field pass on the card and on the CPU: the same operations,
# each rounded once, in other libraries and summation orders.
FIELD_RTOL = 1e-12
THETA_TRUE = np.array([np.log(190000.0), 0.28, 0.0])
SEED = 0
# The kernel and the plain version sum the same products in other orders.
SWEEP_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
FLAGS = ((1, 1), (0, 1), (1, 0), (0, 0))
SYNC_ITERS = 200
# tests/test_infer.py:227-236 (test_forward_gradient_finite_difference).
FD_H, FD_REL, FD_ABS = 1e-4, 2e-3, 1e-3
FLUSH_BYTES = 256 * 2**20  # > the 50 MB L2
# The sharded phases: the 70^3 beam widened by one x-plane (NNX = 72, which
# 2, 3, 4 and 8 divide) on 4 domains; the banded beam on 4 domains (ring)
# and 3 (all-gather); the 32^3 calibration (NNX = 33) on 2 x 3 chains x
# domain, HMC cut in length only.
SHARD_BEAM, SHARD_DOMAIN = (71, 70, 70), 4
SHARD_GENERAL = ((4, True), (3, False))
SHARD_MESH = (2, 3)
SHARD_WARMUP, SHARD_SAMPLES, SHARD_LEAPFROG = 2, 2, 2
SHARD_ITERS_GAP, SHARD_U_GAP, SHARD_FWD_RTOL = 0.02, 1e-4, 1e-8
# Chain placement (phase 22): the 32^3 calibration's chains over a 4 x 1
# mesh, HMC, NUTS and SMC cut in length only; placed and unplaced float64
# HMC agree to the reference's sharded-vs-unsharded tolerance
# (tests/test_sharded_infer.py:139-140).
PLACE_ROWS = 4
PLACE_WARMUP, PLACE_SAMPLES, PLACE_LEAPFROG = 2, 2, 2
PLACE_NUTS_DEPTH, PLACE_SMC_STAGES = 4, 2
PLACE_RTOL, PLACE_ATOL = 1e-4, 1e-5
# Several processes (phase 23): two workers, each with three devices (its
# own card under NCCL, cuda:0 under gloo on a one-card host); each waits at
# most PROC_TIMEOUT seconds, and so does every collective. Their answers
# against the one-process runs of phases 19-22: the stencil CG's u to
# PROC_U_GAP of max|u| (the design predicts 0), the general CG's to
# DIRECT_GAP's 1e-10 (float64), the placed float64 HMC's samples to
# PROC_RTOL (with PROC_ATOL in θ's units) of the unplaced run, the sharded
# forward's gradient to SHARD_FWD_RTOL.
PROC_TIMEOUT = 120.0
PROC_U_GAP, PROC_GENERAL_GAP = 1e-6, 1e-10
PROC_RTOL, PROC_ATOL = 1e-10, 1e-10
PROC_ROWS = 2
# The certified solve (phase 24): pcg_certified to CERT_TOL from zero on
# the 70^3 beam; its float64 answer checked by the host float64 sweep to
# CERT_HOST_TOL (tests/test_df32.py:112), the host and device residuals
# to CERT_AGREE of each other (both float64).
CERT_TOL, CERT_HOST_TOL, CERT_AGREE = 1e-6, 1.2e-6, 1e-3
# Phase 6's certified residual is the host twin's reading of its u: phase
# 24's reading of the same u by the same twin agrees to CERT_SAME.
CERT_SAME = 1e-8
# The host runtime (phase 25): the native float64 interior sweep and the
# numpy one sum the same products in other orders.
HOST_SWEEP_RTOL = 1e-13
# The port's benchmark (phase 26) at its small sizes, its sampler blocks cut
# to BENCH_LENGTHS (warmup, draws per chain); then calib_large at n = 12.
BENCH_LENGTHS = (4, 4)
CALIB_LARGE_ARGS = ["--n", "12", "--chains", "2", "--samples", "2",
                    "--warmup", "2"]
# The chains-scaling measurement (phase 27) at grid 3, cut in length: its
# placed and unplaced float64 draws differ only by the rounding of the
# solves (batch width moves per-chain CG counts on the card).
SCALING_GRID, SCALING_LENGTHS, SCALING_RTOL = 3, (4, 4), 1e-9


# The six tetrahedra of a HEX8 around its corner-0 to corner-6 diagonal, in
# the HEX8 corner order of meshgen.hex_beam.
_HEX_TO_TETS = np.array([[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
                         [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]])


def tet_split(model, elem_type: str = "TET4_G1"):
    """The model with each HEX8 split into 6 TET4 (the same nodes, loads,
    supports and materials, copied), each tet numbered to a positive
    volume; works on a model of either package."""
    model = copy.deepcopy(model)
    conn = np.asarray(model.conn)[:, _HEX_TO_TETS].reshape(-1, 4)
    p = np.asarray(model.coords)[conn]
    vol = np.einsum("ij,ij->i", np.cross(p[:, 1] - p[:, 0],
                                         p[:, 2] - p[:, 0]), p[:, 3] - p[:, 0])
    conn[vol < 0] = conn[vol < 0][:, [0, 2, 1, 3]]
    n = len(conn)
    return dataclasses.replace(
        model, conn=conn, elem_ids=np.arange(1, n + 1, dtype=np.int64),
        elem_pid=np.repeat(np.asarray(model.elem_pid), 6),
        elem_type=[elem_type] * n,
        elem_mat=np.repeat(np.asarray(model.elem_mat), 6))


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, flush, reps: int = 50) -> float:
    """Mean device time of fn() with the L2 cache flushed before each launch
    (flush is a buffer larger than the 50 MB L2, rewritten each time)."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in times) / reps


def bound(up, out, extra_bytes: int, dtype) -> tuple:
    """(bound in ms, "bytes" or "operations") of a sweep from up to out: one
    read of every input and one write of the output over the card's memory
    rate, against 243 multiply-adds per output node over the peak rate of
    the type outside the tensor cores (both from the data sheet)."""
    nbytes = (up.numel() + out.numel()) * up.element_size() + extra_bytes
    ops = 2 * 243 * out.numel() // 3
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def assemble_csr(applies, node_shape, dtype, device="cuda"):
    """[K_1 | K_2 | ...] as one CSR matrix [3N, 3N·len(applies)], each K_a
    the matrix of applies[a] (u [3, X, Y, Z] -> K u, zero ghosts), with
    rows and columns component-major as the sweeps lay out [3, X, Y, Z].

    Each K is probed with the 81 vectors of a 3x3x3 node colouring times
    the 3 components: a node's 3x3x3 window holds exactly one node of each
    colour, so probe (colour, d) at row (c, n) is the entry of column
    (d, the neighbour of n with that colour)."""
    X, Y, Z = node_shape
    N = X * Y * Z
    ix = [torch.arange(n, device=device) for n in node_shape]
    gx, gy, gz = torch.meshgrid(*ix, indexing="ij")
    vals, cols = [], []
    for a, apply in enumerate(applies):
        probe = torch.empty((3, 3, 3, 3, 3, X, Y, Z), dtype=dtype,
                            device=device)
        for cx, cy, cz in itertools.product(range(3), repeat=3):
            mask = ((gx % 3 == cx) & (gy % 3 == cy) & (gz % 3 == cz))
            for d in range(3):
                u = torch.zeros((3, X, Y, Z), dtype=dtype, device=device)
                u[d] = mask.to(dtype)
                probe[cx, cy, cz, d] = apply(u)
        for d in range(3):
            for ox, oy, oz in itertools.product((-1, 0, 1), repeat=3):
                x, y, z = gx + ox, gy + oy, gz + oz
                v = probe[x % 3, y % 3, z % 3, d, :, gx, gy, gz]  # [X,Y,Z,3]
                ok = ((x >= 0) & (x < X) & (y >= 0) & (y < Y) & (z >= 0)
                      & (z < Z))
                vals.append(torch.where(ok[..., None], v, torch.nan)
                            .permute(3, 0, 1, 2).reshape(3 * N))
                cols.append(((a * 3 + d) * N + (x * Y + y) * Z + z)
                            .reshape(1, N).expand(3, N).reshape(3 * N))
    vals = torch.stack(vals, dim=1)  # [3N, 81·len(applies)], columns sorted
    cols = torch.stack(cols, dim=1)
    keep = ~torch.isnan(vals)
    crow = torch.zeros(3 * N + 1, dtype=torch.int32, device=device)
    crow[1:] = torch.cumsum(keep.sum(dim=1), 0)
    return torch.sparse_csr_tensor(
        crow, cols[keep].to(torch.int32), vals[keep],
        size=(3 * N, 3 * N * len(applies)), check_invariants=False)


def time_graph_ms(fn, per_graph: int = 20, reps: int = 20) -> float:
    """Device time of one fn() from replays of a CUDA graph of per_graph
    calls: the kernel's own time, without the wrapper's host cost, which
    for a kernel of a few tens of µs is as long as the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return time_ms(graph.replay, reps) / per_graph


def pad(u):
    """Zero ghosts around the node grid(s), as the main paths pad."""
    import torch.nn.functional as F

    return F.pad(u, (1, 1, 1, 1, 1, 1)).contiguous()


def theta_unit(t2, which: int):
    """u [3, X, Y, Z] -> K_λ u (which 0) or K_μ u (1), by the plain sweep."""
    from stan_tpu_torch.fem import stencil

    coef = torch.zeros((1, 2), dtype=t2.dtype, device=t2.device)
    coef[0, which] = 1.0
    return lambda u: stencil.theta_sweep_reference(pad(u)[None], t2, coef,
                                                   1, 1)[0]


def measure(name, up, kern, plain, lib, lib_as_out, extra_bytes, flush,
            card) -> dict:
    """A kernel at a main path's shape: its time with the L2 cache warm, by
    CUDA events around back-to-back wrapper calls in turns with the plain
    version (ms) and from CUDA-graph replays (ms_graph, the kernel alone);
    its time with the L2 flushed (ms_cold); its bound; and the time of one
    library call of the same function (checked against the kernel on these
    inputs first)."""
    out = kern()
    got = lib_as_out(lib())
    torch.cuda.synchronize()
    gap = float((got - out).abs().max()) / float(out.abs().max())
    require(gap <= SWEEP_RTOL[out.dtype],
            f"{name}: library call differs from the kernel by {gap}")
    p1 = time_ms(plain, 20)
    k1 = time_ms(kern, 200)
    k2 = time_ms(kern, 200)
    p2 = time_ms(plain, 20)
    g1 = time_graph_ms(kern)
    g2 = time_graph_ms(kern)
    cold = time_cold_ms(kern, flush)
    lib_ms = time_ms(lib, 50)
    bound_ms, bound_by = bound(up, out, extra_bytes, out.dtype)
    ms_graph = (g1 + g2) / 2
    print(f"[{card}] {name} {list(up.shape)} {str(out.dtype)[6:]}: kernel "
          f"{k1 * 1e3:.2f} / {k2 * 1e3:.2f} µs warm (events around wrapper "
          f"calls), {g1 * 1e3:.2f} / {g2 * 1e3:.2f} µs warm (CUDA graph), "
          f"{cold * 1e3:.2f} µs cold L2; plain {p1:.4f} / {p2:.4f} ms; "
          f"library torch.sparse.mm {lib_ms * 1e3:.2f} µs (relative gap "
          f"{gap:.1e}); bound {bound_ms * 1e3:.2f} µs ({bound_by}), share "
          f"of the CUDA-graph time {bound_ms / ms_graph:.1%}")
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "ms_cold": cold, "ms_graph": ms_graph}


def check_close(f, f_ref, dtype, label, card) -> float:
    torch.cuda.synchronize()
    err = float((f - f_ref).abs().max())
    scale = float(f_ref.abs().max())
    require(bool(torch.isfinite(f).all()), f"{label}: non-finite")
    require(err <= SWEEP_RTOL[dtype] * scale,
            f"{label}: max error {err} > {SWEEP_RTOL[dtype]} x {scale}")
    print(f"[{card}] {label}: max|f-f_ref| = {err:.3e} "
          f"(max|f_ref| = {scale:.3e})")
    return err


def compare_sweeps(tables, node_shape, rng, label, card) -> dict:
    """stencil_sweep vs its plain version on random slabs (ghosts random
    too, as a slab's x ghosts carry a neighbour's plane); returns {(dtype,
    flags): max abs error}."""
    from stan_tpu_torch.fem import stencil

    errs = {}
    for dtype in (torch.float32, torch.float64):
        table = stencil.pack_tables(tables, dtype, "cuda")
        up_np = rng.standard_normal((3, *(n + 2 for n in node_shape)))
        up = torch.as_tensor(up_np, dtype=dtype, device="cuda")
        for lo, hi in FLAGS:
            f = stencil.stencil_sweep(up, table, lo, hi)
            f_ref = stencil.stencil_sweep_reference(up, table, lo, hi)
            errs[(dtype, (lo, hi))] = check_close(
                f, f_ref, dtype,
                f"sweep {label} {str(dtype)[6:]} flags ({lo},{hi})", card)
    return errs


def unit_tables(model):
    """The unit-λ and unit-μ signature tables of a structured beam."""
    from stan_tpu_torch.fem import stencil, structured

    base = structured.build_structured_operator(model, dtype=torch.float64,
                                                device="cuda")
    return (stencil.signature_tables(base.ke_lam.cpu().numpy()),
            stencil.signature_tables(base.ke_mu.cpu().numpy()),
            base.node_shape)


def compare_theta(model, coefs, rng, label, card, batched: bool,
                  sx=None, flags=FLAGS) -> dict:
    """theta_sweep (coefs [P, 2]: one check per pair) or theta_sweep_batched
    (coefs [B, 2]: one batch) against theta_sweep_reference, on the model's
    grid or, with sx, on a slab of sx x-planes of it, under each flag pair
    of `flags`; returns {(dtype, flags): max abs error over the checks}."""
    from stan_tpu_torch.fem import stencil

    tl, tm, node_shape = unit_tables(model)
    if sx is not None:
        node_shape = (sx, *node_shape[1:])
    padded = tuple(n + 2 for n in node_shape)
    errs = {}
    for dtype in (torch.float32, torch.float64):
        t2 = stencil.pack_theta_tables(tl, tm, dtype, "cuda")
        coef = torch.as_tensor(coefs, dtype=dtype, device="cuda")
        B = coef.shape[0]
        up = torch.as_tensor(rng.standard_normal((B, 3) + padded),
                             dtype=dtype, device="cuda")
        for lo, hi in flags:
            name = f"{str(dtype)[6:]} flags ({lo},{hi})"
            if batched:
                err = check_close(
                    stencil.theta_sweep_batched(up, t2, coef, lo, hi),
                    stencil.theta_sweep_reference(up, t2, coef, lo, hi),
                    dtype, f"theta_sweep_batched {label} {name}", card)
            else:
                err = max(check_close(
                    stencil.theta_sweep(up[b], t2, coef[b], lo, hi),
                    stencil.theta_sweep_reference(up[b:b + 1], t2,
                                                  coef[b:b + 1], lo, hi)[0],
                    dtype, f"theta_sweep {label} {name} coef {b}", card)
                    for b in range(B))
            errs[(dtype, (lo, hi))] = err
    return errs


def cg_without_sync(A, b, diag, iters: int):
    """The iteration of solvers/cg.pcg with no host read of the residual
    (the norm is still computed on the device)."""
    inv_diag = torch.where(diag != 0, 1.0 / diag, torch.zeros_like(diag))
    x = torch.zeros_like(b)
    r = b - A(x)
    z = inv_diag * r
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = A(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_n = torch.sum(r * z)
        p = z + (rz_n / rz) * p
        rz = rz_n
        torch.sqrt(torch.sum(r * r))
    return x


def wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


KERNELS = ("stencil_sweep", "theta_sweep", "theta_sweep_batched",
           "general_apply")


def reset_launches():
    from stan_tpu_torch.fem import launches

    launches.reset()


def launched(key) -> int:
    """The launches counted under key (a kernel wrapper's name, or (name,
    is_low, is_high)) since the last reset_launches()."""
    from stan_tpu_torch.fem import launches

    return launches.counts[key]


def launch_counts() -> tuple:
    """The launches of each of KERNELS since the last reset_launches()."""
    return tuple(launched(k) for k in KERNELS)


def flag_launches() -> dict:
    """{(wrapper, is_low, is_high): launches} since the last
    reset_launches(), sorted."""
    from stan_tpu_torch.fem import launches

    return dict(sorted((k, n) for k, n in launches.counts.items()
                       if isinstance(k, tuple)))


def observe(u_true):
    """bench.py's synthetic observations (bench.py:284-313) of a solve u_true
    [nnode, 3]: 128 strongly deflected nodes x 3 directions, 1% noise.
    Returns (obs_nodes, obs_dirs, y, sigma)."""
    total = np.linalg.norm(u_true, axis=1)
    nodes = np.nonzero(total > 0.3 * total.max())[0][:128]
    obs_nodes = np.repeat(nodes, 3)
    obs_dirs = np.tile([0, 1, 2], len(nodes))
    rng = np.random.default_rng(0)
    sigma = 1e-2 * float(np.abs(u_true).max())
    y = u_true[obs_nodes, obs_dirs] + sigma * rng.normal(size=len(obs_nodes))
    return obs_nodes, obs_dirs, y, sigma


def calibration_observations(model, card):
    """observe() of the port's own forward at θ_true. Returns (obs_nodes,
    obs_dirs, y, sigma, stats of the θ_true solve)."""
    from stan_tpu_torch.infer import forward

    fwd = forward.build_forward(model, device="cuda", cg_tol=1e-6)
    u_true = forward.displacement_fn(fwd, model.nelem)(
        torch.as_tensor(THETA_TRUE, device="cuda")).detach().cpu().numpy()
    stats = fwd.stats.as_dict()
    print(f"[{card}] forward at θ_true: {stats}")
    return (*observe(u_true), stats)


def fd_gradient_check(model, obs, card) -> None:
    """The log posterior's gradient (forward + adjoint solve on the kernel,
    float64) against central differences, at one θ with the load free."""
    from stan_tpu_torch.infer import calibrate

    obs_nodes, obs_dirs, y, sigma = obs
    prob = calibrate.make_problem(model, obs_nodes, obs_dirs, y, sigma,
                                  dtype=torch.float64, device="cuda",
                                  cg_tol=1e-12, infer_load=True)
    theta = torch.tensor([[np.log(200000.0), 0.1, 0.05]], dtype=torch.float64,
                         device="cuda", requires_grad=True)
    prob.log_posterior(theta).sum().backward()
    g = theta.grad[0].cpu().numpy()
    with torch.no_grad():
        for i, name in enumerate(("log E", "logit 2ν", "log s")):
            e = torch.zeros_like(theta)
            e[0, i] = FD_H
            fd = float(prob.log_posterior(theta + e)
                       - prob.log_posterior(theta - e)) / (2 * FD_H)
            print(f"[{card}] float64 gradient d/d({name}): autograd "
                  f"{g[i]:.9e}, central difference {fd:.9e}")
            require(abs(g[i] - fd) <= max(FD_REL * abs(fd), FD_ABS),
                    f"gradient {name}: {g[i]} vs finite difference {fd}")
    st = prob.fwd.stats.as_dict()
    require(st["forward_unconverged"] == st["adjoint_unconverged"] == 0,
            f"float64 solves of the gradient check unconverged: {st}")


def fields_phase(model, card) -> None:
    """The 24 result fields of the stored 70^3 solve on the card in float64
    against the CPU's, then the .vtu export of increment 1 (removed
    after)."""
    import os
    import tempfile

    from stan_tpu_torch.post import fields

    t0 = time.perf_counter()
    got = fields.compute_all(model, 1, device="cuda")
    torch.cuda.synchronize()
    all_s = time.perf_counter() - t0
    # The device pass alone, on inputs already on the card (CUDA events).
    on = {k: torch.as_tensor(getattr(model, k)[1], dtype=torch.float64,
                             device="cuda") for k in ("disp", "stress",
                                                      "strain")}
    conn = torch.as_tensor(model.conn, dtype=torch.int64, device="cuda")

    def device_pass():
        en = fields.elemnode_fields(on["disp"], conn, on["stress"],
                                    on["strain"])
        fields.cell_fields(en)
        fields.point_fields(en, conn, model.nnode)

    pass_ms = time_ms(device_pass, 5)
    t0 = time.perf_counter()
    ref = fields.compute_all(model, 1, device="cpu")
    cpu_s = time.perf_counter() - t0
    require(list(got) == list(ref) and len(got) == 96, "field names differ")
    worst = 0.0
    for name, want in ref.items():
        scale = max(float(np.abs(want).max()), 1e-300)
        gap = float(np.abs(got[name] - want).max()) / scale
        require(np.isfinite(got[name]).all(), f"{name}: non-finite")
        require(gap <= FIELD_RTOL, f"{name}: card vs CPU gap {gap} of max")
        worst = max(worst, gap)
    print(f"[{card}] fields {N}^3 ({model.nelem} elements, {model.nnode} "
          f"nodes, 96 arrays): compute_all on the card {all_s:.4f} s "
          f"(host clock, synced; copies in and out included), device pass "
          f"{pass_ms:.3f} ms (CUDA events); the CPU's {cpu_s:.3f} s; "
          f"largest gap card vs CPU {worst:.2e} of the field's max")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = fields.export_vtu(model, f"{tmp}/beam{N}", increments=[1],
                                  device="cuda")
        write_s = time.perf_counter() - t0
        size = sum(os.path.getsize(p) for p in paths)
        require(len(paths) == 1 and size > 0, f"export wrote {paths}")
    print(f"[{card}] export_vtu {N}^3 increment 1: {write_s:.3f} s host "
          f"(fields on the card + binary .vtu write), {size} bytes")


def _report_solves(label, st, card) -> None:
    print(f"[{card}] {label} solves: {st['forward_solves']} forward "
          f"({st['forward_unconverged']} unconverged, "
          f"{st['forward_loop_iters']} batched loop iterations), "
          f"{st['adjoint_solves']} adjoint ({st['adjoint_unconverged']} "
          f"unconverged, {st['adjoint_loop_iters']} batched loop "
          f"iterations)")


def nuts_phase(prob, theta0, card) -> tuple:
    """run_nuts on the calibration posterior; returns the launches of
    (theta_sweep, theta_sweep_batched) in this phase."""
    from stan_tpu_torch.infer import nuts

    reset_launches()
    t0 = time.perf_counter()
    out = nuts.run_nuts(prob.log_posterior, theta0, 13,
                        max_depth=NUTS_DEPTH, n_warmup=NUTS_WARMUP,
                        n_samples=NUTS_SAMPLES, init_step=0.02,
                        solve_stats=prob.fwd.stats)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = (launched("theta_sweep"), launched("theta_sweep_batched"))
    st = out.solve_stats
    run_s = out.warmup_seconds + sum(out.chunk_seconds)
    sps = CHAINS * sum(out.chunk_sizes) / sum(out.chunk_seconds)
    loop_iters = st["forward_loop_iters"] + st["adjoint_loop_iters"]
    print(f"[{card}] NUTS {G}^3, {CHAINS} chains, max_depth {NUTS_DEPTH}, "
          f"{NUTS_WARMUP} warmup + {NUTS_SAMPLES} samples: {wall_s:.2f} s "
          f"in all, warmup {out.warmup_seconds:.2f} s, sampling "
          f"{sum(out.chunk_seconds):.2f} s; samples/s (sampling phase, all "
          f"chains) {sps:.3f}")
    print(f"[{card}] NUTS evals_per_sample per chain "
          f"{np.round(out.evals_per_sample, 2).tolist()} (mean "
          f"{float(np.mean(out.evals_per_sample)):.2f}); gradient "
          f"evaluations (all {CHAINS} chains each) {out.grad_evals}, "
          f"{run_s / out.grad_evals:.4f} s each; acceptance "
          f"{float(np.mean(out.accept_rate)):.3f}; step size "
          f"{float(np.mean(out.step_size)):.4g}")
    _report_solves("NUTS", st, card)
    print(f"[{card}] NUTS kernel launches: theta_sweep_batched "
          f"{launches[1]}, theta_sweep {launches[0]}")
    require(out.samples.shape == (CHAINS, NUTS_SAMPLES, 3)
            and np.isfinite(out.samples).all(), "NUTS samples not finite")
    require(float(np.mean(out.accept_rate)) > 0.0, "NUTS acceptance 0")
    require(launches[1] >= loop_iters,
            f"NUTS: {launches[1]} batched launches < {loop_iters} "
            f"iterations of the chain-batched CG loops")
    require((out.evals_per_sample <= 2 ** NUTS_DEPTH - 1).all(),
            f"NUTS evals_per_sample {out.evals_per_sample}")
    return launches


def vi_smc_phase(prob, theta0, card) -> tuple:
    """ADVI and SMC on the calibration posterior, short; returns the
    launches of (theta_sweep, theta_sweep_batched) in this phase."""
    from stan_tpu_torch.infer import smc, vi

    reset_launches()
    st0 = prob.fwd.stats.as_dict()
    t0 = time.perf_counter()
    res = vi.run_advi(prob.log_posterior, theta0[0], 17, n_steps=VI_STEPS,
                      n_elbo_samples=VI_DRAWS)
    torch.cuda.synchronize()
    vi_s = time.perf_counter() - t0
    vi_launches = launched("theta_sweep_batched")
    print(f"[{card}] ADVI {G}^3, {VI_STEPS} steps of {VI_DRAWS} draws: "
          f"{vi_s:.2f} s; mu {np.round(res.mu, 4).tolist()}, sigma "
          f"{np.round(res.sigma, 4).tolist()}, last ELBO "
          f"{float(res.elbo_trace[-1]):.6g}; theta_sweep_batched "
          f"{vi_launches}")
    _report_solves("ADVI", prob.fwd.stats.since(st0), card)
    require(np.isfinite(res.mu).all() and np.isfinite(res.sigma).all()
            and np.isfinite(res.elbo_trace).all(), "ADVI not finite")

    st0 = prob.fwd.stats.as_dict()
    t0 = time.perf_counter()
    out = smc.run_smc(prob.log_prior, prob.log_likelihood, prob.sample_prior,
                      19, n_particles=SMC_PARTICLES, n_mcmc=SMC_MCMC,
                      max_stages=SMC_STAGES, device="cuda")
    torch.cuda.synchronize()
    smc_s = time.perf_counter() - t0
    smc_launches = launched("theta_sweep_batched") - vi_launches
    print(f"[{card}] SMC {G}^3, {SMC_PARTICLES} particles, {SMC_MCMC} "
          f"Metropolis steps, at most {SMC_STAGES} stages: {smc_s:.2f} s; "
          f"temperatures {np.round(out.temperatures, 6).tolist()}, "
          f"acceptance {np.round(out.acceptance, 3).tolist()}; "
          f"theta_sweep_batched {smc_launches}")
    _report_solves("SMC", prob.fwd.stats.since(st0), card)
    require(np.isfinite(out.particles).all()
            and np.isfinite(out.log_evidence), "SMC not finite")
    require((np.diff(out.temperatures) > 0).all(),
            f"SMC temperatures {out.temperatures} do not rise")
    return launched("theta_sweep"), launched("theta_sweep_batched")


def profile_gradient(prob, card, top: int = 10) -> None:
    """One 16-chain gradient near θ_true: its wall time unprofiled, then the
    device time of the same gradient under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from stan_tpu_torch.infer import hmc

    lgb = hmc.guarded_logp_grad_b(prob.log_posterior)
    near = np.array([THETA_TRUE[0], np.log(0.56 / 0.44), 0.0])
    theta = torch.as_tensor(
        near + 0.01 * np.random.default_rng(3).normal(size=(CHAINS, 3)),
        device="cuda")
    lgb(theta)
    st0 = prob.fwd.stats.as_dict()
    wall_s = wall(lambda: lgb(theta))
    st1 = prob.fwd.stats.as_dict()
    loop = sum(st1[k] - st0[k]
               for k in ("forward_loop_iters", "adjoint_loop_iters"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lgb(theta)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    launches = sum(e.count for e in dev)
    print(f"[{card}] profile, one gradient near θ_true ({CHAINS} chains): "
          f"{wall_s:.4f} s unprofiled, {loop} batched CG iterations "
          f"({st1['forward_iters'] - st0['forward_iters']} forward + "
          f"{st1['adjoint_iters'] - st0['adjoint_iters']} adjoint over the "
          f"chains), {wall_s / loop * 1e3:.4f} ms per iteration; device busy "
          f"{busy_us / 1e6:.4f} s, busy share {busy_us / 1e6 / wall_s:.3f}; "
          f"{launches} device events, {launches / loop:.1f} per iteration")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[{card}]   {e.self_device_time_total / busy_us:6.1%} "
              f"{e.count:7d} x {e.self_device_time_total / e.count:8.2f} us  "
              f"{e.key[:90]}")


def profile_advi(prob, theta0, card, top: int = 8) -> None:
    """ADVI's cost per step: three one-step fits (VI_DRAWS draws each) in
    turn, each with its wall time and batched CG iterations, then one more
    under torch.profiler: device busy time, the device kernels and the host
    operators that take the most time. Run before the ADVI phase, so the
    first fit pays what the process pays once for ADVI."""
    from torch.profiler import ProfilerActivity, profile

    from stan_tpu_torch.infer import vi

    def fit():
        vi.run_advi(prob.log_posterior, theta0[0], 17, n_steps=1,
                    n_elbo_samples=VI_DRAWS)

    for i in range(3):
        st0 = prob.fwd.stats.as_dict()
        wall_s = wall(fit)
        st1 = prob.fwd.stats.as_dict()
        loop = sum(st1[k] - st0[k]
                   for k in ("forward_loop_iters", "adjoint_loop_iters"))
        print(f"[{card}] profile, ADVI one-step fit {i + 1} of 3: "
              f"{wall_s:.4f} s, {loop} batched CG iterations, "
              f"{wall_s / loop * 1e3:.4f} ms per iteration")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    host_us = sum(e.self_cpu_time_total for e in host)
    print(f"[{card}] profile, ADVI one-step fit under the profiler: device "
          f"busy {busy_us / 1e6:.4f} s, host operators {host_us / 1e6:.4f} s "
          f"(self time)")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[{card}]   device {e.self_device_time_total / busy_us:6.1%} "
              f"{e.count:7d} x {e.self_device_time_total / e.count:8.2f} us  "
              f"{e.key[:80]}")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"[{card}]   host {e.self_cpu_time_total / host_us:6.1%} "
              f"{e.count:7d} x {e.self_cpu_time_total / e.count:8.2f} us  "
              f"{e.key[:80]}")


def profile_cg(apply, rhs, diag, label, card, iters: int = 100,
               top: int = 6, run=None) -> None:
    """iters float32 CG iterations of cg.pcg on `apply` (with its
    per-iteration host check), or of run(), under torch.profiler: wall and
    device busy time per iteration, busy share, device time by kernel, and
    the share of copy and fill kernels."""
    from torch.profiler import ProfilerActivity, profile

    from stan_tpu_torch.solvers import cg

    run = run or (lambda: cg.pcg(apply, rhs, diag=diag, tol=0.0,
                                 maxiter=iters))
    run()
    wall_s = wall(run)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    launches = sum(e.count for e in dev)
    print(f"[{card}] profile, {iters} float32 CG iterations on {label}: "
          f"{wall_s / iters * 1e3:.4f} ms per iteration unprofiled; device "
          f"busy {busy_us / iters / 1e3:.4f} ms per iteration, busy share "
          f"{busy_us / 1e6 / wall_s:.3f}; {launches / iters:.1f} device "
          f"events per iteration")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[{card}]   {e.self_device_time_total / busy_us:6.1%} "
              f"{e.count:7d} x {e.self_device_time_total / e.count:8.2f} us  "
              f"{e.key[:90]}")
    for word in ("copy", "fill"):
        us = sum(e.self_device_time_total for e in dev
                 if word in e.key.lower() or (word == "copy"
                                               and "memcpy" in e.key.lower()))
        print(f"[{card}]   kernels named *{word}*: "
              f"{us / max(busy_us, 1e-9):.1%} of device time, "
              f"{us / iters / 1e3:.4f} ms per iteration")


def _max_gap(a, b) -> float:
    """max|a - b| / max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


def direct_phase(card) -> int:
    """The direct solvers through solve_linear_statics: dense Cholesky and
    LU on the card, float32 and float64, on hex_beam(*TET_BEAM) split into
    TET4 (under the 6000-DOF dense limit), and the banded float64 host
    solvers on hex_beam(*BAND_BEAM) (above it). Each float64 answer is held
    to a float64 CG solve of the same model to DIRECT_GAP of max|u|.
    Returns the general_apply launches of those CG solves (at least one an
    iteration where the general operator solves)."""
    from stan_tpu_torch.analysis.linear import solve_linear_statics
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.utils.timing import PhaseTimer

    general = 0
    for label, make, dtypes in (
            (f"TET4 split of hex_beam{TET_BEAM}",
             lambda: tet_split(meshgen.hex_beam(*TET_BEAM)),
             (torch.float32, torch.float64)),
            (f"hex_beam{BAND_BEAM}", lambda: meshgen.hex_beam(*BAND_BEAM),
             (torch.float64,))):
        cg_model = make()
        cg_model.analysis.lin_solver_tolerance = DIRECT_CG_TOL
        reset_launches()
        t0 = time.perf_counter()
        ref = solve_linear_statics(cg_model, device="cuda",
                                   dtype=torch.float64, store=False)
        cg_s = time.perf_counter() - t0
        counts = dict(zip(KERNELS, launch_counts()))
        print(f"[{card}] {label} ({3 * cg_model.nnode} DOF, "
              f"{cg_model.nelem} elements): float64 CG ({ref.operator}) to "
              f"{DIRECT_CG_TOL:g}: {ref.iters} iterations, converged "
              f"{ref.converged}, {cg_s:.3f} s, launches {counts}")
        if ref.operator == "general":
            require(counts["general_apply"] >= ref.iters,
                    f"{label}: {counts['general_apply']} general_apply "
                    f"launches < {ref.iters} CG iterations")
        general += counts["general_apply"]
        for solver in ("Cholesky", "LU"):
            for dtype in dtypes:
                m = make()
                m.analysis.lin_solver = solver
                timer = PhaseTimer(verbose=False)
                t0 = time.perf_counter()
                res = solve_linear_statics(m, device="cuda", dtype=dtype,
                                           timer=timer, store=False)
                solve_s = time.perf_counter() - t0
                gap = _max_gap(res.u, ref.u)
                phases = ", ".join(f"{r['phase']} {r['seconds']:.4f} s"
                                   for r in timer.records)
                print(f"[{card}] {label} {solver} {str(dtype)[6:]}: operator "
                      f"{res.operator}, float64 residual "
                      f"{res.true_residual:.3e}, {solve_s:.3f} s ({phases}); "
                      f"max|u - u_CG| / max|u_CG| = {gap:.3e}")
                want = ("dense-" if 3 * m.nnode <= 6000 else "banded-") \
                    + solver.lower()
                require(res.operator == want, f"{label}: {res.operator}")
                require(np.isfinite(res.u).all() and np.isfinite(
                    res.stress).all(), f"{label} {solver}: not finite")
                if dtype == torch.float64:
                    require(gap <= DIRECT_GAP,
                            f"{label} {solver}: {gap} from float64 CG")
    return general


def nonlinear_phase(lin_u, card, profile) -> None:
    """solve_nonlinear_statics on hex_beam(N, N, N), float32, NL_INCREMENTS
    increments, the tip load scaled so that the linear tip deflection
    (lin_u, the linear solve under hex_beam's 10 N) is NL_DEFLECTION of
    the side; then the internal force in float64 on the device at the
    returned u: the relative residual must be at most 1e-3."""
    from stan_tpu_torch.analysis import nonlinear
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.fem.operator import build_operator
    from stan_tpu_torch.utils.timing import PhaseTimer

    n = N
    w0 = float(np.abs(lin_u[:, 2]).max())
    P = -10.0 * NL_DEFLECTION * n / w0
    model = meshgen.hex_beam(n, n, n, load=(0.0, 0.0, P))
    model.analysis.inc_numb = NL_INCREMENTS
    print(f"[{card}] nonlinear {n}^3 ({model.ndof} DOF): tip load P = "
          f"{P:.6g} (linear tip deflection {NL_DEFLECTION:.0%} of the side "
          f"{n}), {NL_INCREMENTS} increments, float32")
    timer = PhaseTimer(verbose=False)
    t0 = time.perf_counter()
    res = nonlinear.solve_nonlinear_statics(model, device="cuda", timer=timer,
                                            store=False)
    total_s = time.perf_counter() - t0
    for r in timer.records:
        if not r["phase"].startswith("Increment"):
            print(f"[{card}] nonlinear phase {r['phase']}: "
                  f"{r['seconds']:.4f} s")
            continue
        its = sum(r["cg_iters"])
        print(f"[{card}] nonlinear {r['phase']}: {r['newton_iters']} Newton "
              f"iterations, relative residual {r['residual']}, CG "
              f"iterations per Newton step {r['cg_iters']}, "
              f"{r['seconds']:.3f} s, {r['seconds'] / max(its, 1) * 1e3:.4f} "
              f"ms per CG iteration (increment wall / CG iterations)")
    print(f"[{card}] nonlinear solve: {total_s:.3f} s in all, converged "
          f"{res.converged}, tip deflection "
          f"{float(np.abs(res.u[:, 2]).max()):.6g}")
    require(res.converged, f"nonlinear solve: residuals {res.residuals}")
    require(np.isfinite(res.u).all() and np.isfinite(res.stress).all(),
            "nonlinear solve not finite")

    op64 = build_operator(model.coords, model.conn, model.elem_d_matrices(),
                          model.fix_mask(), model.formulation(),
                          dtype=torch.float64, device="cuda")
    m = op64.free_mask
    f = m * torch.as_tensor(model.load_vector(), dtype=torch.float64,
                            device="cuda")
    u64 = torch.as_tensor(res.u, dtype=torch.float64, device="cuda")
    rel = float(torch.linalg.vector_norm(
        f - m * nonlinear.internal_force(op64, u64))
        / torch.linalg.vector_norm(f))
    print(f"[{card}] nonlinear: float64 relative residual at the returned u "
          f"{rel:.3e} (the solve's own, float32: {res.residuals[-1]:.3e})")
    require(rel <= 1e-3, f"nonlinear float64 residual {rel}")
    if profile:
        del op64, u64
        op = build_operator(model.coords, model.conn,
                            model.elem_d_matrices(), model.fix_mask(),
                            model.formulation(), dtype=torch.float32,
                            device="cuda")
        u = torch.as_tensor(res.u, device="cuda")
        rhs = op.free_mask * (f.float() - nonlinear.internal_force(op, u))
        profile_cg(nonlinear.tangent_operator(op, u), rhs, op.diagonal(),
                   f"the {n}^3 tangent", card, iters=50)


def three_forwards_phase(cal_model, obs, card) -> int:
    """One chain-batched log-posterior gradient at the same θ [CHAINS, 3]
    through the stencil, field (homogeneous broadcast) and general
    (prefer_stencil=False) forwards, in float32 (cg_tol 1e-6, the
    calibration's) and in float64 (cg_tol 1e-10). In float64 u and the
    gradient must agree to FORWARDS_GAP of their largest magnitude; in
    float32 to FORWARDS_GAP_F32, the float32 floor of the stencil and field
    operators. Returns the theta_sweep_batched launches of the stencil
    gradients and the general_apply launches of the general ones (at least
    one a batched loop iteration)."""
    from stan_tpu_torch.infer import calibrate, forward

    obs_nodes, obs_dirs, y, sigma = obs
    theta = (np.array([np.log(210000.0), 0.0, 0.0])
             + np.random.default_rng(5).normal(0.0, 0.1, (CHAINS, 3)))
    theta_c = np.stack([theta[:, 0], 0.5 / (1.0 + np.exp(-theta[:, 1])),
                        np.zeros(CHAINS)], axis=1)
    batched = general = 0
    for dtype, tol, bound in ((torch.float32, 1e-6, FORWARDS_GAP_F32),
                              (torch.float64, 1e-10, FORWARDS_GAP)):
        kw = dict(dtype=dtype, device="cuda", cg_tol=tol)
        stencil_prob = calibrate.make_problem(cal_model, obs_nodes, obs_dirs,
                                              y, sigma, **kw)
        probs = {
            "stencil": stencil_prob,
            "field": calibrate.CalibrationProblem(
                fwd=forward.build_structured_field_forward(cal_model, **kw),
                obs_idx=stencil_prob.obs_idx, y=stencil_prob.y,
                sigma_obs=stencil_prob.sigma_obs),
            "general": calibrate.make_problem(cal_model, obs_nodes, obs_dirs,
                                              y, sigma, prefer_stencil=False,
                                              **kw),
        }
        got = {}
        for name, prob in probs.items():
            require(type(prob.fwd).__name__ == {
                "stencil": "StencilForwardProblem",
                "field": "StructuredFieldForwardProblem",
                "general": "ForwardProblem"}[name], f"{name}: {prob.fwd}")
            th = torch.tensor(theta, device="cuda", requires_grad=True)
            reset_launches()
            st0 = prob.fwd.stats.as_dict()
            grad_s = wall(lambda: prob.log_posterior(th).sum().backward())
            st = prob.fwd.stats.since(st0)
            loop = st["forward_loop_iters"] + st["adjoint_loop_iters"]
            counts = dict(zip(KERNELS, launch_counts()))
            batched += counts["theta_sweep_batched"]
            general += counts["general_apply"]
            with torch.no_grad():
                u = forward.displacement_fn(prob.fwd, cal_model.nelem)(
                    torch.as_tensor(theta_c, device="cuda"))
            got[name] = (u.cpu().numpy(), th.grad.cpu().numpy())
            print(f"[{card}] {name} forward ({type(prob.fwd).__name__}), "
                  f"{str(dtype)[6:]}, one {CHAINS}-chain gradient at {G}^3: "
                  f"{grad_s:.4f} s (the field and general forwards' first "
                  f"in float32 carry the process's first use), batched loop "
                  f"iterations {st['forward_loop_iters']} forward + "
                  f"{st['adjoint_loop_iters']} adjoint, unconverged "
                  f"{st['forward_unconverged']} / "
                  f"{st['adjoint_unconverged']}, "
                  f"{grad_s / loop * 1e3:.4f} ms per batched iteration; "
                  f"launches {counts}")
            if name == "general":
                require(counts["general_apply"] >= loop,
                        f"general forward: {counts['general_apply']} "
                        f"general_apply launches < {loop} batched loop "
                        f"iterations")
        for name in ("field", "general"):
            gap_u = _max_gap(got[name][0], got["stencil"][0])
            gap_g = _max_gap(got[name][1], got["stencil"][1])
            print(f"[{card}] {name} vs stencil forward, {str(dtype)[6:]}: u "
                  f"gap {gap_u:.3e}, gradient gap {gap_g:.3e} (of the "
                  f"largest magnitude; bound {bound:g})")
            require(gap_u <= bound and gap_g <= bound,
                    f"{name} forward vs stencil, {dtype}: u {gap_u}, "
                    f"gradient {gap_g}")
    return batched, general


def two_material_beam(g):
    """hex_beam(g, g, g) with the elements at x >= L/2 a second material, E
    = 95000 (tests/test_field_forward.py:27-34)."""
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.core.model import Material

    m = meshgen.hex_beam(g, g, g)
    m.materials[2] = Material(id=2, name="soft", E=95000.0, poisson=0.3)
    elem_mat = np.asarray(m.elem_mat).reshape(g, g, g).copy()
    elem_mat[g // 2:] = 2
    m.elem_mat = elem_mat.reshape(-1)
    return m


def two_material_phase(theta0, card) -> None:
    """HMC through make_problem on the two-material G^3 beam (the field
    forward), observations from its own two-material solve: CHAINS chains,
    N_LEAPFROG steps, TWO_MAT_WARMUP + TWO_MAT_SAMPLES."""
    from stan_tpu_torch.infer import calibrate, forward, hmc

    m = two_material_beam(G)
    fwd = forward.build_forward(m, device="cuda", cg_tol=1e-6)
    with torch.no_grad():
        u_true = fwd.to_flat(fwd.solve(fwd.op0.lam_e, fwd.op0.mu_e))
    obs_nodes, obs_dirs, y, sigma = observe(u_true.cpu().numpy())
    prob = calibrate.make_problem(m, obs_nodes, obs_dirs, y, sigma,
                                  device="cuda", cg_tol=1e-6)
    require(isinstance(prob.fwd, forward.StructuredFieldForwardProblem),
            f"two-material route: {type(prob.fwd).__name__}")
    t0 = time.perf_counter()
    out = hmc.run_hmc(prob.log_posterior, theta0, 23,
                      n_samples=TWO_MAT_SAMPLES, n_warmup=TWO_MAT_WARMUP,
                      n_leapfrog=N_LEAPFROG, init_step=0.02,
                      solve_stats=prob.fwd.stats)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    st = out.solve_stats
    sps = CHAINS * sum(out.chunk_sizes) / sum(out.chunk_seconds)
    run_s = out.warmup_seconds + sum(out.chunk_seconds)
    print(f"[{card}] two-material HMC {G}^3 (field forward, {CHAINS} chains, "
          f"{N_LEAPFROG} leapfrog steps, {TWO_MAT_WARMUP} warmup + "
          f"{TWO_MAT_SAMPLES} samples): {wall_s:.2f} s, warmup "
          f"{out.warmup_seconds:.2f} s; samples/s (sampling phase) "
          f"{sps:.3f}; acceptance {float(np.mean(out.accept_rate)):.3f}; "
          f"{out.grad_evals} gradients, {run_s / out.grad_evals:.4f} s each; "
          f"unconverged {out.unconverged_forward} forward, "
          f"{out.unconverged_adjoint} adjoint (of {st['forward_solves']} "
          f"each)")
    _report_solves("two-material HMC", st, card)
    require(out.samples.shape == (CHAINS, TWO_MAT_SAMPLES, 3)
            and np.isfinite(out.samples).all(),
            "two-material HMC samples not finite")


def domain_mesh(n_chains: int, n_domain: int, card):
    """A chains x domain mesh over every visible card when there are enough
    of them, else over cuda:0 repeated; prints which."""
    from stan_tpu_torch.parallel import distributed

    need = n_chains * n_domain
    cards = torch.cuda.device_count()
    if cards >= need:
        mesh = distributed.device_mesh(n_chains, n_domain)
        which = f"cards 0-{need - 1} of {cards}"
    else:
        mesh = distributed.device_mesh(n_chains, n_domain,
                                       devices=["cuda:0"] * need)
        which = f"cuda:0 repeated {need} times ({cards} card(s) visible)"
    print(f"[{card}] {distributed.describe(mesh)}: {which}")
    return mesh


@contextlib.contextmanager
def sweeps_by_dtype(counts):
    """Within: stencil_sweep's kernel launches are also counted by dtype
    into counts (a Counter), from the wrapper's own launch count: the
    wrapper's calls, which include those that record a CUDA graph and not
    the graph's replays (solvers/cg.py)."""
    from stan_tpu_torch.fem import stencil

    sweep = stencil.stencil_sweep

    def counted(up, *args):
        before = launched("stencil_sweep")
        out = sweep(up, *args)
        counts[up.dtype] += launched("stencil_sweep") - before
        return out

    stencil.stencil_sweep = counted
    try:
        yield
    finally:
        stencil.stencil_sweep = sweep


def certified_phase(model, lin, timer, op32, card) -> int:
    """Phase 24: pcg_certified from zero on the 70^3 beam (float32
    corrections on the float32 StencilOperator, the float64 residual on
    the float64 StencilOperator's apply: both stencil_sweep), its answer
    checked by the host float64 twin (apply_numpy on exact_tables), timed
    against a plain float32 pcg to the same tolerance and beside phase 6's
    base CG and certification; then phase 6's certified u checked by the
    same twin (hostops.masked_f64_apply). Returns its stencil_sweep
    launches."""
    from stan_tpu_torch.fem import hostops, stencil
    from stan_tpu_torch.solvers import cg

    reset_launches()
    t_phase = time.perf_counter()
    ex = stencil.build_stencil_operator(model, dtype=torch.float64,
                                        device="cuda")
    require(ex is not None, "70^3 beam refused by build_stencil_operator")
    loads64 = torch.as_tensor(model.load_vector(), dtype=torch.float64,
                              device="cuda")
    b64 = (ex.free_mask * ex.to_grid(loads64)).contiguous()
    rhs = b64.to(torch.float32)
    diag = op32.diagonal()
    ndof = 3 * model.nnode
    setup_s = time.perf_counter() - t_phase

    def base():
        return cg.pcg(op32.apply, rhs, diag=diag, tol=CERT_TOL, ndof=ndof)

    base()  # warm, as pcg_certified(measure=True) reports a second run
    t0 = time.perf_counter()
    base_res = base()
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0

    by_dtype = collections.Counter()
    before = launched("stencil_sweep")
    with sweeps_by_dtype(by_dtype):
        cert = cg.pcg_certified(op32.apply, b64, ex.apply, diag=diag,
                                tol=CERT_TOL, ndof=ndof, measure=True)
    # The wrapper does not see the float32 sweeps that the inner CG's CUDA
    # graph replays; the launch counter does, and the rest are float64.
    f64 = by_dtype[torch.float64]
    f32 = launched("stencil_sweep") - before - f64

    # The host twin of the stencil operator: apply_numpy on exact_tables.
    t0 = time.perf_counter()
    twin = hostops.masked_f64_apply(model, op32)
    twin_s = time.perf_counter() - t0
    b_np = b64.cpu().numpy()
    bnorm = float(np.linalg.norm(b_np))

    def host_rel(u_grid):
        return float(np.linalg.norm(b_np - twin(u_grid))) / bnorm

    t0 = time.perf_counter()
    host = host_rel(cert.u.cpu().numpy())
    host_s = time.perf_counter() - t0
    lib = host_rel(op32.to_grid(torch.as_tensor(lin.u_certified)).numpy())

    phases = {r["phase"]: r for r in timer.records}
    lin_base = next(r for name, r in phases.items()
                    if name.startswith("Linear solve"))
    lin_cert = phases["Certify (f64 refinement)"]
    overhead = max(cert.seconds - base_s, 0.0) / max(base_s, 1e-9)
    print(f"[{card}] certified: " + json.dumps({
        "seconds": cert.seconds, "cycles": cert.cycles,
        "inner_iters": cert.inner_iters,
        "rel_residual_device_f64": cert.rel_residual,
        "rel_residual_host_f64_crosscheck": host,
        "converged": bool(cert.converged),
        "uncertified_base_seconds": base_s,
        "uncertified_base_iters": base_res.iters,
        "overhead_vs_uncertified_base": overhead,
        "phase6_base_cg_seconds": lin_base["seconds"],
        "phase6_base_cg_iters": lin_base["iters"],
        "phase6_certify_seconds": lin_cert["seconds"],
        "phase6_certify_iters": lin_cert["refine_iters"],
        "phase6_base_plus_certify_seconds":
            lin_base["seconds"] + lin_cert["seconds"],
        "stencil_sweep_f32_launches": f32,
        "stencil_sweep_f64_launches": f64,
        "solve_runs": 2}))
    print(f"[{card}] certified phase: set-up {setup_s:.3f} s, host twin "
          f"(hostops.masked_f64_apply: exact tables) {twin_s:.3f} s, one "
          f"host sweep (apply_numpy) {host_s:.3f} s; phase 6's u_certified "
          f"through the host twin: relative residual {lib!r} (phase 6's "
          f"certified residual {lin.true_residual!r}); "
          f"{time.perf_counter() - t_phase:.2f} s in all")
    require(cert.converged, "the certified solve did not converge")
    require(cert.rel_residual <= CERT_TOL,
            f"certified residual {cert.rel_residual}")
    require(host <= CERT_HOST_TOL, f"host cross-check {host}")
    require(abs(host - cert.rel_residual) <= CERT_AGREE * host,
            f"host {host} and device {cert.rel_residual} residuals "
            f"disagree")
    # measure=True runs the solve twice.
    require(f32 >= 2 * cert.inner_iters,
            f"{f32} float32 launches < 2 x {cert.inner_iters} iterations")
    require(f64 >= 2 * cert.cycles,
            f"{f64} float64 launches < 2 x {cert.cycles} cycles")
    require(lib <= CERT_HOST_TOL,
            f"phase 6's certified u: host float64 residual {lib}")
    require(abs(lib - lin.true_residual) <= CERT_SAME,
            f"phase 6's certified residual {lin.true_residual} is not the "
            f"host reading of its u, {lib}")
    return launched("stencil_sweep")


def model_gaps(a, b) -> list:
    """The fields in which two FEModels differ (arrays exactly; the small
    tables by value); [] when they are the same model."""
    gaps = []
    for name in ("node_ids", "coords", "elem_ids", "conn", "elem_pid",
                 "elem_mat", "disp", "strain", "stress"):
        x, y = getattr(a, name), getattr(b, name)
        if (x is None) != (y is None) or (
                x is not None and not np.array_equal(np.asarray(x),
                                                      np.asarray(y))):
            gaps.append(name)
    if a.elem_type != b.elem_type:
        gaps.append("elem_type")
    if a.import_errors != b.import_errors:
        gaps.append("import_errors")
    for name in ("materials", "part_info"):
        if ({k: vars(v) for k, v in getattr(a, name).items()}
                != {k: vars(v) for k, v in getattr(b, name).items()}):
            gaps.append(name)
    if repr(a.analysis) != repr(b.analysis):
        gaps.append("analysis")
    def same_bc(x, y):
        return ((x.id, x.type, x.name, x.color_id)
                == (y.id, y.type, y.name, y.color_id)
                and x.nodal_values.keys() == y.nodal_values.keys()
                and all(np.array_equal(v, y.nodal_values[n])
                        for n, v in x.nodal_values.items()))

    if a.bcs.keys() != b.bcs.keys() or not all(
            same_bc(a.bcs[k], b.bcs[k]) for k in a.bcs):
        gaps.append("bcs")
    return gaps


@contextlib.contextmanager
def numpy_bfs():
    """Within: bfs_node_order runs its numpy body, not the native walk."""
    from stan_tpu_torch import native

    saved = native.bfs_order
    native.bfs_order = lambda conn, nnode: None
    try:
        yield
    finally:
        native.bfs_order = saved


def openmp_runtimes() -> list:
    """The OpenMP runtime libraries mapped into this process."""
    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f
                 if "libgomp" in line or "libiomp" in line
                 or "libomp" in line}
    return sorted(paths)


def host_cpu() -> str:
    """The host CPU's vendor, model name (lscpu's where /proc/cpuinfo gives
    none), family, model and stepping numbers and its logical CPUs."""
    with open("/proc/cpuinfo") as f:
        info = [line.split(":", 1) for line in f if ":" in line]
    names = [v.strip() for k, v in info if k.strip() == "model name"]

    def first(key):
        return next((v.strip() for k, v in info if k.strip() == key), "?")

    model = names[0] if names and names[0] != "unknown" else None
    if model is None:
        try:
            out = subprocess.run(["lscpu"], capture_output=True,
                                 text=True).stdout
        except OSError:
            out = ""
        model = next((line.split(":", 1)[1].strip()
                      for line in out.splitlines()
                      if line.startswith("Model name:")), "unknown")
    return (f"{first('vendor_id')} {model} (family {first('cpu family')}, "
            f"model {first('model')}, stepping {first('stepping')}), "
            f"{len(names)} logical CPUs")


def host_runtime_phase(cg_iter_ms, before_ms, card) -> None:
    """Phase 25: the host runtime on hex_beam(N, N, N) (no results stored)
    against the port's Python bodies, each pair timed (seconds) and
    required equal; phase 6's CG ms per iteration (cg_iter_ms()) again
    right after the native sweep, beside before_ms, its value before any
    native sweep had run."""
    import os
    import tempfile

    from stan_tpu_torch import _build
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.fem import stencil
    from stan_tpu_torch.io import nastran, stdb
    from stan_tpu_torch.parallel import partition

    t_phase = time.perf_counter()
    model = meshgen.hex_beam(N, N, N)
    secs = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[key] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"beam{N}.STdb")
        timed("stdb.write", lambda: stdb.write(model, path))
        size = os.path.getsize(path)
        fast = timed("stdb.read native", lambda: stdb.read(path))

        def general():
            with open(path, "rb") as f:
                return stdb.from_proto(stdb.pb.Database.FromString(f.read()))

        slow = timed("stdb.read from_proto", general)
        stdb_gaps = model_gaps(fast, slow)
        bdf = os.path.join(tmp, f"beam{N}.bdf")
        timed("write_bdf", lambda: nastran.write_bdf(model, bdf))
        nat = timed("read_bdf native", lambda: nastran.read_bdf(bdf))
        py = timed("read_bdf python",
                   lambda: nastran.read_bdf_python(bdf))
        bdf_gaps = model_gaps(nat, py)
    conn = np.asarray(model.conn)
    order = timed("bfs_node_order native",
                  lambda: partition.bfs_node_order(conn, model.nnode))
    with numpy_bfs():
        order_py = timed("bfs_node_order numpy",
                         lambda: partition.bfs_node_order(conn, model.nnode))
    tables, deltas = stencil.exact_tables(model)
    u = np.random.default_rng(SEED).standard_normal(
        (3, *(n + 1 for n in (N, N, N))))
    f_nat = timed("apply_numpy native",
                  lambda: stencil.apply_numpy(tables, deltas, u))
    after = [cg_iter_ms(), cg_iter_ms()]  # right after the OpenMP sweep
    f_py = timed("apply_numpy numpy",
                 lambda: stencil.apply_numpy_reference(tables, deltas, u))
    sweep_gap = float(np.abs(f_nat - f_py).max() / np.abs(f_py).max())

    lib = _build.host_library_path(_build.CSRC / "stanfem.cpp")
    ldd = subprocess.run(["ldd", str(lib)], capture_output=True, text=True)
    print(f"[{card}] host runtime: {host_cpu()}; os.cpu_count() "
          f"{os.cpu_count()}, usable {len(os.sched_getaffinity(0))}, "
          f"torch.get_num_threads() {torch.get_num_threads()}, "
          f"OMP_NUM_THREADS {os.environ.get('OMP_NUM_THREADS')}")
    print(f"[{card}] host runtime: OpenMP runtimes mapped "
          f"{openmp_runtimes()}; ldd {lib.name}: "
          + "; ".join(line.strip() for line in ldd.stdout.splitlines()
                      if "omp" in line))
    print(f"[{card}] host runtime: " + json.dumps({
        "model": f"hex_beam({N},{N},{N})", "nnode": model.nnode,
        "nelem": model.nelem, "stdb_bytes": size,
        "seconds": secs,
        "stdb_gaps": stdb_gaps, "bdf_gaps": bdf_gaps,
        "bfs_equal": bool(np.array_equal(order, order_py)),
        "apply_numpy_rel_gap": sweep_gap,
        "cg_ms_per_iter_before_native_sweep": before_ms,
        "cg_ms_per_iter_after_native_sweep": after}))
    print(f"[{card}] host runtime phase: "
          f"{time.perf_counter() - t_phase:.2f} s in all")
    runtimes = openmp_runtimes()
    require(len(runtimes) == 1,
            f"{len(runtimes)} OpenMP runtimes mapped after the native sweep: "
            f"{runtimes}")
    require(not stdb_gaps, f"stdb.read and from_proto differ in {stdb_gaps}")
    require(fast.nnode == model.nnode and fast.nelem == model.nelem,
            "the STdb read back another model")
    require(not bdf_gaps, f"read_bdf native and Python differ in {bdf_gaps}")
    require(np.array_equal(nat.conn, model.conn)
            and nat.import_errors == [], "the .bdf read back another mesh")
    require(np.array_equal(order, order_py),
            "bfs_node_order: native and numpy orders differ")
    require(sorted(order.tolist()) == list(range(model.nnode)),
            "the BFS order is not a permutation")
    require(sweep_gap <= HOST_SWEEP_RTOL,
            f"apply_numpy native against numpy: {sweep_gap:.3e}")


def bench_phase(card) -> tuple:
    """Phase 26: the port's benchmark (stan_tpu_torch.bench.run) with its
    small sizes in this process, then stan_tpu_torch.calib_large at n = 12:
    every block ran and none was skipped, the certified residual <= 1e-6
    and equal to its host cross-check to 1e-8, each of the three kernels
    launched. Returns the phase's launches of (stencil_sweep, theta_sweep,
    theta_sweep_batched)."""
    import tempfile

    from stan_tpu_torch import bench, calib_large

    reset_launches()
    t0 = time.perf_counter()
    lines = []
    record, failed = bench.run(small=True, device="cuda",
                               emit=lines.append, lengths=BENCH_LENGTHS)
    for line in lines:
        print(f"[{card}] bench: {line}")
    blocks = [json.loads(line) for line in lines]
    require(not failed, f"bench blocks failed: {failed}")
    skipped = [b["block"] for b in blocks if "skipped" in b]
    require(not skipped, f"bench blocks skipped: {skipped}")
    require([b["block"] for b in blocks] == [
        "headline", "cpu_baseline", "solve_to_tol_1e6", "hmc_1", "hmc_2",
        "nuts", "chains_scaling"], f"bench blocks {blocks}")
    cert = record["solve_to_tol_1e6"]["certified"]
    dev_rel = cert["rel_residual_device_f64"]
    host_rel = cert["rel_residual_host_f64_crosscheck"]
    require(cert["converged"] and dev_rel <= CERT_TOL,
            f"bench: certified residual {dev_rel}")
    require(abs(host_rel - dev_rel) <= CERT_SAME,
            f"bench: certified residual {dev_rel} against the host's "
            f"{host_rel}")
    totals = {k: sum(c[k] for c in record["launches"].values())
              for k in bench.KERNELS}
    print(f"[{card}] bench (small, lengths {BENCH_LENGTHS}): "
          f"{time.perf_counter() - t0:.1f} s, launches {totals}")
    require(all(n > 0 for n in totals.values()),
            f"bench: a kernel was not launched: {totals}")
    with tempfile.TemporaryDirectory() as tmp:
        rc = calib_large.main(CALIB_LARGE_ARGS
                              + ["--runlog", f"{tmp}/runlog.jsonl"])
    require(rc == 0, f"calib_large exited {rc}")
    counts = launch_counts()
    print(f"[{card}] bench + calib_large: {time.perf_counter() - t0:.1f} s, "
          f"launches {counts}")
    return counts


def chains_scaling_phase(card) -> tuple:
    """Phase 27: stan_tpu_torch.chains_scaling.measure on the card at grid
    SCALING_GRID, SCALING_LENGTHS (warmup, draws), its 8 rows on [cuda:0] *
    8 (the visible cards round-robin on more): the record printed, the
    placed and unplaced 8-chain draws within SCALING_RTOL of their largest
    magnitude, theta_sweep in the 1-chain run and in the placed one-chain
    rows, theta_sweep_batched in the unplaced run alone. Returns the
    phase's launches of (stencil_sweep, theta_sweep,
    theta_sweep_batched)."""
    from stan_tpu_torch import chains_scaling

    reset_launches()
    t0 = time.perf_counter()
    warmup, draws = SCALING_LENGTHS
    rec, runs = chains_scaling.measure(SCALING_GRID, n_samples=draws,
                                       n_warmup=warmup, device="cuda")
    print(f"[{card}] chains_scaling: {json.dumps(rec)}")
    a = runs["8chains_placed"].samples
    b = runs["8chains_unplaced"].samples
    gap = float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))
    print(f"[{card}] chains_scaling placed vs unplaced draws, float64: "
          f"max |a - b| / max |b| {gap:.3e} (at most {SCALING_RTOL:g})")
    require(a.shape == b.shape == (chains_scaling.ROWS, draws, 3)
            and np.isfinite(a).all() and np.isfinite(b).all(),
            "chains_scaling: draws not finite or misshapen")
    require(gap <= SCALING_RTOL, f"chains_scaling: placed draws {gap} off "
            f"the unplaced ones")
    for name, counts in rec["launches"].items():
        single = name != "8chains_unplaced"
        require(counts["stencil_sweep"] == 0
                and (counts["theta_sweep"] > 0) == single
                and (counts["theta_sweep_batched"] > 0) != single,
                f"chains_scaling {name}: launches {counts}")
    counts = launch_counts()
    print(f"[{card}] chains_scaling: {time.perf_counter() - t0:.1f} s, "
          f"launches {counts}")
    return counts


@contextlib.contextmanager
def plain_sweeps_refused():
    """Within: a plain *_reference sweep called on a CUDA tensor raises, so
    a sharded path that fell back to the plain version on the card would
    fail the run."""
    from stan_tpu_torch.fem import stencil

    names = ("stencil_sweep_reference", "theta_sweep_reference")
    saved = {n: getattr(stencil, n) for n in names}

    def guard(name, fn):
        def checked(t, *args, **kw):
            require(t.device.type != "cuda",
                    f"{name} ran on a CUDA tensor in a sharded phase")
            return fn(t, *args, **kw)
        return checked

    for n, fn in saved.items():
        setattr(stencil, n, guard(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(stencil, n, fn)


def cat_pad(masks, us):
    """The reference's form of sharded_stencil.halo_pad_rows (masked slab,
    the neighbours' planes concatenated, then the y/z pad), for timing."""
    import torch.nn.functional as F

    um = [m * u for m, u in zip(masks, us)]
    out = []
    for s, u in enumerate(um):
        zero = torch.zeros_like(u[..., :1, :, :])
        left = um[s - 1][..., -1:, :, :].to(u.device) if s else zero
        right = um[s + 1][..., :1, :, :].to(u.device) if s + 1 < len(um) \
            else zero
        out.append(F.pad(torch.cat([left, u, right], dim=-3),
                         (1, 1, 1, 1)).contiguous())
    return out


def sharded_stencil_phases(card, profile, refs=None) -> int:
    """Phases 18-19 on hex_beam(*SHARD_BEAM) over SHARD_DOMAIN domains;
    returns the stencil_sweep launches of phase 19's sharded solves. refs
    (a dict) gets the sharded solve's u, iterations and host-clock ms per
    iteration, phase 23's one-process answer."""
    from stan_tpu_torch.analysis.linear import solve_linear_statics
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.fem import stencil, structured
    from stan_tpu_torch.parallel import sharded_stencil as ss
    from stan_tpu_torch.solvers import cg

    model = meshgen.hex_beam(*SHARD_BEAM)
    mesh = domain_mesh(1, SHARD_DOMAIN, card)
    rng = np.random.default_rng(18)
    ops = {}
    for dtype in (torch.float64, torch.float32):
        sop = stencil.build_stencil_operator(model, dtype=dtype,
                                             device="cuda")
        op = ss.build_sharded_stencil_operator(model, SHARD_DOMAIN,
                                               dtype=dtype, device="cuda")
        require(op is not None, f"{SHARD_BEAM} refused by the sharded "
                                f"stencil operator")
        u = torch.as_tensor(rng.standard_normal((3, *sop.node_shape)),
                            dtype=dtype, device="cuda")
        check_close(ss.sharded_apply(mesh, op, u), sop.apply(u), dtype,
                    f"sharded apply x{SHARD_DOMAIN} {list(sop.node_shape)} "
                    f"{str(dtype)[6:]} vs the single-device apply", card)
        ops[dtype] = (sop, op)

    sop, op = ops[torch.float32]
    f = sop.to_grid(torch.as_tensor(model.load_vector(), dtype=torch.float32,
                                    device="cuda")).contiguous()
    rhs = (sop.free_mask * f).contiguous()
    diag = sop.diagonal()
    runs = {"single": lambda: cg.pcg(sop.apply, rhs, diag=diag, tol=1e-6),
            "sharded": lambda: ss.sharded_stencil_pcg(mesh, op, f,
                                                      tol=1e-6)}
    got, secs = {}, {"single": [], "sharded": []}
    for name in ("single", "sharded", "sharded", "single"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[name] = runs[name]()
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
    per_it = {k: [t / got[k].iters * 1e3 for t in v] for k, v in secs.items()}
    single, shard = got["single"], got["sharded"]
    gap = float((shard.u - single.u).abs().max() / single.u.abs().max())
    sop64 = structured.build_structured_operator(model, dtype=torch.float64,
                                                 device="cuda")
    b = sop64.free_mask * sop64.to_grid(torch.as_tensor(
        model.load_vector(), dtype=torch.float64, device="cuda"))
    rel = {k: float(torch.linalg.vector_norm(
        b - sop64.apply(r.u.to(torch.float64))) / torch.linalg.vector_norm(b))
        for k, r in got.items()}
    print(f"[{card}] float32 CG to 1e-6 on {list(sop.node_shape)} "
          f"({model.ndof} DOF): single device {single.iters} iterations, "
          f"sharded x{SHARD_DOMAIN} {shard.iters}; ms per iteration "
          f"(host clock, in turns single, sharded, sharded, single): single "
          f"{per_it['single'][0]:.4f} / {per_it['single'][1]:.4f}, sharded "
          f"{per_it['sharded'][0]:.4f} / {per_it['sharded'][1]:.4f}; "
          f"max|u - u_single| / max|u| = {gap:.3e}; float64 relative "
          f"residual (structured operator) single {rel['single']:.3e}, "
          f"sharded {rel['sharded']:.3e}")
    require(shard.converged, "sharded CG did not converge")
    require(abs(shard.iters - single.iters) <= SHARD_ITERS_GAP * single.iters,
            f"sharded CG {shard.iters} iterations vs {single.iters}")
    require(gap <= SHARD_U_GAP, f"sharded u off the single-device u: {gap}")
    # Both are float32 answers: their float64 residual is set by the
    # float32 rounding of the tables, not by CG's 1e-6.
    require(rel["sharded"] <= 2 * rel["single"],
            f"sharded u's float64 residual {rel['sharded']} vs the single "
            f"device's {rel['single']}")
    if refs is not None:
        refs["stencil"] = (shard.u.cpu().numpy(), shard.iters,
                           per_it["sharded"])

    reset_launches()
    res = ss.sharded_stencil_pcg(mesh, op, f, tol=1e-6)
    flags = {k[1:]: n for k, n in flag_launches().items()
             if k[0] == "stencil_sweep"}
    print(f"[{card}] stencil_sweep launches of one sharded solve "
          f"({res.iters} iterations) by flag pair (is_low, is_high): "
          f"{dict(sorted(flags.items()))}")
    for pair in ((1, 0), (0, 0), (0, 1)):
        require(flags.get(pair, 0) >= res.iters,
                f"flags {pair}: {flags.get(pair, 0)} launches < "
                f"{res.iters} iterations")
    want = ("sharded-stencilx4" if torch.cuda.device_count() >= SHARD_DOMAIN
            else "stencil")
    t0 = time.perf_counter()
    lin = solve_linear_statics(model, device="cuda", n_domain=SHARD_DOMAIN,
                               store=False)
    torch.cuda.synchronize()
    print(f"[{card}] solve_linear_statics(n_domain={SHARD_DOMAIN}) on "
          f"{torch.cuda.device_count()} card(s): operator {lin.operator}, "
          f"n_domain {lin.n_domain}, {lin.iters} iterations, certified "
          f"residual {lin.true_residual}, {time.perf_counter() - t0:.3f} s")
    require(lin.operator == want, f"operator {lin.operator}, want {want}")
    require(lin.converged and lin.true_residual <= 1e-6,
            f"sharded linear solve: {lin.true_residual}")
    launches = launched("stencil_sweep")
    print(f"[{card}] stencil_sweep launches in phase 19's counted runs: "
          f"{launches} ({flag_launches()})")

    if profile:
        profile_cg(None, None, None, f"the {list(sop.node_shape)} sharded "
                   f"x{SHARD_DOMAIN} stencil operator", card, run=lambda:
                   ss.sharded_stencil_pcg(mesh, op, f, tol=0.0, maxiter=100),
                   top=10)
        profile_cg(sop.apply, rhs, diag, f"the same grid on one device",
                   card)
        masks = list(sop.free_mask.tensor_split(SHARD_DOMAIN, dim=1))
        us = list(f.tensor_split(SHARD_DOMAIN, dim=1))
        def halo_pad():
            return ss.halo_pad_rows(mesh, [masks], [us])[0]

        pads = (time_ms(halo_pad, 50), time_ms(lambda: cat_pad(masks, us), 50),
                time_ms(halo_pad, 50), time_ms(lambda: cat_pad(masks, us), 50))
        same = all(torch.equal(a, b)
                   for a, b in zip(halo_pad(), cat_pad(masks, us)))
        print(f"[{card}] halo padding of {SHARD_DOMAIN} slabs (CUDA events, "
              f"in turns): into padded buffers {pads[0]:.4f} / "
              f"{pads[2]:.4f} ms, concatenate then pad {pads[1]:.4f} / "
              f"{pads[3]:.4f} ms; same values {same}")
    return launches


def sharded_general_phase(card, refs=None) -> None:
    """Phase 20: the sharded general operator on hex_beam(*BAND_BEAM), each
    (domains, ring) of SHARD_GENERAL, float64 CG to DIRECT_CG_TOL against
    the single-device general operator's. refs (a dict) gets each run's u,
    iterations and ms per iteration, phase 23's one-process answers."""
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.fem.operator import build_operator
    from stan_tpu_torch.parallel import sharded
    from stan_tpu_torch.solvers import cg

    model = meshgen.hex_beam(*BAND_BEAM)
    args = (model.coords, model.conn, model.elem_d_matrices(),
            model.fix_mask(), model.formulation())
    gop = build_operator(*args, dtype=torch.float64, device="cuda")
    loads = model.load_vector()
    f = gop.free_mask * torch.as_tensor(loads, dtype=torch.float64,
                                        device="cuda")
    t0 = time.perf_counter()
    ref = cg.pcg(gop.apply, f, diag=gop.diagonal(), tol=DIRECT_CG_TOL)
    ref_s = time.perf_counter() - t0
    ref_u = ref.u.cpu().numpy()
    print(f"[{card}] hex_beam{BAND_BEAM} ({model.ndof} DOF) general operator "
          f"float64 CG to {DIRECT_CG_TOL:g}: {ref.iters} iterations, "
          f"{ref_s:.3f} s")
    for ndev, ring in SHARD_GENERAL:
        mesh = domain_mesh(1, ndev, card)
        op, part = sharded.build_sharded_operator(
            *args, ndev, dtype=torch.float64, prefer_ring=ring,
            device="cuda")
        require(op.ring == ring, f"{ndev} domains: ring {op.ring}")
        fp = torch.as_tensor(sharded.shard_rhs(part, loads),
                             dtype=torch.float64, device="cuda")
        t0 = time.perf_counter()
        res = sharded.sharded_pcg(mesh, op, fp, tol=DIRECT_CG_TOL)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        gap = _max_gap(sharded.unshard_u(part, res.u.cpu().numpy()), ref_u)
        print(f"[{card}] sharded general x{ndev} "
              f"({'ring' if ring else 'all-gather'}, block {op.block} "
              f"nodes): {res.iters} iterations, converged {res.converged}, "
              f"{run_s:.3f} s ({run_s / res.iters * 1e3:.4f} ms per "
              f"iteration; single device {ref_s / ref.iters * 1e3:.4f}); "
              f"max|u - u_single| / max|u| = {gap:.3e}")
        require(res.converged and gap <= DIRECT_GAP,
                f"sharded general x{ndev}: gap {gap}")
        if refs is not None:
            refs["general", ndev] = (res.u.cpu().numpy(), res.iters,
                                     run_s / res.iters * 1e3)


def sharded_calibration_phase(cal_model, obs, theta0, card, refs=None
                              ) -> int:
    """Phase 21: the sharded calibration forward on a SHARD_MESH mesh;
    returns the theta_sweep_batched launches of its HMC run. refs (a dict)
    gets its 16 θ and the one-process float32 value and gradient there,
    phase 23's one-process answer."""
    from stan_tpu_torch.infer import calibrate, hmc

    mesh = domain_mesh(*SHARD_MESH, card)
    theta = (np.array([np.log(210000.0), 0.0, 0.0])
             + np.random.default_rng(21).normal(0.0, 0.1, (CHAINS, 3)))
    th = torch.as_tensor(theta, device="cuda")
    got = {}
    for name in ("unsharded", "sharded"):
        kw = dict(dtype=torch.float64, cg_tol=1e-12)
        if name == "sharded":
            lgb = calibrate.make_sharded_problem(cal_model, mesh, *obs,
                                                 **kw).logp_grad_b()
        else:
            lgb = hmc.guarded_logp_grad_b(calibrate.make_problem(
                cal_model, *obs, device="cuda", **kw).log_posterior)
        got[name] = [t.cpu().numpy() for t in lgb(th)]
    gap_v = float(np.max(np.abs(got["sharded"][0] - got["unsharded"][0])
                         / np.abs(got["unsharded"][0])))
    gap_g = _max_gap(got["sharded"][1], got["unsharded"][1])
    print(f"[{card}] sharded calibration {SHARD_MESH[0]} x {SHARD_MESH[1]} "
          f"vs make_problem, float64, {CHAINS} θ, cg_tol 1e-12: log "
          f"posterior gap {gap_v:.3e} (relative, per chain), gradient gap "
          f"{gap_g:.3e} (of the largest entry)")
    require(gap_v <= SHARD_FWD_RTOL and gap_g <= SHARD_FWD_RTOL,
            f"sharded calibration off make_problem: {gap_v}, {gap_g}")

    probs = calibrate.make_sharded_problem(cal_model, mesh, *obs,
                                           cg_tol=1e-6)
    prob1 = calibrate.make_problem(cal_model, *obs, device="cuda",
                                   cg_tol=1e-6)
    lgbs = {"sharded": probs.logp_grad_b(),
            "unsharded": hmc.guarded_logp_grad_b(prob1.log_posterior)}
    secs = {"sharded": [], "unsharded": []}
    # The first call of each pays its set-up.
    first = {name: [t.cpu().numpy() for t in lgbs[name](th)]
             for name in ("unsharded", "sharded")}
    if refs is not None:
        refs["forward"] = (theta, first["sharded"])
    for name in ("unsharded", "sharded", "sharded", "unsharded"):
        secs[name].append(wall(lambda: lgbs[name](th)))
    print(f"[{card}] one float32 {CHAINS}-chain gradient at {G}^3 (host "
          f"clock, in turns): unsharded {secs['unsharded'][0]:.4f} / "
          f"{secs['unsharded'][1]:.4f} s, sharded {SHARD_MESH[0]} x "
          f"{SHARD_MESH[1]} {secs['sharded'][0]:.4f} / "
          f"{secs['sharded'][1]:.4f} s")

    reset_launches()
    t0 = time.perf_counter()
    out = hmc.run_chains(probs.logp_grad_b(), hmc.hmc_kernel(SHARD_LEAPFROG),
                         theta0, 29, n_samples=SHARD_SAMPLES,
                         n_warmup=SHARD_WARMUP, init_step=0.02,
                         target_accept=0.8, solve_stats=probs.fwd.stats)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    st = out.solve_stats
    batched = launched("theta_sweep_batched")
    loop = st["forward_loop_iters"] + st["adjoint_loop_iters"]
    print(f"[{card}] sharded HMC {G}^3 on {SHARD_MESH[0]} x {SHARD_MESH[1]} "
          f"({CHAINS} chains, {SHARD_LEAPFROG} leapfrog steps, "
          f"{SHARD_WARMUP} warmup + {SHARD_SAMPLES} samples): {wall_s:.2f} s, "
          f"{out.grad_evals} gradients; acceptance "
          f"{float(np.mean(out.accept_rate)):.3f}; theta_sweep_batched "
          f"{batched}, theta_sweep {launched('theta_sweep')} "
          f"({flag_launches()})")
    _report_solves("sharded HMC", st, card)
    require(out.samples.shape == (CHAINS, SHARD_SAMPLES, 3)
            and np.isfinite(out.samples).all(), "sharded HMC not finite")
    require(float(np.mean(out.accept_rate)) > 0.0, "sharded HMC acceptance 0")
    require(batched >= SHARD_MESH[0] * SHARD_MESH[1] * loop,
            f"{batched} batched launches < {SHARD_MESH} slabs x {loop} "
            f"batched loop iterations")
    return batched


@contextlib.contextmanager
def batched_shapes():
    """Within: a Counter of theta_sweep_batched calls by batch size B (up's
    axis 0), beside the wrapper's own launch count, which it leaves as it
    is."""
    from collections import Counter

    from stan_tpu_torch.fem import stencil

    seen = Counter()
    inner = stencil.theta_sweep_batched

    def recorded(up_b, *args, **kw):
        seen[up_b.shape[0]] += 1
        return inner(up_b, *args, **kw)

    stencil.theta_sweep_batched = recorded
    try:
        yield seen
    finally:
        stencil.theta_sweep_batched = inner


def _placed_launches(label, st, seen, card) -> int:
    """Check and print one placed run's theta_sweep_batched launches: at
    least the batched loop iterations summed over the rows (one SolveStats
    for every row's forward); returns them."""
    batched = launched("theta_sweep_batched")
    loop = st["forward_loop_iters"] + st["adjoint_loop_iters"]
    print(f"[{card}] {label}: theta_sweep_batched {batched} (by chains per "
          f"launch {dict(sorted(seen.items()))}), theta_sweep "
          f"{launched('theta_sweep')}; batched loop iterations over the rows "
          f"{loop}")
    _report_solves(label, st, card)
    require(batched >= loop, f"{label}: {batched} batched launches < {loop} "
            f"batched loop iterations over the rows")
    return batched


def chain_placement_phase(cal_model, obs, theta0, card, refs=None) -> int:
    """Phase 22: the 32^3 calibration's chains placed over a PLACE_ROWS x 1
    mesh through make_problem(mesh=) and run_hmc / run_nuts / run_smc
    (mesh=); returns the theta_sweep_batched launches of its runs. refs (a
    dict) gets the unplaced float64 HMC run, phase 23's one-process
    answer."""
    from stan_tpu_torch.infer import calibrate, hmc, nuts, smc

    mesh = domain_mesh(PLACE_ROWS, 1, card)
    kinds = ("unplaced", "placed")

    def problem(kind, **kw):
        where = dict(mesh=mesh) if kind == "placed" else dict(device="cuda")
        return calibrate.make_problem(cal_model, *obs, **where, **kw)

    launches = 0
    out = {}
    for kind in kinds:
        prob = problem(kind, dtype=torch.float64, cg_tol=1e-10)
        reset_launches()
        t0 = time.perf_counter()
        with batched_shapes() as seen:
            out[kind] = hmc.run_hmc(
                prob.log_posterior, theta0, 31, n_samples=PLACE_SAMPLES,
                n_warmup=PLACE_WARMUP, n_leapfrog=PLACE_LEAPFROG,
                init_step=0.02, solve_stats=prob.fwd.stats,
                mesh=mesh if kind == "placed" else None)
            torch.cuda.synchronize()
        res = out[kind]
        print(f"[{card}] HMC {kind} {G}^3 float64 cg_tol 1e-10 ({CHAINS} "
              f"chains, {PLACE_LEAPFROG} leapfrog steps, {PLACE_WARMUP} "
              f"warmup + {PLACE_SAMPLES} samples): "
              f"{time.perf_counter() - t0:.2f} s, {res.grad_evals} "
              f"gradients; acceptance {float(np.mean(res.accept_rate)):.3f}")
        launches += _placed_launches(f"HMC {kind} float64",
                                     res.solve_stats, seen, card)
    a, b = out["placed"], out["unplaced"]
    gap = float(np.max(np.abs(a.samples - b.samples)
                       / (PLACE_ATOL + PLACE_RTOL * np.abs(b.samples))))
    print(f"[{card}] placed vs unplaced HMC samples, float64: max |a - b| "
          f"{float(np.max(np.abs(a.samples - b.samples))):.3e}, "
          f"{gap:.3e} of the tolerance (rtol {PLACE_RTOL:g}, atol "
          f"{PLACE_ATOL:g}); per-chain forward solves "
          f"{a.solve_stats['forward_solves']} / "
          f"{b.solve_stats['forward_solves']}")
    require(a.samples.shape == b.samples.shape == (CHAINS, PLACE_SAMPLES, 3)
            and np.isfinite(a.samples).all(), "placed HMC not finite")
    require(gap <= 1.0, f"placed HMC off the unplaced run: {gap}")
    if refs is not None:
        refs["hmc"] = b

    probs = {kind: problem(kind, cg_tol=1e-6) for kind in kinds}
    lgbs = {kind: hmc.guarded_logp_grad_b(probs[kind].log_posterior)
            for kind in kinds}
    lgbs["placed"] = mesh.by_rows(lgbs["placed"])
    th = torch.as_tensor(theta0, dtype=torch.float32)
    secs = {kind: [] for kind in kinds}
    for kind in kinds:
        lgbs[kind](th)  # the first call of each pays its set-up
    for kind in ("unplaced", "placed", "placed", "unplaced"):
        secs[kind].append(wall(lambda: lgbs[kind](th)))
    print(f"[{card}] one float32 {CHAINS}-chain gradient at {G}^3 (host "
          f"clock, in turns): unplaced {secs['unplaced'][0]:.4f} / "
          f"{secs['unplaced'][1]:.4f} s, placed on {PLACE_ROWS} rows "
          f"{secs['placed'][0]:.4f} / {secs['placed'][1]:.4f} s")

    prob = probs["placed"]
    reset_launches()
    t0 = time.perf_counter()
    with batched_shapes() as seen:
        res = nuts.run_nuts(prob.log_posterior, theta0, 37,
                            max_depth=PLACE_NUTS_DEPTH,
                            n_warmup=PLACE_WARMUP, n_samples=PLACE_SAMPLES,
                            init_step=0.02, solve_stats=prob.fwd.stats,
                            mesh=mesh)
        torch.cuda.synchronize()
    print(f"[{card}] NUTS placed {G}^3 float32 ({CHAINS} chains, max_depth "
          f"{PLACE_NUTS_DEPTH}, {PLACE_WARMUP} warmup + {PLACE_SAMPLES} "
          f"samples): {time.perf_counter() - t0:.2f} s, {res.grad_evals} "
          f"gradients, evals_per_sample mean "
          f"{float(np.mean(res.evals_per_sample)):.2f}")
    launches += _placed_launches("NUTS placed float32", res.solve_stats,
                                 seen, card)
    require(np.isfinite(res.samples).all(), "placed NUTS not finite")

    st0 = prob.fwd.stats.as_dict()
    reset_launches()
    t0 = time.perf_counter()
    with batched_shapes() as seen:
        res = smc.run_smc(prob.log_prior, prob.log_likelihood,
                          prob.sample_prior, 41, n_particles=SMC_PARTICLES,
                          n_mcmc=SMC_MCMC, max_stages=PLACE_SMC_STAGES,
                          mesh=mesh)
        torch.cuda.synchronize()
    print(f"[{card}] SMC placed {G}^3 float32 ({SMC_PARTICLES} particles, "
          f"{SMC_MCMC} Metropolis steps, at most {PLACE_SMC_STAGES} stages):"
          f" {time.perf_counter() - t0:.2f} s; temperatures "
          f"{np.round(res.temperatures, 6).tolist()}")
    launches += _placed_launches("SMC placed float32",
                                 prob.fwd.stats.since(st0), seen, card)
    require(np.isfinite(res.particles).all()
            and np.isfinite(res.log_evidence), "placed SMC not finite")
    return launches

@contextlib.contextmanager
def transport_clock():
    """Within: the seconds spent in the transport between processes,
    DeviceMesh.exchange (halo planes, neighbour blocks) and
    distributed.all_sum (dots, joins), each call timed on the host clock
    from a synchronised card to its end."""
    from stan_tpu_torch.parallel import distributed

    spent = {"exchange": 0.0, "all_sum": 0.0}
    inner = {"exchange": distributed.DeviceMesh.exchange,
             "all_sum": distributed.all_sum}

    def timed(name):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner[name](*args, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return call

    distributed.DeviceMesh.exchange = timed("exchange")
    distributed.all_sum = timed("all_sum")
    try:
        yield spent
    finally:
        distributed.DeviceMesh.exchange = inner["exchange"]
        distributed.all_sum = inner["all_sum"]


def process_worker(rank: int, folder: str, backend: str) -> None:
    """One of phase 23's two workers: joins the other over a file in
    `folder`, loads the kernels the parent built (compiling nothing), runs
    the sharded solve, the sharded general operator, placed HMC and the
    sharded forward on its blocks, and writes its answers and counts to
    `folder`. Prints no result line."""
    from stan_tpu_torch import _build
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.infer import calibrate, hmc
    from stan_tpu_torch.parallel import distributed, sharded
    from stan_tpu_torch.parallel import sharded_stencil as ss

    folder = pathlib.Path(folder)
    built = [_build.library_path(src) for src in _build.sources()]
    require(all(p.exists() for p in built),
            f"worker {rank}: the parent built no {built}")
    for src in _build.sources():
        _build.library(src.stem)
    dev = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
    distributed.initialize(f"file://{folder / 'rendezvous'}", 2, rank,
                           backend=backend, local_devices=[dev] * 3,
                           timeout=PROC_TIMEOUT)
    g = distributed.devices()  # g[0:3] on process 0, g[3:6] on process 1
    given = np.load(folder / "inputs.npz")
    obs = (given["obs_nodes"], given["obs_dirs"], given["y"],
           float(given["sigma"]))
    out, report = {}, {"rank": rank}

    # The transport's floor: all_sum of 4 floats on the card (staged) and
    # on the host, 200 calls each, nothing else between them.
    report["all_sum_us"] = {}
    for where in ("cuda", "cpu"):
        t = torch.zeros(4, device=dev if where == "cuda" else "cpu")
        distributed.all_sum(t)
        t0 = time.perf_counter()
        for _ in range(200):
            distributed.all_sum(t)
        report["all_sum_us"][where] = (time.perf_counter() - t0) / 200 * 1e6

    # The 72-plane beam on 1 x 4, two slabs per process: the halo between
    # slabs 1 and 2 crosses the processes.
    mesh = distributed.device_mesh(1, SHARD_DOMAIN,
                                   devices=[g[0], g[1], g[3], g[4]])
    model = meshgen.hex_beam(*SHARD_BEAM)
    t0 = time.perf_counter()
    op = ss.build_sharded_stencil_operator(model, SHARD_DOMAIN,
                                           dtype=torch.float32,
                                           device=mesh.home)
    f = torch.as_tensor(model.load_vector(), dtype=torch.float32,
                        device=mesh.home).reshape(
        *op.free_mask.shape[1:], 3).permute(3, 0, 1, 2).contiguous()
    report["stencil_setup_s"] = time.perf_counter() - t0
    reset_launches()
    res = ss.sharded_stencil_pcg(mesh, op, f, tol=1e-6)
    torch.cuda.synchronize()
    report["stencil_flags"] = {f"{k[1]}{k[2]}": n for k, n in
                               flag_launches().items()
                               if k[0] == "stencil_sweep"}
    out["stencil_u"], report["stencil_iters"] = res.u.cpu().numpy(), res.iters
    report["stencil_launches"] = launched("stencil_sweep")
    # Then one solve timed, and one with the transport's calls timed (each
    # from a synchronised card, which adds syncs of its own).
    t0 = time.perf_counter()
    ss.sharded_stencil_pcg(mesh, op, f, tol=1e-6)
    torch.cuda.synchronize()
    report["stencil_ms_per_it"] = (time.perf_counter() - t0) / res.iters * 1e3
    with transport_clock() as spent:
        t0 = time.perf_counter()
        ss.sharded_stencil_pcg(mesh, op, f, tol=1e-6)
        torch.cuda.synchronize()
        report["stencil_clocked_ms_per_it"] = ((time.perf_counter() - t0)
                                               / res.iters * 1e3)
    report["stencil_transport_ms_per_it"] = {
        k: v / res.iters * 1e3 for k, v in spent.items()}
    del op, f, res

    # The sharded general operator on the banded beam: the ring on 1 x 4
    # (two blocks per process), the all-gather on 1 x 3 (two and one).
    band = meshgen.hex_beam(*BAND_BEAM)
    args = (band.coords, band.conn, band.elem_d_matrices(),
            band.fix_mask(), band.formulation())
    for ndev, ring in SHARD_GENERAL:
        mesh = distributed.device_mesh(1, ndev, devices=[g[0], g[1], g[3],
                                                         g[4]][:ndev])
        gop, part = sharded.build_sharded_operator(
            *args, ndev, dtype=torch.float64, prefer_ring=ring,
            device=mesh.home)
        fp = torch.as_tensor(sharded.shard_rhs(part, band.load_vector()),
                             dtype=torch.float64, device=mesh.home)
        with transport_clock() as spent:
            t0 = time.perf_counter()
            res = sharded.sharded_pcg(mesh, gop, fp, tol=DIRECT_CG_TOL)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        out[f"general{ndev}_u"] = res.u.cpu().numpy()
        report[f"general{ndev}"] = {
            "iters": res.iters, "ms_per_it": run_s / res.iters * 1e3,
            "transport_ms_per_it": {k: v / res.iters * 1e3
                                    for k, v in spent.items()}}

    # The 32^3 calibration's chains on 2 x 1, row r on process r: float64
    # HMC as phase 22's unplaced run (same θ0, seed and lengths).
    cal_model = meshgen.hex_beam(G, G, G)
    mesh = distributed.device_mesh(PROC_ROWS, 1, devices=[g[0], g[3]])
    prob = calibrate.make_problem(cal_model, *obs, mesh=mesh,
                                  dtype=torch.float64, cg_tol=1e-10)
    reset_launches()
    t0 = time.perf_counter()
    res = hmc.run_hmc(prob.log_posterior,
                      torch.as_tensor(given["theta0"], device=mesh.home), 31,
                      n_samples=PLACE_SAMPLES, n_warmup=PLACE_WARMUP,
                      n_leapfrog=PLACE_LEAPFROG, init_step=0.02,
                      solve_stats=prob.fwd.stats, mesh=mesh)
    torch.cuda.synchronize()
    st = prob.fwd.stats
    report["hmc"] = {
        "seconds": time.perf_counter() - t0, "grad_evals": res.grad_evals,
        "solve_stats": res.solve_stats,
        "local_loop_iters": st.forward_loop_iters + st.adjoint_loop_iters,
        "theta_sweep_batched": launched("theta_sweep_batched")}
    out["hmc_samples"] = res.samples
    del prob, res

    # The chains x domain forward on 2 x 3, one row per process: one
    # float32 16-chain value and gradient at phase 21's θ.
    mesh = distributed.device_mesh(*SHARD_MESH, devices=g)
    probs = calibrate.make_sharded_problem(cal_model, mesh, *obs,
                                           cg_tol=1e-6)
    th = torch.as_tensor(given["theta_fwd"], device=mesh.home)
    reset_launches()
    t0 = time.perf_counter()
    value, grad = probs.logp_grad_b()(th)
    torch.cuda.synchronize()
    report["forward"] = {"seconds": time.perf_counter() - t0,
                         "theta_sweep_batched":
                             launched("theta_sweep_batched")}
    out["forward_value"], out["forward_grad"] = (value.cpu().numpy(),
                                                 grad.cpu().numpy())
    np.savez(folder / f"out{rank}.npz", **out)
    (folder / f"report{rank}.json").write_text(json.dumps(report))
    torch.distributed.destroy_process_group()


def processes_phase(card, refs, cal_model, obs, theta0) -> tuple:
    """Phase 23: two worker processes (process_worker) over NCCL with one
    card each when there are two or more cards, else over gloo on cuda:0,
    against the one-process answers of phases 19-22 (refs) and the
    one-process run of placed HMC on a PROC_ROWS x 1 mesh, the workers'
    shape; returns the (stencil_sweep, theta_sweep_batched) launches of
    the workers and of that run."""
    import tempfile

    from stan_tpu_torch.infer import calibrate, hmc

    mesh = domain_mesh(PROC_ROWS, 1, card)
    prob = calibrate.make_problem(cal_model, *obs, mesh=mesh,
                                  dtype=torch.float64, cg_tol=1e-10)
    reset_launches()
    t0 = time.perf_counter()
    one = hmc.run_hmc(prob.log_posterior, theta0, 31, n_samples=PLACE_SAMPLES,
                      n_warmup=PLACE_WARMUP, n_leapfrog=PLACE_LEAPFROG,
                      init_step=0.02, solve_stats=prob.fwd.stats, mesh=mesh)
    torch.cuda.synchronize()
    one_batched = launched("theta_sweep_batched")
    print(f"[{card}] placed HMC float64 on {PROC_ROWS} x 1 in one process: "
          f"{time.perf_counter() - t0:.2f} s, {one.grad_evals} gradients; "
          f"theta_sweep_batched {one_batched}")
    del prob
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    print(f"[{card}] phase 23: two processes over {backend} "
          f"({cards} card(s) visible: "
          f"{'one card per rank' if backend == 'nccl' else 'both ranks on cuda:0, every CUDA tensor staged through pinned host memory'})")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        folder = pathlib.Path(tmp)
        theta_fwd, _ = refs["forward"]
        np.savez(folder / "inputs.npz", obs_nodes=obs[0], obs_dirs=obs[1],
                 y=obs[2], sigma=obs[3], theta0=theta0.cpu().numpy(),
                 theta_fwd=theta_fwd)
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--process-worker", str(rank), tmp,
             backend], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(2)]
        texts = [None, None]
        try:
            for rank, p in enumerate(procs):
                left = PROC_TIMEOUT - (time.perf_counter() - t_phase)
                texts[rank] = p.communicate(timeout=max(left, 1.0))[0]
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, (p, text) in enumerate(zip(procs, texts)):
            require(text is not None and p.returncode == 0,
                    f"phase 23 worker {rank}: exit code {p.returncode} "
                    f"after {time.perf_counter() - t_phase:.1f} s\n"
                    f"{(text or '')[-6000:]}")
        reports = [json.loads((folder / f"report{r}.json").read_text())
                   for r in range(2)]
        outs = [dict(np.load(folder / f"out{r}.npz")) for r in range(2)]
    workers_s = time.perf_counter() - t_phase

    u1, iters1, ms1 = refs["stencil"]
    scale = float(np.abs(u1).max())
    for rep, out in zip(reports, outs):
        r = rep["rank"]
        gap = float(np.abs(out["stencil_u"] - u1).max()) / scale
        tr = rep["stencil_transport_ms_per_it"]
        print(f"[{card}] rank {r}: all_sum of 4 floats, 200 calls: "
              f"{rep['all_sum_us']['cuda']:.1f} µs on the card, "
              f"{rep['all_sum_us']['cpu']:.1f} µs on the host")
        print(f"[{card}] rank {r}: sharded stencil CG x{SHARD_DOMAIN} over 2 "
              f"processes {rep['stencil_iters']} iterations (one process "
              f"{iters1}), max|u - u_one| / max|u| = {gap:.3e}; ms per "
              f"iteration {rep['stencil_ms_per_it']:.4f} (one process "
              f"{ms1[0]:.4f} / {ms1[1]:.4f}); with the transport clocked "
              f"{rep['stencil_clocked_ms_per_it']:.4f}, of which "
              f"{tr['exchange']:.4f} exchange + {tr['all_sum']:.4f} "
              f"all_sum; set-up "
              f"{rep['stencil_setup_s']:.2f} s; stencil_sweep launches "
              f"{rep['stencil_launches']} by flags {rep['stencil_flags']}")
        require(rep["stencil_iters"] == iters1,
                f"rank {r}: {rep['stencil_iters']} iterations vs {iters1}")
        require(gap <= PROC_U_GAP, f"rank {r}: stencil u gap {gap}")
        mine = ("10", "00") if r == 0 else ("00", "01")
        for flags in mine:
            require(rep["stencil_flags"].get(flags, 0) >= iters1,
                    f"rank {r}: flags {flags} launched "
                    f"{rep['stencil_flags'].get(flags, 0)} < {iters1}")
        for ndev, ring in SHARD_GENERAL:
            u_ref, it_ref, ms_ref = refs["general", ndev]
            got = rep[f"general{ndev}"]
            gap = _max_gap(out[f"general{ndev}_u"], u_ref)
            tr = got["transport_ms_per_it"]
            print(f"[{card}] rank {r}: sharded general x{ndev} "
                  f"({'ring' if ring else 'all-gather'}) float64 over 2 "
                  f"processes {got['iters']} iterations (one process "
                  f"{it_ref}), gap {gap:.3e}; ms per iteration with the "
                  f"transport clocked {got['ms_per_it']:.4f} (one process, "
                  f"unclocked, {ms_ref:.4f}), of which "
                  f"{tr['exchange']:.4f} exchange + {tr['all_sum']:.4f} "
                  f"all_sum")
            require(got["iters"] == it_ref and gap <= PROC_GENERAL_GAP,
                    f"rank {r}: general x{ndev} {got['iters']} iterations "
                    f"vs {it_ref}, gap {gap}")

        b = refs["hmc"]
        h = rep["hmc"]
        diff = np.abs(out["hmc_samples"] - b.samples)
        gap = float(np.max(diff / (PROC_ATOL + PROC_RTOL
                                   * np.abs(b.samples))))
        same = float(np.abs(out["hmc_samples"] - one.samples).max())
        per_chain = {k: (h["solve_stats"][k], one.solve_stats[k],
                         b.solve_stats[k])
                     for k in b.solve_stats
                     if k.split("_", 1)[1] in ("solves", "iters",
                                               "unconverged")}
        print(f"[{card}] rank {r}: placed HMC float64 on {PROC_ROWS} x 1 "
              f"over 2 processes ({CHAINS // PROC_ROWS} chains per rank): "
              f"{h['seconds']:.2f} s, {h['grad_evals']} gradients; max "
              f"|a - b| vs one process's {PROC_ROWS} x 1 run {same:.3e}, vs "
              f"the unplaced run {float(diff.max()):.3e} ({gap:.3e} of the "
              f"tolerance); per-chain counts summed over the ranks / one "
              f"process {PROC_ROWS} x 1 / unplaced {per_chain}; "
              f"theta_sweep_batched {h['theta_sweep_batched']} for "
              f"{h['local_loop_iters']} batched loop iterations of this rank")
        require(same == 0.0 and h["grad_evals"] == one.grad_evals,
                f"rank {r}: placed HMC off one process's: {same}")
        require(gap <= 1.0, f"rank {r}: placed HMC off the unplaced run")
        # Equal to one process's run of the same shape; against the
        # unplaced run's batch of 16 a chain's CG may stop an iteration
        # apart (its dots round in another order), but never solve or
        # fail to converge apart.
        require(all(a == o and (a == c or "iters" in k)
                    for k, (a, o, c) in per_chain.items()),
                f"rank {r}: summed solve counts {per_chain}")
        require(h["theta_sweep_batched"] >= h["local_loop_iters"] > 0,
                f"rank {r}: {h['theta_sweep_batched']} batched launches < "
                f"{h['local_loop_iters']} loop iterations")

        _, (v_one, g_one) = refs["forward"]
        gap_v = float(np.max(np.abs(out["forward_value"] - v_one)
                             / np.abs(v_one)))
        gap_g = _max_gap(out["forward_grad"], g_one)
        fw = rep["forward"]
        print(f"[{card}] rank {r}: sharded forward {SHARD_MESH[0]} x "
              f"{SHARD_MESH[1]} over 2 processes, one float32 {CHAINS}-chain "
              f"gradient {fw['seconds']:.3f} s (set-up included); gap to one "
              f"process: value {gap_v:.3e}, gradient {gap_g:.3e}; "
              f"theta_sweep_batched {fw['theta_sweep_batched']}")
        require(np.isfinite(out["forward_grad"]).all()
                and gap_v <= SHARD_FWD_RTOL and gap_g <= SHARD_FWD_RTOL,
                f"rank {r}: sharded forward off one process: {gap_v}, "
                f"{gap_g}")
    print(f"[{card}] phase 23: {workers_s:.2f} s for both workers (start, "
          f"build and runs), {time.perf_counter() - t_phase:.2f} s in all")
    return (sum(rep["stencil_launches"] for rep in reports),
            one_batched + sum(rep["hmc"]["theta_sweep_batched"]
                              + rep["forward"]["theta_sweep_batched"]
                              for rep in reports))


def cli_sharding(card) -> None:
    """`cli calibrate` with `[sharding] chains = 2` on an STdb of the 32^3
    beam: with one visible card it must exit with code 2 and the ERROR line
    (never repeat cuda:0); with two or more it runs and records the mesh."""
    import io
    import tempfile

    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.io import stdb
    from stan_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/beam{G}.STdb"
        stdb.write(meshgen.hex_beam(G, G, G), path)
        with open(f"{tmp}/run.toml", "w") as f:
            f.write("[sharding]\nchains = 2\n")
        argv = ["calibrate", path, "--synthetic", "--sampler", "hmc",
                "--chains", str(CHAINS), "--warmup", "1", "--samples", "4",
                "--config", f"{tmp}/run.toml", "--device", "cuda",
                "--log-json", f"{tmp}/runs.jsonl"]
        print(f"[{card}] python -m stan_tpu_torch.cli {' '.join(argv)}")
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = cli.main(argv)
        print(text.getvalue())
        print(f"[{card}] cli calibrate [sharding] chains = 2: exit code {rc}, "
              f"{time.perf_counter() - t0:.2f} s")
        if torch.cuda.device_count() < 2:
            require(rc == 2 and "ERROR: [sharding]" in text.getvalue(),
                    "cli calibrate did not refuse a 2-card mesh on one card")
        else:
            with open(f"{tmp}/runs.jsonl") as f:
                rec = json.loads(f.read().splitlines()[0])
            require(rc == 0 and "chains=2" in (rec["mesh"] or ""),
                    f"cli calibrate on a 2 x 1 mesh: exit code {rc}, "
                    f"mesh {rec['mesh']}")


def cli_general(card) -> None:
    """`cli solve --type Nonlinear_Statics --increments 2` on an STdb of the
    G^3 beam, `cli solve --solver Cholesky` on a small one, and `cli
    calibrate --sampler hmc` (short) on the two-material G^3 beam."""
    import tempfile

    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.io import stdb
    from stan_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for name, model, argv in (
                ("beam", meshgen.hex_beam(G, G, G),
                 ["--type", "Nonlinear_Statics", "--increments", "2"]),
                ("small", meshgen.hex_beam(12, 6, 6),
                 ["--solver", "Cholesky"]),
                ("two", two_material_beam(G), None)):
            path = f"{tmp}/{name}.STdb"
            stdb.write(model, path)
            runs.append(["solve", path, *argv] if argv else
                        ["calibrate", path, "--synthetic", "--sampler", "hmc",
                         "--chains", str(CHAINS), "--warmup", "2",
                         "--samples", "4"])
        for argv in runs:
            argv = [*argv, "--device", "cuda"]
            print(f"[{card}] python -m stan_tpu_torch.cli {' '.join(argv)}")
            t0 = time.perf_counter()
            rc = cli.main(argv)
            print(f"[{card}] cli {argv[0]}: exit code {rc}, "
                  f"{time.perf_counter() - t0:.2f} s")
            require(rc == 0, f"cli {' '.join(argv[:1] + argv[2:])}: exit "
                             f"code {rc}")


def cli_calibration(card) -> None:
    """The calibrate command on an STdb of the 32^3 beam, at the CLI's
    default tolerance and (shorter: 1 warmup transition, 4 draws, the
    fewest its split R-hat takes) at 1e-8; it prints its own counts of
    unconverged solves."""
    import tempfile

    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.io import stdb
    from stan_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/beam{G}.STdb"
        stdb.write(meshgen.hex_beam(G, G, G), path)
        for extra, n_warmup, n_samples in (([], N_WARMUP, N_SAMPLES),
                                           (["--cg-tol", "1e-8"], 1, 4)):
            argv = ["calibrate", path, "--synthetic", "--sampler", "hmc",
                    "--chains", str(CHAINS), "--warmup", str(n_warmup),
                    "--samples", str(n_samples), "--device", "cuda", *extra]
            print(f"[{card}] python -m stan_tpu_torch.cli {' '.join(argv)}")
            t0 = time.perf_counter()
            rc = cli.main(argv)
            print(f"[{card}] cli calibrate: exit code {rc}, "
                  f"{time.perf_counter() - t0:.2f} s")
            require(rc == 0, f"cli calibrate {extra}: exit code {rc}")


def cli_nuts_export(card) -> None:
    """`cli calibrate --sampler nuts` (short), then `cli solve` and `cli
    export` on an STdb of the 32^3 beam."""
    import os
    import tempfile

    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.io import stdb
    from stan_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/beam{G}.STdb"
        stdb.write(meshgen.hex_beam(G, G, G), path)
        for argv in (["calibrate", path, "--synthetic", "--sampler", "nuts",
                      "--chains", str(CHAINS), "--warmup", "2", "--samples",
                      "4"],
                     ["solve", path],
                     ["export", path, f"{tmp}/beam{G}"]):
            argv = [*argv, "--device", "cuda"]
            print(f"[{card}] python -m stan_tpu_torch.cli {' '.join(argv)}")
            t0 = time.perf_counter()
            rc = cli.main(argv)
            print(f"[{card}] cli {argv[0]}: exit code {rc}, "
                  f"{time.perf_counter() - t0:.2f} s")
            require(rc == 0, f"cli {argv[0]}: exit code {rc}")
        vtus = [f for f in os.listdir(tmp) if f.endswith(".vtu")]
        require(len(vtus) == 2, f"cli export wrote {vtus}")


def cli_read_database(card) -> None:
    """`cli solve` on an STdb of the 70^3 beam: its "Read database" phase
    (stdb.read, the native fast decode) and "Write database" seconds, from
    the run record of --log-json; then the solved STdb (with results) read
    back by stdb.read and by from_proto, each timed, required equal."""
    import os
    import tempfile

    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.io import stdb
    from stan_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        path, log = f"{tmp}/beam{N}.STdb", f"{tmp}/runs.jsonl"
        stdb.write(meshgen.hex_beam(N, N, N), path)
        argv = ["solve", path, "--device", "cuda", "--log-json", log]
        print(f"[{card}] python -m stan_tpu_torch.cli {' '.join(argv)}")
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall_s = time.perf_counter() - t0
        with open(log) as f:
            phases = {r["phase"]: r["seconds"]
                      for r in json.loads(f.readline())["phases"]}
        print(f"[{card}] cli solve {N}^3: exit code {rc}, {wall_s:.2f} s; "
              f"Read database {phases['Read database']:.3f} s, Write "
              f"database {phases['Write database']:.3f} s")
        require(rc == 0, f"cli solve {N}^3: exit code {rc}")
        t0 = time.perf_counter()
        fast = stdb.read(path)
        fast_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            slow = stdb.from_proto(stdb.pb.Database.FromString(f.read()))
        slow_s = time.perf_counter() - t0
        print(f"[{card}] solved {N}^3 STdb ({os.path.getsize(path)} bytes, "
              f"results stored): stdb.read {fast_s:.3f} s, from_proto "
              f"{slow_s:.3f} s")
    gaps = model_gaps(fast, slow)
    require(not gaps, f"solved STdb: stdb.read and from_proto differ in {gaps}")
    require(fast.disp is not None, "the solved STdb holds no displacements")


def device() -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def general_apply_phase(card, flush) -> dict:
    """The general operator's kernels (csrc/general_apply.cu) at LE10's
    shapes (perfbench/plate.py's 144 x 96 x 24 HEX8 plate, 331,776
    elements, 351,625 nodes): each dtype against the plain version (and
    two applies to the bit), then timed as the sweeps are (ms around
    wrapper calls, ms_graph from graph replays, ms_cold with the L2
    flushed), the plain version, the bound of perfbench/rooflines/
    general_apply.py and the two kernels' device split under
    torch.profiler. Then each dtype against the plain version at the
    general forward's shape in phase 16: CHAINS systems on the G^3 beam,
    one D per chain expanded over the elements. Returns {dtype: facts};
    max_abs_err is the larger of the two shapes'. The registers and
    spills are in phase 2's build log."""
    from perfbench import plate
    from perfbench.rooflines import general_apply as roof
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.fem import elements
    from stan_tpu_torch.fem.operator import build_operator
    from stan_tpu_torch.infer.forward import (d_matrix_from_lame,
                                              lame_from_E_nu)

    cfg = json.loads(pathlib.Path("perfbench/configs/le10.json").read_text())
    p = plate.quarter_plate(*cfg["grid"], inner=cfg["inner_semi_axes"],
                            outer=cfg["outer_semi_axes"],
                            thickness=cfg["thickness"])
    lam, mu = (cfg["E"] * cfg["nu"] / ((1 + cfg["nu"]) * (1 - 2 * cfg["nu"])),
               cfg["E"] / (2 * (1 + cfg["nu"])))
    D = d_matrix_from_lame(torch.full((p.nelem,), lam, dtype=torch.float64),
                           torch.full((p.nelem,), mu, dtype=torch.float64))
    facts = {}
    rng = np.random.default_rng(SEED)
    for dtype in (torch.float32, torch.float64):
        op = build_operator(p.coords, p.conn, D.numpy(), p.fixed,
                            elements.get(cfg["elem_type"]), dtype=dtype,
                            device="cuda")
        u = torch.as_tensor(rng.standard_normal((p.nnode, 3)), dtype=dtype,
                            device="cuda")
        got, again = op.apply(u), op.apply(u)
        ref = op.apply_reference(u)
        torch.cuda.synchronize()
        gap = float((got - ref).abs().max()) / float(ref.abs().max())
        require(gap <= SWEEP_RTOL[dtype],
                f"general_apply {dtype}: relative gap {gap} to the plain "
                "version")
        require(torch.equal(got, again), "general_apply: two applies differ")
        err = float((got - ref).abs().max())
        kern = lambda: op.apply(u)  # noqa: E731
        plain = lambda: op.apply_reference(u)  # noqa: E731
        p1, k1, k2, p2 = (time_ms(plain, 5), time_ms(kern, 50),
                          time_ms(kern, 50), time_ms(plain, 5))
        g1, g2 = time_graph_ms(kern), time_graph_ms(kern)
        cold = time_cold_ms(kern, flush)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                kern()
            torch.cuda.synchronize()
        split = {}
        for ev in prof.key_averages():
            for part in ("general_element_kernel", "general_node_kernel"):
                if part in ev.key:
                    split[part] = getattr(ev, "device_time_total",
                                          getattr(ev, "cuda_time_total",
                                                  0.0)) / 20 / 1e3
        size = u.element_size()
        nbytes, flops = roof.counts(p.nelem, p.nnode, 8, size)
        bound_ms = roof.bound_s(p.nelem, p.nnode, 8, size) * 1e3
        ms_graph = (g1 + g2) / 2
        facts[dtype] = {"ms": (k1 + k2) / 2, "ms_graph": ms_graph,
                        "ms_cold": cold, "plain_ms": (p1 + p2) / 2,
                        "bound_ms": bound_ms,
                        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                                     >= flops / PEAK_FLOPS[dtype]
                                     else "operations"),
                        "share": bound_ms / ms_graph, "rel_gap": gap,
                        "max_abs_err": err, "profiler_ms": split}
        print(f"[{card}] general_apply LE10 [{p.nelem} HEX8_G2, {p.nnode} "
              f"nodes] {str(dtype)[6:]}: kernels {k1 * 1e3:.1f} / "
              f"{k2 * 1e3:.1f} µs warm (events around wrapper calls), "
              f"{g1 * 1e3:.1f} / {g2 * 1e3:.1f} µs (CUDA graph), "
              f"{cold * 1e3:.1f} µs cold L2; device split {split} ms; plain "
              f"{p1:.3f} / {p2:.3f} ms; bound {bound_ms * 1e3:.2f} µs "
              f"({facts[dtype]['bound_by']}), share of the CUDA-graph time "
              f"{bound_ms / ms_graph:.2%}; relative gap to plain {gap:.1e}")
        del op, got, again, ref
    cal = meshgen.hex_beam(G, G, G)
    lam, mu = lame_from_E_nu(
        np.exp(THETA_TRUE[0] + 0.1 * rng.standard_normal(CHAINS)),
        0.28 + 0.05 * rng.standard_normal(CHAINS))
    for dtype in (torch.float32, torch.float64):
        op = build_operator(cal.coords, cal.conn, cal.elem_d_matrices(),
                            cal.fix_mask(), cal.formulation(), dtype=dtype,
                            device="cuda")
        D = d_matrix_from_lame(torch.as_tensor(lam, dtype=dtype),
                               torch.as_tensor(mu, dtype=dtype)).cuda()
        op = op.with_D(D[:, None].expand(CHAINS, cal.nelem, 6, 6))
        u = torch.as_tensor(rng.standard_normal((CHAINS, cal.nnode, 3)),
                            dtype=dtype, device="cuda")
        got, ref = op.apply(u), op.apply_reference(u)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        gap = err / float(ref.abs().max())
        print(f"[{card}] general_apply at the general forward's shape "
              f"[{CHAINS}, {cal.nnode}, 3], D [{CHAINS}, {cal.nelem}, 6, 6] "
              f"expanded over the elements, {str(dtype)[6:]}: max abs "
              f"error {err:.3e}, relative gap to plain {gap:.1e}")
        require(gap <= SWEEP_RTOL[dtype],
                f"general_apply {dtype} at [{CHAINS}, {cal.nnode}, 3]: "
                f"relative gap {gap} to the plain version")
        facts[dtype]["max_abs_err"] = max(facts[dtype]["max_abs_err"], err)
        del op, got, ref
    return facts


def print_kernels(errs, theta_errs, batched_errs, facts, launches) -> None:
    """The kernels line: each kernel's facts, with the main paths' launch
    counts (one for each of KERNELS), or null for each where no main path
    ran. errs etc. are lists of compare_* results: the first at the
    single-device path's shape, whose float32 (1,1) error counts, then any
    at the sharded paths' slab shapes, whose float32 errors count under
    every flag pair. The general apply's facts (general_apply_phase) hold
    their own max_abs_err."""
    def max_err(main, *slabs):
        return max([main[(torch.float32, (1, 1))],
                    *(e for slab in slabs for (dtype, _), e in slab.items()
                      if dtype == torch.float32)])

    rows = (
        ("stencil_sweep", "stan_tpu_torch/csrc/stencil_sweep.cu",
         "stan_tpu/fem/stencil.py:218", max_err(*errs)),
        ("theta_sweep", "stan_tpu_torch/csrc/theta_sweep.cu",
         "stan_tpu/fem/stencil.py:570", max_err(*theta_errs)),
        ("theta_sweep_batched", "stan_tpu_torch/csrc/theta_sweep.cu",
         "stan_tpu/fem/stencil.py:610", max_err(*batched_errs)),
        ("general_apply", "stan_tpu_torch/csrc/general_apply.cu", None,
         facts[("general_apply", torch.float32)]["max_abs_err"]),
    )
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": None if launches is None else launches[i],
        "max_abs_err": err,
        **facts[(name, torch.float32)],
    } for i, (name, source, replaces, err) in enumerate(rows)]}))


def main() -> int:
    import argparse

    if sys.argv[1:2] == ["--process-worker"]:  # phase 23's workers
        if not torch.cuda.is_available():
            return 1
        rank, folder, backend = sys.argv[2:5]
        with plain_sweeps_refused():
            process_worker(int(rank), folder, backend)
        return 0
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile the 70^3 CG loop and one "
                             "calibration gradient")
    parser.add_argument("--cli", action="store_true",
                        help="run the calibrate command on the 32^3 beam")
    parser.add_argument("--kernels", action="store_true",
                        help="phases 1-5 only: build, check and time the "
                             "kernels; no main path, no ok line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch import _build
    from stan_tpu_torch.analysis.linear import solve_linear_statics
    from stan_tpu_torch.fem import stencil, structured
    from stan_tpu_torch.infer import calibrate, forward, hmc
    from stan_tpu_torch.solvers import cg
    from stan_tpu_torch.utils.timing import PhaseTimer

    card = card_line()
    print(card)
    print(f"[{card}] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build()
    for name in libs:
        _build.library(name)
    print(f"[{card}] kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(p.name for p in libs.values())})")
    for path in libs.values():
        print(path.with_suffix(".log").read_text().strip())
    t0 = time.perf_counter()
    _build.host_library("stanfem")  # raises with the compiler's output
    print(f"[{card}] host runtime build + load (csrc/stanfem.cpp, c++ "
          f"{' '.join(_build.HOST_FLAGS)}): {time.perf_counter() - t0:.2f} s")

    # -- kernels vs plain versions ----------------------------------------
    rng = np.random.default_rng(SEED)
    model = meshgen.hex_beam(N, N, N)
    op32 = stencil.build_stencil_operator(model, dtype=torch.float32,
                                          device="cuda")
    require(op32 is not None, "70^3 beam refused by the stencil operator")
    errs = compare_sweeps(op32.tables, op32.node_shape, rng,
                          f"{N}^3", card)
    small = meshgen.hex_beam(5, 4, 3, lx=6.0, ly=1.5, lz=3.0)
    op_small = stencil.build_stencil_operator(small, dtype=torch.float64,
                                              device="cuda")
    compare_sweeps(op_small.tables, op_small.node_shape, rng,
                   "5x4x3 (lx=6, ly=1.5, lz=3)", card)
    # The shapes that stress the tiles (as for theta_sweep below): the 32^3
    # grid (35 y and z nodes, which no tile width divides), one x-plane of
    # it (every plane a face) and z over two tiles (141 nodes).
    op_cal = stencil.build_stencil_operator(meshgen.hex_beam(G, G, G),
                                            dtype=torch.float64,
                                            device="cuda")
    compare_sweeps(op_cal.tables, op_cal.node_shape, rng, f"{G}^3", card)
    compare_sweeps(op_cal.tables, (1, *op_cal.node_shape[1:]), rng,
                   f"{G}^3 SX=1", card)
    op_long = stencil.build_stencil_operator(
        meshgen.hex_beam(6, 9, 140, lx=6.0, ly=9.0, lz=140.0),
        dtype=torch.float64, device="cuda")
    compare_sweeps(op_long.tables, op_long.node_shape, rng, "6x9x140", card)
    # The sharded stencil's slab (phases 18-19): one of SHARD_DOMAIN x-slabs
    # of the 72-plane beam, [3, 20, 73, 73] with its ghosts.
    op_shard = stencil.build_stencil_operator(
        meshgen.hex_beam(*SHARD_BEAM), dtype=torch.float64, device="cuda")
    slab_shape = (op_shard.node_shape[0] // SHARD_DOMAIN,
                  *op_shard.node_shape[1:])
    shard_errs = compare_sweeps(op_shard.tables, slab_shape, rng,
                                f"slab {list(slab_shape)}", card)
    del op_shard

    lam_true, mu_true = forward.lame_from_E_nu(np.exp(THETA_TRUE[0]),
                                               THETA_TRUE[1])
    pairs = np.array([[lam_true, mu_true], [1.3e5, 6.1e4]])
    compare_theta(model, pairs, rng, f"{N}^3", card, False)
    cal_model = meshgen.hex_beam(G, G, G)
    # The calibration path runs theta_sweep on the 32^3 grid (B = 1): the
    # kernels line reports this check.
    theta_errs = compare_theta(cal_model, pairs, rng, f"{G}^3", card, False)
    compare_theta(small, pairs, rng, "5x4x3", card, False)
    chain_pairs = np.stack(forward.lame_from_E_nu(
        np.exp(THETA_TRUE[0] + 0.1 * rng.standard_normal(CHAINS)),
        0.28 + 0.05 * rng.standard_normal(CHAINS)), axis=1)
    batched_errs = compare_theta(cal_model, chain_pairs, rng,
                                 f"[{CHAINS},3,{G + 3},{G + 3},{G + 3}]",
                                 card, True)
    compare_theta(small, chain_pairs[:3], rng, "5x4x3", card, True)
    # The placed chains' per-row batches (phase 22): 16 chains over 4 rows
    # and 32 SMC particles over 4 rows, whole grids (flags (1,1)).
    row_batched_errs = [
        compare_theta(cal_model, chain_pairs[:b], rng,
                      f"row [{b},3,{G + 3},{G + 3},{G + 3}]", card, True,
                      flags=((1, 1),))
        for b in (CHAINS // PLACE_ROWS, SMC_PARTICLES // PLACE_ROWS)]
    # Shapes that stress the kernel's tiling: one x-plane (every plane a
    # face), y and z extents that no tile width divides, z over two tiles.
    compare_theta(cal_model, chain_pairs, rng, f"[{CHAINS},3,3,35,35] SX=1",
                  card, True, sx=1)
    compare_theta(small, pairs, rng, "5x4x3 SX=1", card, False, sx=1)
    long_z = meshgen.hex_beam(6, 9, 140, lx=6.0, ly=9.0, lz=140.0)
    compare_theta(long_z, chain_pairs[:3], rng, "[3,3,9,12,143]", card, True)
    compare_theta(long_z, pairs[:1], rng, "[3,9,12,143]", card, False)
    # The sharded forward's slab (phase 21): one chain row's chains on one
    # of the domain axis's x-slabs of the 32^3 grid.
    row_chains, slab_sx = CHAINS // SHARD_MESH[0], (G + 1) // SHARD_MESH[1]
    shard_batched_errs = compare_theta(
        cal_model, chain_pairs[:row_chains], rng,
        f"slab [{row_chains},3,{slab_sx + 2},{G + 3},{G + 3}]", card, True,
        sx=slab_sx)

    # -- time, bound and library call at the main paths' shapes -----------
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    facts = {}
    tl70, tm70, shape70 = unit_tables(model)
    tl32, tm32, shape32 = unit_tables(cal_model)
    n70, n32 = 3 * int(np.prod(shape70)), 3 * int(np.prod(shape32))
    for dtype in (torch.float32, torch.float64):
        # Zero ghosts, as the main paths pad, so that one product with the
        # assembled K computes the same function.
        u70 = torch.as_tensor(rng.standard_normal((3, *shape70)),
                              dtype=dtype, device="cuda")
        up70 = pad(u70)
        table = stencil.pack_tables(op32.tables, dtype, "cuda")
        K = assemble_csr([lambda u: stencil.stencil_sweep_reference(
            pad(u), table, 1, 1)], shape70, dtype)
        vec = u70.reshape(n70, 1)
        facts[("stencil_sweep", dtype)] = measure(
            "stencil_sweep", up70,
            lambda: stencil.stencil_sweep(up70, table, 1, 1),
            lambda: stencil.stencil_sweep_reference(up70, table, 1, 1),
            lambda: torch.sparse.mm(K, vec), lambda r: r.reshape(3, *shape70),
            table.numel() * table.element_size(), flush, card)
        del K

        # theta_sweep at the 32^3 grid, where the calibration path runs it,
        # and at the 70^3 grid, the shape earlier runs timed it at.
        for key, (tl, tm, shape) in ((("theta_sweep", dtype),
                                      (tl32, tm32, shape32)),
                                     (("theta_sweep 70^3", dtype),
                                      (tl70, tm70, shape70))):
            t2 = stencil.pack_theta_tables(tl, tm, dtype, "cuda")
            coef = torch.as_tensor(pairs[0], dtype=dtype, device="cuda")
            u = torch.as_tensor(rng.standard_normal((3, *shape)),
                                dtype=dtype, device="cuda")
            up = pad(u)
            K = assemble_csr([theta_unit(t2, 0), theta_unit(t2, 1)], shape,
                             dtype)
            v = u.reshape(-1, 1)
            V = torch.cat([coef[0] * v, coef[1] * v])
            facts[key] = measure(
                "theta_sweep", up,
                lambda: stencil.theta_sweep(up, t2, coef, 1, 1),
                lambda: stencil.theta_sweep_reference(up[None], t2,
                                                      coef[None], 1, 1),
                lambda: torch.sparse.mm(K, V),
                lambda r: r.reshape(3, *shape),
                (t2.numel() + coef.numel()) * t2.element_size(), flush, card)
            del K, V

        # theta_sweep_batched at the 16 chains of the calibration path, and
        # at the per-row batches of phase 22 (16 chains and 32 particles
        # over 4 rows), which only print.
        t2 = stencil.pack_theta_tables(tl32, tm32, dtype, "cuda")
        K = assemble_csr([theta_unit(t2, 0), theta_unit(t2, 1)], shape32,
                         dtype)
        for B in (CHAINS, CHAINS // PLACE_ROWS, SMC_PARTICLES // PLACE_ROWS):
            coef_b = torch.as_tensor(chain_pairs[:B], dtype=dtype,
                                     device="cuda")
            u_b = torch.as_tensor(rng.standard_normal((B, 3, *shape32)),
                                  dtype=dtype, device="cuda")
            up_b = pad(u_b)
            flat = u_b.reshape(B, n32).T
            V = torch.cat([coef_b[:, 0] * flat,
                           coef_b[:, 1] * flat]).contiguous()
            key = "theta_sweep_batched" + ("" if B == CHAINS else f" B={B}")
            facts[(key, dtype)] = measure(
                "theta_sweep_batched", up_b,
                lambda: stencil.theta_sweep_batched(up_b, t2, coef_b, 1, 1),
                lambda: stencil.theta_sweep_reference(up_b, t2, coef_b, 1, 1),
                lambda: torch.sparse.mm(K, V),
                lambda r: r.T.reshape(B, 3, *shape32),
                (t2.numel() + coef_b.numel()) * t2.element_size(), flush,
                card)
            del V
        del K
    general_facts = general_apply_phase(card, flush)
    facts[("general_apply", torch.float32)] = general_facts[torch.float32]
    print(json.dumps({"general_apply": {
        "source": "stan_tpu_torch/csrc/general_apply.cu",
        "replaces": None, **{str(k)[6:]: v for k, v in
                             general_facts.items()}}}))
    del flush
    if args.kernels:
        print_kernels([errs, shard_errs], [theta_errs],
                      [batched_errs, shard_batched_errs, *row_batched_errs],
                      facts, None)
        print(json.dumps({"partial": "kernels only (phases 1-5): no main "
                          "path ran", "device": device()}))
        return 0

    # -- the linear main path ---------------------------------------------
    model = meshgen.hex_beam(N, N, N)
    timer = PhaseTimer(verbose=False)
    by_dtype = collections.Counter()
    reset_launches()
    t0 = time.perf_counter()
    with sweeps_by_dtype(by_dtype):
        res = solve_linear_statics(model, device="cuda", timer=timer)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = launched("stencil_sweep")
    print(f"[{card}] solve {model.ndof} DOF: operator {res.operator}, "
          f"{res.iters} CG iterations, converged {res.converged}, "
          f"residual {res.residual:.3e}, certified f64 residual "
          f"{res.true_residual}, {res.refine_cycles} refinement cycles, "
          f"{res.refine_iters} refinement iterations, {launches} kernel "
          f"launches, {solve_s:.3f} s")
    for r in timer.records:
        extra = {k: v for k, v in r.items() if k not in ("phase", "seconds")}
        print(f"[{card}] phase {r['phase']}: {r['seconds']:.4f} s {extra}")
        if r["phase"].startswith("Linear solve"):
            print(f"[{card}] CG iterations/s (base solve phase): "
                  f"{res.iters / r['seconds']:.1f}")
    require(res.operator == "stencil", f"operator {res.operator}")
    require(res.converged, "solve did not converge")
    require(res.true_residual is not None and res.true_residual <= 1e-6,
            f"certified residual {res.true_residual}")
    require(launches >= res.iters,
            f"{launches} kernel launches < {res.iters} CG iterations")
    # The certification reads its float64 residual on the host: no float64
    # sweep runs in the solve, a float32 one in each CG iteration (most in
    # the CG's replayed CUDA graph, which the launch counter sees and the
    # wrapper does not).
    f64 = by_dtype[torch.float64]
    f32 = launches - f64
    cert = next(r for r in timer.records
                if r["phase"] == "Certify (f64 refinement)")
    print(f"[{card}] certification split: " + json.dumps({
        "seconds": cert["seconds"], "host_twin_setup_s": cert["twin_s"],
        "host_sweeps_s": cert["sweep_s"], "inner_cg_s": cert["inner_s"],
        "copies_s": cert["copy_s"], "cycles": res.refine_cycles,
        "inner_iters": res.refine_iters,
        "stencil_sweep_f32_launches": f32,
        "stencil_sweep_f64_launches": f64}))
    require(f64 == 0, f"{f64} float64 stencil_sweep launches in the solve")
    require(f32 >= res.iters + res.refine_iters,
            f"{f32} float32 launches < {res.iters} + {res.refine_iters} "
            f"iterations")
    require(res.u.shape == (model.nnode, 3) and np.isfinite(res.u).all(),
            "displacements not finite or misshapen")
    require(res.stress.shape == (model.nelem, 8, 6)
            and np.isfinite(res.stress).all()
            and np.isfinite(res.strain).all(), "stress/strain not finite")
    lin_u = res.u

    # -- independent check: float64 structured operator, no kernel --------
    sop64 = structured.build_structured_operator(
        model, dtype=torch.float64, device="cuda")
    loads = model.load_vector()
    b = sop64.free_mask * sop64.to_grid(
        torch.as_tensor(loads, dtype=torch.float64, device="cuda"))
    for name, u in (("certified float64 u", res.u_certified),
                    ("float32 u", res.u)):
        ug = sop64.to_grid(torch.as_tensor(u, dtype=torch.float64,
                                           device="cuda"))
        rel = float(torch.linalg.vector_norm(b - sop64.apply(ug))
                    / torch.linalg.vector_norm(b))
        print(f"[{card}] structured-operator f64 relative residual of the "
              f"{name}: {rel:.3e}")
        if u is res.u_certified:
            require(rel <= 1e-6, f"independent f64 residual {rel}")
    fix = model.fix_mask()
    supports = res.reactions.astype(np.float64).reshape(-1)[fix.reshape(-1)]
    gap = np.abs(supports.reshape(-1, 3).sum(axis=0) + loads.sum(axis=0))
    total = float(np.linalg.norm(loads.sum(axis=0)))
    print(f"[{card}] reactions + loads at the supports: {gap.tolist()} "
          f"(total load {total})")
    require(float(gap.max()) <= 1e-3 * total, f"reaction gap {gap}")

    # -- the per-iteration host sync of the CG loop, in turns -------------
    rhs = (op32.free_mask * op32.to_grid(torch.as_tensor(
        loads, dtype=torch.float32, device="cuda"))).contiguous()
    diag = op32.diagonal()
    with_sync = lambda: cg.pcg(op32.apply, rhs, diag=diag, tol=0.0,  # noqa
                               maxiter=SYNC_ITERS)
    no_sync = lambda: cg_without_sync(op32.apply, rhs, diag,  # noqa: E731
                                      SYNC_ITERS)
    with_sync()
    s1, n1, n2, s2 = wall(with_sync), wall(no_sync), wall(no_sync), \
        wall(with_sync)
    per_s = (s1 + s2) / 2 / SYNC_ITERS * 1e3
    per_n = (n1 + n2) / 2 / SYNC_ITERS * 1e3
    print(f"[{card}] CG iteration, float32 stencil, {SYNC_ITERS} iterations: "
          f"{per_s:.4f} ms with the per-iteration sync, {per_n:.4f} ms "
          f"without; sync cost {per_s - per_n:.4f} ms/iteration")
    if args.profile:
        profile_cg(op32.apply, rhs, diag, f"the {N}^3 stencil operator",
                   card)

    # -- the certified solve, and phase 6's answer by the host twin -------
    with plain_sweeps_refused():
        launches += certified_phase(model, res, timer, op32, card)

    # -- the host runtime against the Python bodies -----------------------
    host_runtime_phase(lambda: wall(with_sync) / SYNC_ITERS * 1e3,
                       [s1 / SYNC_ITERS * 1e3, s2 / SYNC_ITERS * 1e3], card)

    # -- the calibration main path ----------------------------------------
    cal_model = meshgen.hex_beam(G, G, G)
    reset_launches()
    t0 = time.perf_counter()
    obs_nodes, obs_dirs, y, sigma, true_stats = calibration_observations(
        cal_model, card)
    prob = calibrate.make_problem(cal_model, obs_nodes, obs_dirs, y, sigma,
                                  device="cuda", cg_tol=1e-6)
    init = np.random.default_rng(7)
    theta0 = torch.as_tensor(
        np.array([np.log(210000.0), 0.0, 0.0])[None]
        + 0.05 * init.normal(size=(CHAINS, 3)), device="cuda")
    out = hmc.run_hmc(prob.log_posterior, theta0, 11, n_samples=N_SAMPLES,
                      n_warmup=N_WARMUP, n_leapfrog=N_LEAPFROG,
                      init_step=0.02, solve_stats=prob.fwd.stats)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    theta_launches = launched("theta_sweep")
    batched_launches = launched("theta_sweep_batched")
    st = out.solve_stats
    run_s = out.warmup_seconds + sum(out.chunk_seconds)
    sps = CHAINS * sum(out.chunk_sizes) / sum(out.chunk_seconds)
    loop_iters = st["forward_loop_iters"] + st["adjoint_loop_iters"]
    print(f"[{card}] calibration {G}^3 ({3 * cal_model.nnode} DOF, "
          f"{len(y)} observations), {CHAINS} chains, {N_LEAPFROG} leapfrog "
          f"steps, {N_WARMUP} warmup + {N_SAMPLES} samples: {cal_s:.2f} s "
          f"in all, warmup {out.warmup_seconds:.2f} s, sampling "
          f"{sum(out.chunk_seconds):.2f} s")
    print(f"[{card}] samples/s (sampling phase, all chains): {sps:.3f}; "
          f"acceptance {float(np.mean(out.accept_rate)):.3f} "
          f"(per chain {np.round(out.accept_rate, 3).tolist()}); step size "
          f"{float(np.mean(out.step_size)):.4g}")
    print(f"[{card}] gradient evaluations (all {CHAINS} chains each): "
          f"{out.grad_evals}, {run_s / out.grad_evals:.4f} s each (HMC run "
          f"time / evaluations)")
    print(f"[{card}] CG iterations per forward solve "
          f"{st['forward_iters'] / st['forward_solves']:.1f}, per adjoint "
          f"solve {st['adjoint_iters'] / st['adjoint_solves']:.1f}; batched "
          f"loop iterations {st['forward_loop_iters']} forward + "
          f"{st['adjoint_loop_iters']} adjoint; unconverged solves: "
          f"{out.unconverged_forward} forward, {out.unconverged_adjoint} "
          f"adjoint (of {st['forward_solves']} each)")
    print(f"[{card}] kernel launches on the calibration path: theta_sweep "
          f"{theta_launches}, theta_sweep_batched {batched_launches}")
    cons = calibrate.CalibrationProblem.constrain(out.samples)
    print(f"[{card}] posterior draws: E mean {cons[..., 0].mean():.6g}, "
          f"nu mean {cons[..., 1].mean():.4f} (truth 190000, 0.28)")
    require(out.samples.shape == (CHAINS, N_SAMPLES, 3)
            and np.isfinite(out.samples).all(), "samples not finite")
    require(float(np.mean(out.accept_rate)) > 0.0, "acceptance rate 0")
    require(batched_launches >= loop_iters,
            f"{batched_launches} batched launches < {loop_iters} iterations "
            f"of the chain-batched CG loops")
    require(true_stats["forward_unconverged"] == 0,
            "the forward solve at θ_true did not converge")
    require(theta_launches >= true_stats["forward_loop_iters"],
            f"{theta_launches} theta_sweep launches < "
            f"{true_stats['forward_loop_iters']} iterations at θ_true")

    fd_gradient_check(cal_model, (obs_nodes, obs_dirs, y, sigma), card)

    # -- fields and export of the 70^3 solve; NUTS, ADVI, SMC at 32^3 -----
    fields_phase(model, card)
    for phase in (nuts_phase, vi_smc_phase):
        if args.profile and phase is vi_smc_phase:
            profile_advi(prob, theta0, card)
        single, batched = phase(prob, theta0, card)
        theta_launches += single
        batched_launches += batched
    if args.profile:
        profile_gradient(prob, card)

    # -- the general path: direct solvers, nonlinear statics, the three
    # forward problems, HMC on a two-material beam ------------------------
    general_launches = direct_phase(card)
    nonlinear_phase(lin_u, card, args.profile)
    more = three_forwards_phase(cal_model, (obs_nodes, obs_dirs, y, sigma),
                                card)
    batched_launches += more[0]
    general_launches += more[1]
    two_material_phase(theta0, card)
    # -- the domain-sharded paths: x-slab stencil apply and CG, the general
    # sharded operator, the chains x domain calibration forward -----------
    obs = (obs_nodes, obs_dirs, y, sigma)
    refs = {}
    with plain_sweeps_refused():
        launches += sharded_stencil_phases(card, args.profile, refs)
        sharded_general_phase(card, refs)
        batched_launches += sharded_calibration_phase(cal_model, obs, theta0,
                                                      card, refs)
        # -- chains placed over a device mesh -----------------------------
        batched_launches += chain_placement_phase(cal_model, obs, theta0,
                                                  card, refs)
        # -- several processes --------------------------------------------
        more, more_batched = processes_phase(card, refs, cal_model, obs,
                                             theta0)
        launches += more
        batched_launches += more_batched
        # -- the port's benchmark and calib_large, small ------------------
        more = bench_phase(card)
        launches += more[0]
        theta_launches += more[1]
        batched_launches += more[2]
        # -- the chains-scaling measurement -------------------------------
        more = chains_scaling_phase(card)
        launches += more[0]
        theta_launches += more[1]
        batched_launches += more[2]
    if args.cli:
        cli_calibration(card)
        cli_nuts_export(card)
        cli_general(card)
        cli_sharding(card)
        cli_read_database(card)

    stray = sorted(m for m in sys.modules if m.split(".")[0] == "stan_tpu")
    require(not stray, f"the port loaded modules of stan_tpu: {stray}")
    print_kernels([errs, shard_errs], [theta_errs],
                  [batched_errs, shard_batched_errs, *row_batched_errs],
                  facts,
                  (launches, theta_launches, batched_launches,
                   general_launches))
    print(json.dumps({"ok": True, "device": device()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
