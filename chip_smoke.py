#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stan_tpu_torch) on one GPU.

Phases, each of which raises on failure:
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build every CUDA kernel from stan_tpu_torch/csrc (one nvcc per source,
     started together), print the build time and the assembler's register
     reports;
  3. stencil_sweep against its plain PyTorch version on the card, on the
     70^3 beam's tables and on a small odd grid, with the x-face flags
     (1,1), (0,1), (1,0), (0,0), in float32 and float64;
  4. theta_sweep (one grid) against its plain version on the same two grids
     and on the 32^3 calibration grid (the shape its main path runs), with
     two coefficient pairs, one of them the 32^3 calibration's (λ, μ) at
     θ_true, and theta_sweep_batched at [16, 3, 35, 35, 35] (16 chains
     of the 32^3 grid, 16 distinct pairs) and on the small odd grid; then
     shapes that stress the kernel's tiling: one x-plane (SX = 1) with 16
     chains and with one, and a 6x9x140 beam (y and z extents no tile
     divides, z over two tiles) with 3 chains and with one; all four flag
     pairs, float32 and float64, random ghosts;
  5. at the main paths' shapes ([3, 73, 73, 73], the 70^3 grid, for
     stencil_sweep; [3, 35, 35, 35], the 32^3 grid, for theta_sweep, and
     [3, 73, 73, 73] beside it; [16, 3, 35, 35, 35] for
     theta_sweep_batched), float32 and float64: each kernel's time with the
     L2 cache warm, by CUDA events around back-to-back wrapper calls in
     turns with its plain version (the kernels line's ms) and from CUDA-graph
     replays (ms_graph), and its time with the L2 flushed before each
     launch (ms_cold); its
     bound (the larger of one pass over its bytes at the HBM rate and its
     multiply-adds at the peak rate, data sheet) and share of it; and the
     time of one library call of the same function, torch.sparse.mm with
     K (or [K_λ | K_μ]) assembled as CSR, checked against the kernel;
  6. the linear main path: solve_linear_statics(hex_beam(70, 70, 70),
     device="cuda") in float32 with float64 certification (1,073,733 DOF):
     operator "stencil", converged, certified residual <= 1e-6, and at
     least one kernel launch per CG iteration;
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
     against central finite differences, at one θ (log E, ν and load).

Two measurements run only when asked for:
  --profile  one 16-chain gradient of the 32^3 posterior near θ_true under
             torch.profiler: wall time, chain-batched CG iterations, ms per
             iteration, device busy share, device time by kernel, launches
             per iteration;
  --cli      `python -m stan_tpu_torch.cli calibrate --synthetic --sampler
             hmc --device cuda` on an STdb of the 32^3 beam (needs
             protobuf), at the CLI's default tolerance and at 1e-8 (a
             short run), printing the CLI's counts of unconverged solves.

Prints a JSON line of kernel facts and, last, one JSON line naming the
device; before those, it checks that no module of stan_tpu was loaded.
Exits non-zero, with no result, when there is no CUDA device.

Run from the repository root: python3 chip_smoke.py [--profile] [--cli]
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

N = 70  # bench.py's beam: 343,000 HEX8 elements, 1,073,733 DOF
G = 32  # bench.py's calibration grid: 35,937 nodes, 107,811 DOF
CHAINS = 16
N_LEAPFROG = 8
N_WARMUP = 10
N_SAMPLES = 5
THETA_TRUE = np.array([np.log(190000.0), 0.28, 0.0])
SEED = 0
# The kernel and the plain version sum the same products in other orders.
SWEEP_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
FLAGS = ((1, 1), (0, 1), (1, 0), (0, 0))
SYNC_ITERS = 200
# tests/test_infer.py:227-236 (test_forward_gradient_finite_difference).
FD_H, FD_REL, FD_ABS = 1e-4, 2e-3, 1e-3
# H100 SXM data sheet: HBM3 rate, and peak rates outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
FLUSH_BYTES = 256 * 2**20  # > the 50 MB L2


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
                  sx=None) -> dict:
    """theta_sweep (coefs [P, 2]: one check per pair) or theta_sweep_batched
    (coefs [B, 2]: one batch) against theta_sweep_reference, on the model's
    grid or, with sx, on a slab of sx x-planes of it; returns {(dtype,
    flags): max abs error over the checks}."""
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
        for lo, hi in FLAGS:
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


def reset_launches():
    from stan_tpu_torch.fem import stencil

    stencil.launches = 0
    stencil.theta_launches = 0
    stencil.theta_batched_launches = 0


def calibration_observations(model, card):
    """bench.py's synthetic observations (bench.py:284-313), made with the
    port's own forward at θ_true: 128 strongly deflected nodes x 3
    directions, 1% noise. Returns (obs_nodes, obs_dirs, y, sigma, stats of
    the θ_true solve)."""
    from stan_tpu_torch.infer import forward

    fwd = forward.build_forward(model, device="cuda", cg_tol=1e-6)
    u_true = forward.displacement_fn(fwd, model.nelem)(
        torch.as_tensor(THETA_TRUE, device="cuda")).detach().cpu().numpy()
    stats = fwd.stats.as_dict()
    print(f"[{card}] forward at θ_true: {stats}")
    total = np.linalg.norm(u_true, axis=1)
    nodes = np.nonzero(total > 0.3 * total.max())[0][:128]
    obs_nodes = np.repeat(nodes, 3)
    obs_dirs = np.tile([0, 1, 2], len(nodes))
    rng = np.random.default_rng(0)
    sigma = 1e-2 * float(np.abs(u_true).max())
    y = u_true[obs_nodes, obs_dirs] + sigma * rng.normal(size=len(obs_nodes))
    return obs_nodes, obs_dirs, y, sigma, stats


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


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one calibration gradient")
    parser.add_argument("--cli", action="store_true",
                        help="run the calibrate command on the 32^3 beam")
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
    # Shapes that stress the kernel's tiling: one x-plane (every plane a
    # face), y and z extents that no tile width divides, z over two tiles.
    compare_theta(cal_model, chain_pairs, rng, f"[{CHAINS},3,3,35,35] SX=1",
                  card, True, sx=1)
    compare_theta(small, pairs, rng, "5x4x3 SX=1", card, False, sx=1)
    long_z = meshgen.hex_beam(6, 9, 140, lx=6.0, ly=9.0, lz=140.0)
    compare_theta(long_z, chain_pairs[:3], rng, "[3,3,9,12,143]", card, True)
    compare_theta(long_z, pairs[:1], rng, "[3,9,12,143]", card, False)

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

        t2 = stencil.pack_theta_tables(tl32, tm32, dtype, "cuda")
        coef_b = torch.as_tensor(chain_pairs, dtype=dtype, device="cuda")
        u_b = torch.as_tensor(rng.standard_normal((CHAINS, 3, *shape32)),
                              dtype=dtype, device="cuda")
        up_b = pad(u_b)
        K = assemble_csr([theta_unit(t2, 0), theta_unit(t2, 1)], shape32,
                         dtype)
        flat = u_b.reshape(CHAINS, n32).T
        V = torch.cat([coef_b[:, 0] * flat, coef_b[:, 1] * flat]).contiguous()
        facts[("theta_sweep_batched", dtype)] = measure(
            "theta_sweep_batched", up_b,
            lambda: stencil.theta_sweep_batched(up_b, t2, coef_b, 1, 1),
            lambda: stencil.theta_sweep_reference(up_b, t2, coef_b, 1, 1),
            lambda: torch.sparse.mm(K, V),
            lambda r: r.T.reshape(CHAINS, 3, *shape32),
            (t2.numel() + coef_b.numel()) * t2.element_size(), flush, card)
        del K, V
    del flush

    # -- the linear main path ---------------------------------------------
    model = meshgen.hex_beam(N, N, N)
    timer = PhaseTimer(verbose=False)
    reset_launches()
    t0 = time.perf_counter()
    res = solve_linear_statics(model, device="cuda", timer=timer)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = stencil.launches
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
    require(res.u.shape == (model.nnode, 3) and np.isfinite(res.u).all(),
            "displacements not finite or misshapen")
    require(res.stress.shape == (model.nelem, 8, 6)
            and np.isfinite(res.stress).all()
            and np.isfinite(res.strain).all(), "stress/strain not finite")

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
    theta_launches = stencil.theta_launches
    batched_launches = stencil.theta_batched_launches
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
    if args.profile:
        profile_gradient(prob, card)
    if args.cli:
        cli_calibration(card)

    rows = (
        ("stencil_sweep", "stan_tpu_torch/csrc/stencil_sweep.cu",
         "stan_tpu/fem/stencil.py:218", launches, errs),
        ("theta_sweep", "stan_tpu_torch/csrc/theta_sweep.cu",
         "stan_tpu/fem/stencil.py:570", theta_launches, theta_errs),
        ("theta_sweep_batched", "stan_tpu_torch/csrc/theta_sweep.cu",
         "stan_tpu/fem/stencil.py:610", batched_launches, batched_errs),
    )
    stray = sorted(m for m in sys.modules if m.split(".")[0] == "stan_tpu")
    require(not stray, f"the port loaded modules of stan_tpu: {stray}")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": n,
        "max_abs_err": err[(torch.float32, (1, 1))],
        **facts[(name, torch.float32)],
    } for name, source, replaces, n, err in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
