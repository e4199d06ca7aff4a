"""The port's headline benchmark: the counterpart of the JAX package's
bench.py, computed on the card with the port's kernels.

A 70x70x70 structured HEX8 cantilever (1,073,733 DOF) on the float32
StencilOperator (every apply one stencil_sweep launch), and the 32^3
calibration of bench.py on the stencil forward (theta_sweep for one chain,
theta_sweep_batched for more). Each block prints one JSON line with a
"block" key the moment it ends:

  headline          cg_fixed (Jacobi-PCG, a fixed number of iterations, no
                    host read in the loop) and apply_chain, each run at two
                    loop lengths; the marginal per iteration on the host
                    clock (what a user of the eager loop gets; "value" and
                    dof_per_s are taken from it) and on the device (replays
                    of a CUDA graph of the loop, timed by CUDA events); a
                    torch.profiler breakdown of 100 iterations; the sweep's
                    bound from its shapes and the H100 data sheet;
  cpu_baseline      scipy CSR Jacobi-CG on the same K in float64 on the
                    host, 50 iterations: the denominator of vs_baseline;
  solve_to_tol_1e6  pcg to 1e-6 (iterations, seconds, the recurrence and
                    the true float64 residual, the latter read on the host
                    by exact_tables + apply_numpy), then pcg_certified with
                    the float64 StencilOperator as its residual, its answer
                    cross-checked on the host;
  hmc_<C>           HMC at C = 1, 4, 16 chains (8 leapfrog steps, 64 warmup
                    iterations, 100 / 50 / 50 draws per chain): steady
                    samples/s, acceptance, posterior summary against the
                    truth, and the forward and adjoint solves that stopped
                    unconverged;
  nuts              NUTS, 4 chains, 64 warmup + 40 draws, max_depth 6;
  chains_scaling    HMC at 1 chain, 8 chains placed over a mesh of 8 rows
                    (8 entries of this device, or the visible cards
                    round-robin) and 8 chains unplaced, float64, grid 12:
                    scaling_efficiency and sharded_vs_vmap
                    (stan_tpu_torch.chains_scaling).

The last line combines them under bench.py's keys, with the card's name
and power limit ("device") and each block's launches of the three kernels
("launches"). A block that would start after DEADLINE_S seconds prints
{"block": ..., "skipped": "deadline"}; --blocks runs only the blocks
named (the others print "skipped": "not asked for"). A block that fails
prints its error on its own line; the run goes on with the next block
and exits 1.

--small keeps bench.py's small sizes (n = 12, g = 8, rows of 1 and 2
chains, NUTS with 2 chains; chains_scaling at grid 3). --device cpu runs
every block on the CPU (the kernels' plain versions; chains_scaling on a
mesh of ["cpu"] * 8): a rehearsal, not a measurement of the card.

Run:  python -m stan_tpu_torch.bench [--small] [--device cuda|cpu]
          [--lengths WARMUP DRAWS] [--blocks NAME ...]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Blocks start only within this many seconds of the run's start, below the
# hour a run is given. A block that starts in time may run past it: on an
# H100 at 700 W the full run's blocks took about 2,830 s, nuts 1,455 s of
# them, so a run with less time is split with --blocks.
DEADLINE_S = 3000.0
# H100 SXM data sheet: HBM3 rate, and peak rates outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
CERT_TOL = 1e-6
TRUTHS = {"E": 190000.0, "nu": 0.28}
N_LEAPFROG, N_WARMUP, INIT_STEP = 8, 64, 0.02
# Draws come in this many chunks; the first is left out of the steady rate.
CHUNKS = 5
KERNELS = ("stencil_sweep", "theta_sweep", "theta_sweep_batched")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_info(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"kind": "cpu"}
    return {"kind": torch.cuda.get_device_name(dev),
            "name_power_limit": card_line()}


def launch_counts() -> dict:
    from stan_tpu_torch.fem import launches

    return {k: launches.counts[k] for k in KERNELS}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# headline: fixed-iteration CG and the apply chain
# ---------------------------------------------------------------------------

def cg_fixed(op, b: torch.Tensor, niters: int):
    """Jacobi-PCG for exactly niters iterations, with no host read in the
    loop (bench.py's cg_fixed). Returns (x, ||r||), both on b's device."""
    diag = op.diagonal()
    inv_diag = torch.where(diag != 0, 1.0 / diag, torch.zeros_like(diag))
    x = torch.zeros_like(b)
    r = b
    z = inv_diag * r
    p = z
    rz = torch.sum(r * z)
    for _ in range(niters):
        Ap = op.apply(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, torch.sqrt(torch.sum(r * r))


def apply_chain(op, b: torch.Tensor, niters: int) -> torch.Tensor:
    """op.apply chained on itself, rescaled by 1e-3 each time: the SpMV
    without the CG algebra."""
    x = b
    for _ in range(niters):
        x = op.apply(x) * 1e-3
    return x


def _wall(fn, dev):
    """(seconds, result) of one call after a warm-up call."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return time.perf_counter() - t0, out


def _graph_ms(fn, reps: int = 3) -> float:
    """Device milliseconds of fn() from replays of a CUDA graph of it,
    timed by CUDA events: no host dispatch between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def sweep_bound_ms(node_shape, dtype) -> tuple:
    """(bound in ms, "bytes" or "operations") of one stencil_sweep over a
    whole grid: the ghost-padded input, the output and the table each
    moved once at the HBM rate, against 243 multiply-adds per node at the
    peak rate of the type (H100 data sheet)."""
    size = torch.finfo(dtype).bits // 8
    nodes = int(np.prod(node_shape))
    padded = int(np.prod([n + 2 for n in node_shape]))
    nbytes = (3 * padded + 3 * nodes + 27 * 27 * 9) * size
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * 243 * nodes / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def profile_breakdown(fn, iters: int) -> dict:
    """fn() (iters CG iterations) under torch.profiler: device ms per
    iteration in the sweep, in pads and copies, and in the elementwise
    passes and reductions; the busy share of the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    wall_s, _ = _wall(fn, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    us = {"stencil_sweep": 0.0, "pad_and_copies": 0.0,
          "elementwise_and_reductions": 0.0}
    sweep_launches = 0
    for e in events:
        key = e.key.lower()
        if "sweep" in key:
            us["stencil_sweep"] += e.self_device_time_total
            sweep_launches += e.count
        elif any(w in key for w in ("pad", "copy", "memcpy", "memset",
                                    "fill")):
            us["pad_and_copies"] += e.self_device_time_total
        else:
            us["elementwise_and_reductions"] += e.self_device_time_total
    busy_us = sum(us.values())
    return {
        "iterations": iters,
        "wall_ms_per_iter": wall_s / iters * 1e3,
        "busy_ms_per_iter": busy_us / iters / 1e3,
        "busy_share": busy_us / 1e6 / wall_s,
        **{f"{k}_ms_per_iter": v / iters / 1e3 for k, v in us.items()},
        **{f"{k}_share": v / max(busy_us, 1e-9) for k, v in us.items()},
        "stencil_sweep_us_per_launch":
            us["stencil_sweep"] / max(sweep_launches, 1),
        "device_events_per_iter": sum(e.count for e in events) / iters,
    }


def headline(n: int, small: bool, dev: torch.device) -> dict:
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.fem import stencil

    model = meshgen.hex_beam(n, n, n)
    op = stencil.build_stencil_operator(model, dtype=torch.float32,
                                        device=dev)
    if op is None:
        raise RuntimeError(f"hex_beam({n}, {n}, {n}) refused by the stencil "
                           "operator")
    f = op.to_grid(torch.as_tensor(model.load_vector(), dtype=op.dtype,
                                   device=dev))
    rhs = (op.free_mask * f).contiguous()
    ndof = 3 * model.nnode

    n_lo, n_hi = (10, 50) if small else (100, 1000)
    t_lo, _ = _wall(lambda: cg_fixed(op, rhs, n_lo), dev)
    t_hi, (_, rn) = _wall(lambda: cg_fixed(op, rhs, n_hi), dev)
    marginal = (t_hi - t_lo) / (n_hi - n_lo)
    ta_lo, _ = _wall(lambda: apply_chain(op, rhs, n_lo), dev)
    ta_hi, _ = _wall(lambda: apply_chain(op, rhs, n_hi), dev)
    apply_ms = 1e3 * (ta_hi - ta_lo) / (n_hi - n_lo)
    roofline = {
        "wall_marginal_ms_per_iter": 1e3 * marginal,
        "apply_wall_marginal_ms": apply_ms,
        "cg_algebra_wall_ms": 1e3 * marginal - apply_ms,
        "fixed_overhead_ms": 1e3 * max(t_lo - n_lo * marginal, 0.0),
        "vector_mb": rhs.numel() * rhs.element_size() / 1e6,
    }
    if dev.type == "cuda":
        g_lo = _graph_ms(lambda: cg_fixed(op, rhs, n_lo))
        g_hi = _graph_ms(lambda: cg_fixed(op, rhs, n_hi))
        ga_lo = _graph_ms(lambda: apply_chain(op, rhs, n_lo))
        ga_hi = _graph_ms(lambda: apply_chain(op, rhs, n_hi))
        prof = profile_breakdown(lambda: cg_fixed(op, rhs, 100), 100)
        bound, bound_by = sweep_bound_ms(op.node_shape, op.dtype)
        roofline.update({
            "device_marginal_ms_per_iter": (g_hi - g_lo) / (n_hi - n_lo),
            "apply_device_marginal_ms": (ga_hi - ga_lo) / (n_hi - n_lo),
            "profile_100_iters": prof,
            "stencil_sweep_bound_ms": bound,
            "stencil_sweep_bound_by": bound_by,
            "stencil_sweep_share_of_bound":
                bound / (prof["stencil_sweep_us_per_launch"] / 1e3),
        })
    else:
        roofline["device"] = "not measured on the CPU"
    iters_per_s = 1.0 / marginal
    return {
        "metric": f"cg_iters_per_s_{ndof}dof_hex8_f32",
        "value": iters_per_s,
        "unit": "iters/s",
        "value_from": "wall marginal of the eager loop, "
                      f"({n_hi} - {n_lo}) iterations",
        "ndof": ndof,
        "nelem": model.nelem,
        "dof_per_s": ndof * iters_per_s,
        f"seconds_for_{n_hi}_iters": t_hi,
        "residual": float(rn),
        "roofline": roofline,
    }


# ---------------------------------------------------------------------------
# cpu_baseline: scipy CSR Jacobi-CG on the host
# ---------------------------------------------------------------------------

def baseline_system(m):
    """(K, f, M^-1) of tools/cpu_baseline.py for the model m: the global
    CSR K in float64 from the element stiffness, fixed DOFs masked
    (M K M + I - M), the masked load and the Jacobi preconditioner."""
    import scipy.sparse as sp

    from stan_tpu_torch.fem import assembly, kernels

    conn = np.asarray(m.conn)
    coords = torch.as_tensor(m.coords, dtype=torch.float64)
    ke = kernels.element_stiffness(
        coords[torch.as_tensor(conn)],
        torch.as_tensor(m.elem_d_matrices(), dtype=torch.float64),
        m.formulation()).numpy()
    rows, cols = assembly.coo_indices(conn)
    K = sp.coo_matrix((ke.ravel(), (rows.ravel(), cols.ravel())),
                      shape=(m.ndof, m.ndof)).tocsr()
    del ke, rows, cols
    mfree = (~np.asarray(m.fix_mask()).reshape(-1)).astype(np.float64)
    K = sp.diags(mfree) @ K @ sp.diags(mfree) + sp.diags(1.0 - mfree)
    f = np.asarray(m.load_vector()).reshape(-1) * mfree
    return K, f, sp.diags(1.0 / K.diagonal())


def baseline_cg(K, f, Minv, maxiter: int = 50):
    """scipy's Jacobi-preconditioned CG, exactly maxiter iterations.
    Returns (x, iterations, seconds)."""
    import scipy.sparse.linalg as spla

    niter = [0]
    t0 = time.perf_counter()
    x, _ = spla.cg(K, f, rtol=1e-30, atol=0.0, maxiter=maxiter, M=Minv,
                   callback=lambda _: niter.__setitem__(0, niter[0] + 1))
    return x, niter[0], time.perf_counter() - t0


def cpu_baseline(n: int) -> dict:
    from stan_tpu_torch.core import meshgen

    t0 = time.perf_counter()
    K, f, Minv = baseline_system(meshgen.hex_beam(n, n, n))
    setup_s = time.perf_counter() - t0
    x, iters, dt = baseline_cg(K, f, Minv)
    return {
        "what": "scipy CSR Jacobi-CG, float64, on the host of this run",
        "ndof": int(K.shape[0]),
        "nnz": int(K.nnz),
        "setup_seconds": setup_s,
        "iters": iters,
        "seconds": dt,
        "iters_per_s": iters / dt,
        "rel_residual": float(np.linalg.norm(f - K @ x)
                              / np.linalg.norm(f)),
    }


# ---------------------------------------------------------------------------
# solve to tolerance, and the certified solve
# ---------------------------------------------------------------------------

def solve_to_tol(n: int, dev: torch.device) -> dict:
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.fem import stencil
    from stan_tpu_torch.solvers import cg

    model = meshgen.hex_beam(n, n, n)
    op = stencil.build_stencil_operator(model, dtype=torch.float32,
                                        device=dev)
    ex = stencil.build_stencil_operator(model, dtype=torch.float64,
                                        device=dev)
    loads = torch.as_tensor(model.load_vector(), dtype=torch.float64,
                            device=dev)
    b64 = (ex.free_mask * ex.to_grid(loads)).contiguous()
    rhs = b64.to(torch.float32)
    ndof = 3 * model.nnode
    diag = op.diagonal()
    runs = []
    for _ in range(3):  # the first cold; "seconds" is the second, as bench.py
        _sync(dev)
        t0 = time.perf_counter()
        res = cg.pcg(op.apply, rhs, diag=diag, tol=CERT_TOL,
                     maxiter=10 * ndof, ndof=ndof)
        _sync(dev)
        runs.append(time.perf_counter() - t0)
    t_base = runs[1]
    recurrence_rel = res.residual / max(
        float(torch.linalg.vector_norm(rhs)), 1e-300)

    # The float64 operator on the host, without the kernel (bench.py's
    # A_hi): the exact tables applied by apply_numpy, masked.
    t64, d64 = stencil.exact_tables(model)
    free = op.free_mask.to(torch.float64).cpu().numpy()

    def A_hi(xg):
        return (free * stencil.apply_numpy(t64, d64, free * xg)
                + (1.0 - free) * xg)

    b_np = b64.cpu().numpy()
    bnorm = float(np.linalg.norm(b_np.ravel()))

    def host_rel(x):
        return float(np.linalg.norm((b_np - A_hi(x)).ravel())) / bnorm

    true_rel = host_rel(res.u.to(torch.float64).cpu().numpy())
    cert = cg.pcg_certified(op.apply, b64, ex.apply, diag=diag, tol=CERT_TOL,
                            ndof=ndof, measure=True)
    cert_host = host_rel(cert.u.cpu().numpy())
    return {
        "iters": res.iters,
        "seconds": t_base,
        "seconds_runs": runs,
        "recurrence_rel_residual": recurrence_rel,
        "true_f64_rel_residual_uncertified": true_rel,
        "converged": bool(res.converged),
        "certified": {
            "seconds": cert.seconds,
            "cycles": cert.cycles,
            "inner_iters": cert.inner_iters,
            "rel_residual_device_f64": cert.rel_residual,
            "rel_residual_host_f64_crosscheck": cert_host,
            "converged": bool(cert.converged),
            "overhead_vs_uncertified_base":
                max(cert.seconds - t_base, 0.0) / max(t_base, 1e-9),
        },
    }


# ---------------------------------------------------------------------------
# the calibration: HMC rows and NUTS
# ---------------------------------------------------------------------------

def _calibration_problem(g: int, device="cuda", dtype=None):
    """bench.py's g^3 calibration: observations of 128 strongly deflected
    nodes x 3 directions from the port's own forward at the truth, with 1%
    noise. Returns (model, prob)."""
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.infer import calibrate, forward

    model = meshgen.hex_beam(g, g, g)
    true_theta = np.array([np.log(190000.0), 0.28, 0.0])
    fwd = forward.build_forward(model, dtype=dtype, device=device,
                                cg_tol=1e-6)
    if not isinstance(fwd, forward.StencilForwardProblem):
        raise RuntimeError(f"the {g}^3 calibration took {type(fwd).__name__}")
    u_true = forward.displacement_fn(fwd, model.nelem)(
        torch.as_tensor(true_theta, device=fwd.device)
    ).detach().cpu().numpy()
    total = np.linalg.norm(u_true, axis=1)
    nodes = np.nonzero(total > 0.3 * total.max())[0][:128]
    obs_nodes = np.repeat(nodes, 3)
    obs_dirs = np.tile([0, 1, 2], len(nodes))
    rng = np.random.default_rng(0)
    # 1% noise: with 384 observations, sd(log E) ~ 5e-4, hundreds of
    # float32 ulps of θ.
    sigma = 1e-2 * float(np.abs(u_true).max())
    y = u_true[obs_nodes, obs_dirs] + sigma * rng.normal(size=len(obs_nodes))
    prob = calibrate.make_problem(model, obs_nodes, obs_dirs, y, sigma,
                                  dtype=dtype, device=device, cg_tol=1e-6)
    return model, prob


def _posterior_summary(res, n_chains):
    """Posterior mean and sd of E and ν, ESS, and the z-score of each mean
    against the truth in units of its Monte-Carlo error."""
    from stan_tpu_torch.infer import calibrate

    cons = calibrate.CalibrationProblem.constrain(res.samples)
    out = {}
    for i, name in enumerate(["E", "nu"]):
        s = cons[..., i]
        mean, sd = float(s.mean()), float(s.std())
        ess = float(res.ess[i]) if res.ess is not None else float("nan")
        mc_err = sd / max(np.sqrt(max(ess, 1.0)), 1.0)
        out[f"posterior_{name}_mean"] = mean
        out[f"posterior_{name}_sd"] = sd
        out[f"ess_{name}"] = round(ess, 1)
        out[f"z_vs_truth_{name}"] = round((mean - TRUTHS[name]) / mc_err, 2)
    out["truth"] = dict(TRUTHS)
    out["rhat_max"] = float(np.max(res.rhat))
    return out


def _steady_sps(res, n_chains):
    """Draws per second over every chunk but the first."""
    steady_s = sum(res.chunk_seconds[1:])
    steady_n = sum(res.chunk_sizes[1:])
    return n_chains * steady_n / steady_s if steady_s > 0 else 0.0


def _theta0(n_chains: int, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.array([np.log(210000.0), 0.0, 0.0])[None]
                           + 0.05 * rng.normal(size=(n_chains, 3)),
                           device=dev)


def _solves(res) -> dict:
    st = res.solve_stats
    return {"unconverged_forward": res.unconverged_forward,
            "unconverged_adjoint": res.unconverged_adjoint,
            "forward_solves": st["forward_solves"],
            "adjoint_solves": st["adjoint_solves"],
            "iters_per_forward_solve":
                st["forward_iters"] / max(st["forward_solves"], 1),
            "iters_per_adjoint_solve":
                st["adjoint_iters"] / max(st["adjoint_solves"], 1)}


def hmc_row(g: int, small: bool, n_chains: int, dev, lengths=None) -> dict:
    """One HMC row on the g^3 calibration at n_chains chains; lengths
    (warmup, draws per chain) replaces the row's own."""
    from stan_tpu_torch.infer import hmc

    model, prob = _calibration_problem(g, dev)
    n_warmup, n_samples = lengths or (
        N_WARMUP, 20 if small else (100 if n_chains == 1 else 50))
    res = hmc.run_hmc(
        prob.log_posterior, _theta0(n_chains, 7, dev), 11,
        n_samples=n_samples, n_warmup=n_warmup, n_leapfrog=N_LEAPFROG,
        init_step=INIT_STEP, checkpoint_every=max(2, n_samples // CHUNKS),
        solve_stats=prob.fwd.stats)
    return {
        "n_chains": n_chains,
        "n_warmup": n_warmup,
        "n_samples": n_samples,
        "total_draws": n_chains * n_samples,
        "ndof": int(3 * model.nnode),
        "samples_per_s_chip": _steady_sps(res, n_chains),
        "accept_rate": float(np.mean(res.accept_rate)),
        "step_size": float(np.mean(res.step_size)),
        "warmup_seconds": res.warmup_seconds,
        "grad_evals": res.grad_evals,
        **_solves(res),
        **_posterior_summary(res, n_chains),
    }


def nuts_block(g: int, small: bool, dev, lengths=None) -> dict:
    """NUTS on the same calibration, with its trajectory cost
    (evals_per_sample); lengths as for hmc_row."""
    from stan_tpu_torch.infer import nuts

    model, prob = _calibration_problem(g, dev)
    n_chains = 2 if small else 4
    n_warmup, n_samples = lengths or ((32, 10) if small else (N_WARMUP, 40))
    res = nuts.run_nuts(
        prob.log_posterior, _theta0(n_chains, 9, dev), 13,
        n_samples=n_samples, n_warmup=n_warmup, max_depth=6,
        init_step=INIT_STEP, checkpoint_every=max(2, n_samples // CHUNKS),
        solve_stats=prob.fwd.stats)
    return {
        "metric": f"nuts_samples_per_s_chip_{g}cubed_fem_calibration",
        "ndof": int(3 * model.nnode),
        "n_chains": n_chains,
        "n_warmup": n_warmup,
        "n_samples": n_samples,
        "samples_per_s_chip": _steady_sps(res, n_chains),
        "evals_per_sample": float(np.mean(res.evals_per_sample)),
        "accept_stat": float(np.mean(res.accept_rate)),
        "warmup_seconds": res.warmup_seconds,
        **_solves(res),
        **_posterior_summary(res, n_chains),
    }


def chains_scaling(dev, small: bool, lengths=None) -> dict:
    """stan_tpu_torch.chains_scaling's record on the bench's device, at
    SCALING.json's configuration (grid 12, 20 warmup iterations, 12 draws;
    --small: grid 3, 2 + 2); lengths as for hmc_row."""
    from stan_tpu_torch import chains_scaling as scaling

    n_warmup, n_samples = lengths or ((2, 2) if small else (20, 12))
    record, _ = scaling.measure(3 if small else 12, n_samples, n_warmup,
                                device=dev)
    return record


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run(small: bool = False, device="cuda", emit=print, lengths=None,
        only=None) -> tuple:
    """Every block in turn, each line emitted as it ends. lengths:
    (warmup, draws per chain) for every sampler block instead of their
    own; only: the names of the blocks to run (the others print
    "skipped"), so that a run too long for one sitting can be split.
    Returns (the combined record, the names of the blocks that failed)."""
    from stan_tpu_torch.fem.operator import resolve_device

    dev = resolve_device(device)
    info = device_info(dev)
    n, g = (12, 8) if small else (70, 32)
    chain_counts = (1, 2) if small else (1, 4, 16)
    start = time.perf_counter()
    results, launches, failed = {}, {}, []

    def block(name, fn):
        skip = ("not asked for" if only is not None and name not in only
                else "deadline" if time.perf_counter() - start > DEADLINE_S
                else None)
        if skip:
            emit(json.dumps({"block": name, "skipped": skip,
                             "device": info}))
            return None
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:  # reported, and the run exits non-zero
            failed.append(name)
            emit(json.dumps({"block": name,
                             "error": f"{type(e).__name__}: {e}",
                             "device": info}))
            return None
        after = launch_counts()
        launches[name] = {k: after[k] - before[k] for k in KERNELS}
        results[name] = out
        emit(json.dumps({"block": name, **out,
                         "block_seconds": time.perf_counter() - t0,
                         "launches": launches[name], "device": info}))
        return out

    head = block("headline", lambda: headline(n, small, dev)) or {}
    base = block("cpu_baseline", lambda: cpu_baseline(n))
    solve = block("solve_to_tol_1e6", lambda: solve_to_tol(n, dev))
    rows = [block(f"hmc_{c}",
                  lambda c=c: hmc_row(g, small, c, dev, lengths))
            for c in chain_counts]
    nuts_stats = block("nuts", lambda: nuts_block(g, small, dev, lengths))
    scaling = block("chains_scaling", lambda: {
        "chains_scaling": chains_scaling(dev, small, lengths)})

    value = head.get("value")
    rate = base["iters_per_s"] if base else None
    record = {
        **head,
        "vs_baseline": value / rate if value and rate else None,
        "baseline": (f"scipy CSR Jacobi-CG on this host: {rate} iters/s"
                     if rate else None),
        "cpu_baseline": base,
        "solve_to_tol_1e6": solve,
        "hmc": {
            "metric": f"hmc_samples_per_s_chip_{g}cubed_fem_calibration",
            "n_leapfrog": N_LEAPFROG,
            "n_warmup": lengths[0] if lengths else N_WARMUP,
            "warmup": "Stan-style windowed step+mass co-adaptation "
                      "+ init-stepsize search + de-resonance step jitter",
            "rows": rows,
        },
        "nuts": nuts_stats,
        "chains_scaling": scaling["chains_scaling"] if scaling else None,
        "device": info,
        "launches": launches,
        "failed": failed,
        "seconds": time.perf_counter() - start,
    }
    return record, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="bench.py's small sizes: n = 12, g = 8")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--lengths", type=int, nargs=2,
                    metavar=("WARMUP", "DRAWS"),
                    help="warmup iterations and draws per chain of every "
                         "sampler block, instead of their own (a short "
                         "rehearsal)")
    ap.add_argument("--blocks", nargs="+", metavar="NAME",
                    help="run only these blocks (headline, cpu_baseline, "
                         "solve_to_tol_1e6, hmc_<chains>, nuts, "
                         "chains_scaling)")
    args = ap.parse_args(argv)
    try:
        record, failed = run(small=args.small, device=args.device,
                             emit=lambda line: print(line, flush=True),
                             lengths=args.lengths, only=args.blocks)
    except RuntimeError as e:
        print(f"stan_tpu_torch.bench: {e}", file=sys.stderr)
        return 2
    print(json.dumps(record), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
