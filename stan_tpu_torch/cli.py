"""Command-line interface of the port: linear static solve and calibration.

``solve`` mirrors ``python -m stan_tpu.cli solve`` for the linear branch:
read the STdb, apply the TOML config and the flag overrides, validate,
solve, print iterations, residual, operator and certified residual, write
the STdb. Exit code 0 if the solve converged, 1 if not, 2 if the model is
invalid.

``calibrate`` mirrors ``python -m stan_tpu.cli calibrate`` for the HMC
sampler on one device: observations from the STdb's stored displacements
(or, with --synthetic, from a solve plus noise), the posterior of (E, ν),
chain-batched HMC, the posterior summary and the count of CG solves that
stopped unconverged. NUTS, VI and SMC are not ported yet.

Usage:
  python -m stan_tpu_torch.cli solve model.STdb [--out other.STdb]
                                     [--solver CG] [--tol 1e-6] [--maxiter N]
                                     [--config run.toml] [--device cuda]
  python -m stan_tpu_torch.cli calibrate model.STdb [--synthetic]
                                     [--sampler hmc] [--chains N]
                                     [--warmup N] [--samples N] [--n-obs 16]
                                     [--cg-tol 1e-6] [--config run.toml]
                                     [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

BANNER = r"""
  ==========================================================
      stan_tpu_torch  —  structural analysis on CUDA
      linear statics · structured HEX8 · PyTorch + CUDA
  ==========================================================
"""


def _cmd_solve(args) -> int:
    # io.stdb needs protobuf; it is imported here only, never with the
    # package, so the solver runs where protobuf is not installed.
    from stan_tpu.core import validate
    from stan_tpu.io import stdb
    from stan_tpu.utils import config as config_mod
    from stan_tpu_torch.analysis.linear import solve_linear_statics
    from stan_tpu_torch.utils.timing import PhaseTimer

    print(BANNER)
    timer = PhaseTimer(verbose=True)
    with timer.phase("Read database"):
        model = stdb.read(args.path)
    print(model.summary())

    if args.config:
        config_mod.load(args.config).apply_to_model(model)
    if args.solver:
        model.analysis.lin_solver = args.solver
    if args.tol is not None:
        model.analysis.lin_solver_tolerance = args.tol
    if args.maxiter is not None:
        model.analysis.lin_solver_maxiter = args.maxiter

    problems = validate.check_model(model)
    if problems:
        print("  ERROR: model validation failed:")
        for p in problems:
            print(f"    - {p}")
        return 2
    if model.analysis.type != "Linear_Statics":
        raise NotImplementedError(
            f"analysis type {model.analysis.type!r} is not ported yet: "
            f"ROADMAP.md queue 1, item 9 (nonlinear statics)")

    res = solve_linear_statics(model, device=args.device, timer=timer)
    print(f"   Linear solve: {res.iters} iterations, "
          f"residual {res.residual:.3e}, converged={res.converged}")
    print(f"   Operator: {res.operator} (device {args.device})")
    if res.true_residual is not None:
        print(f"   Certified f64 residual: {res.true_residual:.3e} "
              f"({res.refine_cycles} refinement cycles, "
              f"{res.refine_iters} extra CG iterations)")

    with timer.phase("Write database"):
        stdb.write(model, args.out or args.path)
    print(timer.summary())
    return 0 if res.converged else 1


def _cmd_calibrate(args) -> int:
    """Bayesian calibration of (E, ν) against observed displacements, with
    the FEM solve as the forward model and chain-batched HMC on one
    device."""
    import time

    import numpy as np
    import torch

    from stan_tpu.core import validate
    from stan_tpu.io import stdb
    from stan_tpu.utils import config as config_mod
    from stan_tpu_torch.infer import calibrate as cal_mod
    from stan_tpu_torch.infer import hmc as hmc_mod
    from stan_tpu_torch.utils.timing import PhaseTimer

    print(BANNER)
    timer = PhaseTimer(verbose=True)
    cfg = config_mod.load(args.config) if args.config else config_mod.load()
    inf = cfg.inference
    if args.sampler:
        inf.sampler = args.sampler
    if args.chains:
        inf.chains = args.chains
    if args.warmup is not None:
        inf.warmup = args.warmup
    if args.samples is not None:
        inf.samples = args.samples
    if inf.sampler != "hmc":
        raise NotImplementedError(
            f"sampler {inf.sampler!r} is not ported yet: ROADMAP.md queue 1, "
            f"item 7 (NUTS, VI, SMC); use --sampler hmc")
    if cfg.sharding.chains > 1 or cfg.sharding.domain > 1:
        raise NotImplementedError(
            "a [sharding] device mesh is not ported yet: ROADMAP.md queue 1, "
            "item 10 (multi-GPU); the port samples on one device")

    with timer.phase("Read database"):
        model = stdb.read(args.path)
    print(model.summary())
    problems = validate.check_model(model)
    if problems:
        print("  ERROR: model validation failed:")
        for p in problems:
            print(f"    - {p}")
        return 2

    # Observations: the DOFs with the largest response.
    with timer.phase("Observations"):
        if model.disp is not None and model.analysis.result_step_no > 0:
            u_obs_full = model.disp[-1]
        elif args.synthetic:
            from stan_tpu_torch.analysis.linear import solve_linear_statics

            res = solve_linear_statics(model, device=args.device, store=False)
            u_obs_full = np.asarray(res.u)
        else:
            print("  ERROR: no results in database "
                  "(run solve first, or pass --synthetic)")
            return 2
        mag = np.abs(u_obs_full).max(axis=1)
        obs_nodes = np.argsort(mag)[-args.n_obs:]
        obs_dirs = np.abs(u_obs_full[obs_nodes]).argmax(axis=1)
        rng = np.random.default_rng(inf.seed)
        y = u_obs_full[obs_nodes, obs_dirs]
        sigma = max(inf.sigma_obs, 1e-3 * float(np.abs(y).max()))
        y = y + rng.normal(0.0, sigma, y.shape)

    with timer.phase("Build posterior"):
        prob = cal_mod.make_problem(model, obs_nodes, obs_dirs, y, sigma,
                                    device=args.device, cg_tol=args.cg_tol,
                                    infer_load=inf.infer_load)

    # Overdispersed chain initialisations (one θ0 tiled across chains would
    # make R-hat understate non-convergence): jitter each chain around the
    # prior mean at about half the prior scale.
    rng_init = np.random.default_rng(inf.seed)
    init_scale = np.asarray([0.5 * prob.sigma_logE, 1.0,
                             0.5 * prob.sigma_logs])
    if not inf.infer_load:
        init_scale[2] = 0.0
    theta0 = torch.as_tensor(
        np.asarray([prob.mu_logE, 0.0, 0.0])
        + rng_init.normal(0.0, 1.0, (inf.chains, 3)) * init_scale,
        device=prob.fwd.device)
    t0 = time.perf_counter()
    with timer.phase(f"Sample ({inf.sampler})"):
        out = hmc_mod.run_hmc(prob.log_posterior, theta0, inf.seed,
                              n_warmup=inf.warmup, n_samples=inf.samples,
                              solve_stats=prob.fwd.stats)
    wall = time.perf_counter() - t0

    cons = cal_mod.CalibrationProblem.constrain(out.samples)
    flat = cons.reshape(-1, cons.shape[-1])
    print("  ==================   POSTERIOR   =========================")
    for k, name in enumerate(("E", "nu", "load_scale")):
        q = np.percentile(flat[:, k], [5, 50, 95])
        print(f"   {name:>10s}: median {q[1]:.6g}   90% CI "
              f"[{q[0]:.6g}, {q[2]:.6g}]")
    n_draws = int(np.prod(out.samples.shape[:-1]))
    sps = n_draws / wall if wall > 0 else float("nan")
    print(f"   draws: {n_draws}  wall: {wall:.1f}s  samples/s: {sps:.1f}  "
          f"accept: {float(np.mean(out.accept_rate)):.3f}")
    print(f"   R-hat: {np.max(out.rhat):.4f} (max over params)  min ESS: "
          f"{np.min(out.ess):.0f}")
    st = out.solve_stats
    print(f"   CG solves: {st['forward_solves']} forward "
          f"({st['forward_iters'] / max(st['forward_solves'], 1):.1f} "
          f"iterations each, {st['forward_unconverged']} unconverged), "
          f"{st['adjoint_solves']} adjoint "
          f"({st['adjoint_iters'] / max(st['adjoint_solves'], 1):.1f} "
          f"iterations each, {st['adjoint_unconverged']} unconverged) "
          f"at cg_tol {args.cg_tol:g}")
    print(timer.summary())
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="stan_tpu_torch",
                                     description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("solve", help="run the linear solver on an STdb file")
    p.add_argument("path")
    p.add_argument("--out", help="write results here instead of overwriting")
    p.add_argument("--solver", choices=["CG", "Cholesky", "LU"],
                   help="only CG is ported; the direct solvers raise")
    p.add_argument("--tol", type=float)
    p.add_argument("--maxiter", type=int)
    p.add_argument("--config", help="TOML run config (stan_tpu/utils/config.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device to solve on (default: cuda)")
    p.set_defaults(fn=_cmd_solve)

    p = sub.add_parser(
        "calibrate",
        help="Bayesian calibration of (E, nu) from displacement results")
    p.add_argument("path")
    p.add_argument("--sampler", choices=["hmc", "nuts", "vi", "smc"],
                   help="only hmc is ported; the others raise")
    p.add_argument("--chains", type=int)
    p.add_argument("--warmup", type=int)
    p.add_argument("--samples", type=int)
    p.add_argument("--n-obs", type=int, default=16,
                   help="number of observed DOFs (largest-response nodes)")
    p.add_argument("--synthetic", action="store_true",
                   help="generate observations by solving + adding noise")
    p.add_argument("--cg-tol", type=float, default=1.0e-6,
                   help="relative tolerance of the forward and adjoint CG "
                        "solves (default 1e-6: the port samples in float32, "
                        "where CG cannot be relied on to reach 1e-8)")
    p.add_argument("--config", help="TOML run config (stan_tpu/utils/config.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device to sample on (default: cuda)")
    p.set_defaults(fn=_cmd_calibrate)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
