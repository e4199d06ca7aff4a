"""Command-line interface of the port.

Port of stan_tpu/cli.py:

``solve`` mirrors the reference's: read the STdb, apply the TOML config and
the flag overrides, validate, solve, write the STdb. A linear solve (CG,
or the Cholesky and LU direct solvers) prints iterations, residual,
operator, the number of devices and the float64 residual; --domain N
decomposes a CG solve over N devices (the visible cards, or N CPU slabs
with --device cpu). A nonlinear one (--type
Nonlinear_Statics, --increments N) prints each increment's Newton
iterations, residual and CG iterations. Exit code 0 if the solve
converged, 1 if not, 2 if the model is invalid.

``calibrate`` infers (E, ν) from the STdb's stored displacements (or, with
--synthetic, from a solve plus noise) with the FEM solve as the forward
model: NUTS (the config's default), HMC, mean-field ADVI or adaptive SMC,
all chain- or particle-batched. The config's [sharding] section places
HMC's, NUTS's and SMC's chains over a (chains x domain) device mesh, as
the reference's does: explicit extents build the mesh over the visible
cards (with --device cpu, over that many CPU slots), and with none, more
than one visible card and a chain count they divide, every card goes on
the chains axis. It prints the mesh, the posterior summary and the count
of CG solves that stopped unconverged.

``import``, ``export``, ``strip-results`` and ``info`` are the reference's
data pipeline: Nastran .bdf to STdb, results to ParaView .vtu (fields
computed on --device), removing stored results, a summary.

``--log-json`` appends a structured record of a solve or calibration
(utils/runlog.py).

Usage:
  python -m stan_tpu_torch.cli solve model.STdb [--out other.STdb]
                                     [--solver CG|Cholesky|LU] [--tol 1e-6]
                                     [--maxiter N]
                                     [--type Linear_Statics|Nonlinear_Statics]
                                     [--increments N] [--domain N]
                                     [--config run.toml] [--log-json run.jsonl]
                                     [--device cuda]
  python -m stan_tpu_torch.cli calibrate model.STdb [--synthetic]
                                     [--sampler nuts|hmc|vi|smc] [--chains N]
                                     [--warmup N] [--samples N] [--n-obs 16]
                                     [--cg-tol 1e-6] [--config run.toml]
                                     [--log-json run.jsonl] [--device cuda]
  python -m stan_tpu_torch.cli import mesh.bdf model.STdb [--E 210000
                                     --poisson 0.3] [--strict]
  python -m stan_tpu_torch.cli export model.STdb out_prefix [--ascii]
                                     [--undeformed] [--device cuda]
  python -m stan_tpu_torch.cli strip-results model.STdb [--out other.STdb]
  python -m stan_tpu_torch.cli info model.STdb

io.stdb needs protobuf; it is imported inside the commands only, never
with the package, so the library runs where protobuf is not installed.
"""

from __future__ import annotations

import argparse
import sys

BANNER = r"""
  ==========================================================
      stan_tpu_torch  —  structural analysis on CUDA
      linear / nonlinear statics · HEX8/TET4 · PyTorch + CUDA
  ==========================================================
"""


def _cmd_solve(args) -> int:
    from stan_tpu_torch.core import validate
    from stan_tpu_torch.io import stdb
    from stan_tpu_torch.utils import config as config_mod
    from stan_tpu_torch.utils import runlog
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
    if args.type:
        model.analysis.type = args.type
    if args.increments is not None:
        model.analysis.inc_numb = args.increments

    problems = validate.check_model(model)
    if problems:
        print("  ERROR: model validation failed:")
        for p in problems:
            print(f"    - {p}")
        return 2

    record = dict(device=args.device)
    if model.analysis.type == "Linear_Statics":
        from stan_tpu_torch.analysis.linear import solve_linear_statics

        res = solve_linear_statics(model, device=args.device, timer=timer,
                                   n_domain=args.domain)
        print(f"   Linear solve: {res.iters} iterations, "
              f"residual {res.residual:.3e}, converged={res.converged}")
        print(f"   Operator: {res.operator} ({res.n_domain} "
              f"device{'s' if res.n_domain != 1 else ''}, {args.device})")
        if res.true_residual is not None:
            print(f"   Certified f64 residual: {res.true_residual:.3e} "
                  f"({res.refine_cycles} refinement cycles, "
                  f"{res.refine_iters} extra CG iterations)")
        record.update(iters=res.iters, residual=res.residual,
                      operator=res.operator, n_domain=res.n_domain,
                      true_residual=res.true_residual,
                      refine_cycles=res.refine_cycles)
    elif model.analysis.type == "Nonlinear_Statics":
        from stan_tpu_torch.analysis.nonlinear import solve_nonlinear_statics

        res = solve_nonlinear_statics(model, device=args.device, timer=timer)
        for r in timer.records:
            if r["phase"].startswith("Increment "):
                print(f"   {r['phase']}: {r['newton_iters']} Newton "
                      f"iterations, residual {r['residual']}, CG iterations "
                      f"{r['cg_iters']}")
        print(f"   Nonlinear solve: converged={res.converged} "
              f"(device {args.device})")
        record.update(newton_iters=res.newton_iters,
                      residuals=res.residuals)
    else:
        print(f"  ERROR: unknown analysis type {model.analysis.type!r}")
        return 2

    out = args.out or args.path
    with timer.phase("Write database"):
        stdb.write(model, out)
    print(timer.summary())
    if args.log_json:
        runlog.append(args.log_json, runlog.make_record(
            "solve", model=model, timer=timer,
            converged=bool(res.converged), path=args.path, out=out,
            **record))
    return 0 if res.converged else 1


def _calibration_mesh(sharding, n_chains: int, device):
    """The device mesh of `calibrate` (stan_tpu/cli.py:192-216), or None.
    Explicit [sharding] extents build a chains x domain mesh over the
    visible cards, or over as many CPU slots with a CPU device (the
    stand-in for the reference's virtual CPU devices); a mesh that needs
    more cards than are visible is refused, never repeated on one card.
    With no extents, more than one visible card and a chain count they
    divide, every card goes on the chains axis. Raises ValueError on a
    mismatch."""
    import torch

    from stan_tpu_torch.parallel import distributed

    if sharding.chains > 1 or sharding.domain > 1:
        devices = None
        if device.type != "cuda":
            devices = [device] * (sharding.chains * sharding.domain)
        try:
            return distributed.device_mesh(sharding.chains, sharding.domain,
                                           devices=devices)
        except ValueError as e:
            raise ValueError(f"[sharding] {e}") from None
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_dev > 1 and n_chains % n_dev == 0:
        return distributed.device_mesh(n_dev, 1)
    return None


def _cmd_calibrate(args) -> int:
    """Bayesian calibration of (E, ν) against observed displacements, with
    the FEM solve as the forward model, on one device or a [sharding]
    device mesh."""
    import time

    import numpy as np
    import torch

    from stan_tpu_torch.core import validate
    from stan_tpu_torch.fem.operator import resolve_device
    from stan_tpu_torch.io import stdb
    from stan_tpu_torch.parallel import distributed
    from stan_tpu_torch.utils import config as config_mod
    from stan_tpu_torch.utils import runlog
    from stan_tpu_torch.infer import calibrate as cal_mod
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

    # Device mesh for chain placement ([sharding]; the reference's
    # stan_tpu/cli.py:192-216): a mismatch is a user error, reported with
    # exit code 2.
    try:
        mesh = _calibration_mesh(cfg.sharding, inf.chains,
                                 resolve_device(args.device))
    except ValueError as e:
        print(f"  ERROR: {e}")
        return 2
    if mesh is not None:
        n_rows = mesh.shape["chains"]
        if inf.chains % n_rows:
            print(f"  ERROR: chains={inf.chains} not divisible by the "
                  f"chains mesh axis ({n_rows})")
            return 2
        print(f"   {distributed.describe(mesh)}")

    with timer.phase("Build posterior"):
        prob = cal_mod.make_problem(model, obs_nodes, obs_dirs, y, sigma,
                                    device=args.device, cg_tol=args.cg_tol,
                                    infer_load=inf.infer_load, mesh=mesh)

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
    rhat = ess = None
    stats0 = prob.fwd.stats.as_dict()
    t0 = time.perf_counter()
    with timer.phase(f"Sample ({inf.sampler})"):
        if inf.sampler in ("hmc", "nuts"):
            from stan_tpu_torch.infer import hmc as hmc_mod
            from stan_tpu_torch.infer import nuts as nuts_mod

            run = hmc_mod.run_hmc if inf.sampler == "hmc" else \
                nuts_mod.run_nuts
            # With the load fixed the posterior does not depend on log s:
            # the samplers hold it at 0 (s = 1), and the diagnostics are
            # those of the free coordinates.
            out = run(prob.log_posterior, theta0, inf.seed,
                      n_warmup=inf.warmup, n_samples=inf.samples,
                      solve_stats=prob.fwd.stats, mesh=mesh, held=prob.held)
            samples = out.samples  # [chains, n, 3]
            accept = float(np.mean(out.accept_rate))
            free = ~np.asarray(prob.held)
            rhat, ess = np.max(out.rhat[free]), np.min(out.ess[free])
        elif inf.sampler == "vi":
            from stan_tpu_torch.infer import vi as vi_mod

            out = vi_mod.run_advi(prob.log_posterior, theta0[0], inf.seed,
                                  n_steps=inf.samples)
            samples = out.sample(inf.seed, inf.chains * 256)[None]
            accept = float("nan")
        else:  # smc: prior/likelihood split of the same posterior
            from stan_tpu_torch.infer import smc as smc_mod

            out = smc_mod.run_smc(prob.log_prior, prob.log_likelihood,
                                  prob.sample_prior, inf.seed,
                                  n_particles=max(inf.chains * 64, 256),
                                  device=prob.fwd.device, mesh=mesh)
            samples = out.particles[None]
            accept = float(np.mean(out.acceptance))
    wall = time.perf_counter() - t0
    st = prob.fwd.stats.since(stats0)

    cons = cal_mod.CalibrationProblem.constrain(np.asarray(samples))
    flat = cons.reshape(-1, cons.shape[-1])
    print("  ==================   POSTERIOR   =========================")
    for k, name in enumerate(("E", "nu", "load_scale")):
        q = np.percentile(flat[:, k], [5, 50, 95])
        print(f"   {name:>10s}: median {q[1]:.6g}   90% CI "
              f"[{q[0]:.6g}, {q[2]:.6g}]")
    n_draws = int(np.prod(np.asarray(samples).shape[:-1]))
    sps = n_draws / wall if wall > 0 else float("nan")
    print(f"   draws: {n_draws}  wall: {wall:.1f}s  samples/s: {sps:.1f}  "
          f"accept: {accept:.3f}")
    if rhat is not None:
        print(f"   R-hat: {rhat:.4f} (max over free params)  min ESS: "
              f"{ess:.0f}")
    print(f"   CG solves: {st['forward_solves']} forward "
          f"({st['forward_iters'] / max(st['forward_solves'], 1):.1f} "
          f"iterations each, {st['forward_unconverged']} unconverged), "
          f"{st['adjoint_solves']} adjoint "
          f"({st['adjoint_iters'] / max(st['adjoint_solves'], 1):.1f} "
          f"iterations each, {st['adjoint_unconverged']} unconverged) "
          f"at cg_tol {args.cg_tol:g}")
    print(timer.summary())
    if args.log_json:
        runlog.append(args.log_json, runlog.make_record(
            "calibrate", model=model, timer=timer,
            sampler=inf.sampler, chains=inf.chains, draws=n_draws,
            samples_per_s=sps, accept=accept, path=args.path,
            mesh=distributed.describe(mesh) if mesh is not None else None,
            n_devices=torch.cuda.device_count(),
            rhat=float(rhat) if rhat is not None else None,
            device=args.device, solve_stats=st))
    return 0


def _cmd_import(args) -> int:
    import numpy as np

    from stan_tpu_torch.core.model import Material
    from stan_tpu_torch.io import nastran, stdb

    model = nastran.read_bdf(args.bdf, strict=args.strict)
    if model.import_errors:
        print(f"  WARNING: {len(model.import_errors)} cards failed to parse")
        for line in model.import_errors[:10]:
            print(f"    {line[:70]}")
    # Default material assignment so the file is immediately solvable once
    # BCs are added (the reference requires assigning materials in the GUI
    # before running, MainWindow.xaml.cs:474-487).
    if args.E is not None:
        model.materials[1] = Material(
            id=1, name="default", E=args.E, poisson=args.poisson
        )
        model.elem_mat = np.ones(model.nelem, dtype=np.int64)
        for info in model.part_info.values():
            info.mat_id = 1
    stdb.write(model, args.out)
    print(model.summary())
    print(f"  Wrote {args.out}")
    return 0


def _cmd_export(args) -> int:
    from stan_tpu_torch.io import stdb
    from stan_tpu_torch.post import fields

    model = stdb.read(args.path)
    if model.disp is None:
        print("  ERROR: no results in database (run solve first)")
        return 2
    paths = fields.export_vtu(
        model, args.prefix, binary=not args.ascii,
        deformed=not args.undeformed, device=args.device,
    )
    for p in paths:
        print(f"  Wrote {p}")
    return 0


def _cmd_strip_results(args) -> int:
    """Remove stored results from an STdb (the reference GUI's
    Remove Results action, MainWindow.xaml.cs:731-763), shrinking the file
    back to pre-solve size."""
    import os

    from stan_tpu_torch.io import stdb

    model = stdb.read(args.path)
    if model.disp is None:
        print("  No results in database; nothing to strip")
        return 0
    before = os.path.getsize(args.path)
    model.strip_results()
    out = args.out or args.path
    stdb.write(model, out)
    after = os.path.getsize(out)
    print(f"  Stripped results: {before} -> {after} bytes ({out})")
    return 0


def _cmd_info(args) -> int:
    from stan_tpu_torch.io import stdb

    model = stdb.read(args.path)
    print(model.summary())
    a = model.analysis
    print(f"   Analysis: {a.type}, solver {a.lin_solver}, "
          f"tol {a.lin_solver_tolerance}, maxiter {a.lin_solver_maxiter}")
    print(f"   Materials: {len(model.materials)}, BCs: {len(model.bcs)}, "
          f"parts: {len(model.part_info)}")
    if model.disp is not None:
        print(f"   Results: {model.disp.shape[0]} increments "
              f"(result_step_no={a.result_step_no})")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="stan_tpu_torch",
                                     description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("solve", help="run the solver on an STdb file")
    p.add_argument("path")
    p.add_argument("--out", help="write results here instead of overwriting")
    p.add_argument("--solver", choices=["CG", "Cholesky", "LU"],
                   help="linear solver (Cholesky/LU: dense on the device up "
                        "to 6000 DOF, banded on the host above)")
    p.add_argument("--tol", type=float)
    p.add_argument("--maxiter", type=int)
    p.add_argument("--type", choices=["Linear_Statics", "Nonlinear_Statics"],
                   help="analysis type (default: the model's)")
    p.add_argument("--increments", type=int,
                   help="load increments of a nonlinear solve")
    p.add_argument("--domain", type=int, default=None,
                   help="domain-decomposition width of a CG solve (devices); "
                        "default: all visible cards for meshes of 20,000 "
                        "nodes or more, 1 otherwise (1 on the CPU)")
    p.add_argument("--config", help="TOML run config (utils/config.py)")
    p.add_argument("--log-json", help="append a structured run record here")
    p.add_argument("--device", default="cuda",
                   help="torch device to solve on (default: cuda)")
    p.set_defaults(fn=_cmd_solve)

    p = sub.add_parser(
        "calibrate",
        help="Bayesian calibration of (E, nu) from displacement results")
    p.add_argument("path")
    p.add_argument("--sampler", choices=["hmc", "nuts", "vi", "smc"],
                   help="default: the config's (nuts)")
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
    p.add_argument("--config", help="TOML run config (utils/config.py)")
    p.add_argument("--log-json", help="append a structured run record here")
    p.add_argument("--device", default="cuda",
                   help="torch device to sample on (default: cuda)")
    p.set_defaults(fn=_cmd_calibrate)

    p = sub.add_parser("import", help="convert a Nastran .bdf mesh to STdb")
    p.add_argument("bdf")
    p.add_argument("out")
    p.add_argument("--E", type=float, help="assign a default material E")
    p.add_argument("--poisson", type=float, default=0.3)
    p.add_argument("--strict", action="store_true",
                   help="reference whitelist (CHEXA only)")
    p.set_defaults(fn=_cmd_import)

    p = sub.add_parser("export", help="export results to ParaView .vtu")
    p.add_argument("path")
    p.add_argument("prefix")
    p.add_argument("--ascii", action="store_true")
    p.add_argument("--undeformed", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute the fields on "
                        "(default: cuda)")
    p.set_defaults(fn=_cmd_export)

    p = sub.add_parser(
        "strip-results",
        help="remove stored results from an STdb (shrinks the file)")
    p.add_argument("path")
    p.add_argument("--out", help="write here instead of overwriting")
    p.set_defaults(fn=_cmd_strip_results)

    p = sub.add_parser("info", help="print database summary")
    p.add_argument("path")
    p.set_defaults(fn=_cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
