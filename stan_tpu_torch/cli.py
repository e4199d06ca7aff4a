"""Command-line interface of the port: the linear static solve of an STdb.

Mirrors ``python -m stan_tpu.cli solve`` for the linear branch: read the
STdb, apply the TOML config and the flag overrides, validate, solve, print
iterations, residual, operator and certified residual, write the STdb.
Exit code 0 if the solve converged, 1 if not, 2 if the model is invalid.

Usage:
  python -m stan_tpu_torch.cli solve model.STdb [--out other.STdb]
                                     [--solver CG] [--tol 1e-6] [--maxiter N]
                                     [--config run.toml] [--device cuda]
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

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
