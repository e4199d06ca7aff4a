"""Large-model calibration on one card: the counterpart of the JAX
package's tools/calib_large.py.

A short HMC calibration of (E, ν) on an N^3-element structured beam
(default 64^3, 823,875 DOF) through the stencil forward (one
theta_sweep_batched launch per batched CG iteration of the chains), with
bench.py's observations (128 strongly deflected nodes x 3 directions, 1%
noise, from the forward at the truth). The record is appended to a run log
(utils/runlog.py) and printed as the last line.

Run:  python -m stan_tpu_torch.calib_large [--n 64] [--chains 4]
          [--samples 10] [--warmup 20] [--leapfrog 4] [--device cuda|cpu]
          [--runlog runlog.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--samples", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--leapfrog", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--runlog", default="runlog.jsonl",
                    help="the run log the record is appended to")
    args = ap.parse_args(argv)

    from stan_tpu_torch import bench
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.fem.operator import resolve_device
    from stan_tpu_torch.infer import calibrate, forward, hmc
    from stan_tpu_torch.utils import runlog

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"stan_tpu_torch.calib_large: {e}", file=sys.stderr)
        return 2
    n = args.n
    model = meshgen.hex_beam(n, n, n)
    true_theta = np.array([np.log(190000.0), 0.28, 0.0])
    fwd = forward.build_forward(model, device=dev, cg_tol=1e-6)
    if not isinstance(fwd, forward.StencilForwardProblem):
        raise RuntimeError(f"the {n}^3 beam took {type(fwd).__name__}")
    print(f"model {n}^3: ndof {3 * model.nnode}", flush=True)

    before = bench.launch_counts()
    t0 = time.time()
    u_true = forward.displacement_fn(fwd, model.nelem)(
        torch.as_tensor(true_theta, device=dev)).detach().cpu().numpy()
    print(f"forward solve OK in {time.time() - t0:.1f}s "
          f"(|u|max {np.abs(u_true).max():.3e})", flush=True)
    total = np.linalg.norm(u_true, axis=1)
    nodes = np.nonzero(total > 0.3 * total.max())[0][:128]
    obs_nodes = np.repeat(nodes, 3)
    obs_dirs = np.tile([0, 1, 2], len(nodes))
    rng = np.random.default_rng(0)
    sigma = 1e-2 * float(np.abs(u_true).max())
    y = u_true[obs_nodes, obs_dirs] + sigma * rng.normal(size=len(obs_nodes))
    prob = calibrate.make_problem(model, obs_nodes, obs_dirs, y, sigma,
                                  device=dev, cg_tol=1e-6)

    theta0 = torch.as_tensor(
        np.array([np.log(210000.0), 0.0, 0.0])[None]
        + 0.05 * np.random.default_rng(7).normal(size=(args.chains, 3)),
        device=dev)
    t0 = time.time()
    res = hmc.run_hmc(
        prob.log_posterior, theta0, 11, n_samples=args.samples,
        n_warmup=args.warmup, n_leapfrog=args.leapfrog, init_step=0.01,
        checkpoint_every=max(2, args.samples // 3),
        solve_stats=prob.fwd.stats)
    wall = time.time() - t0
    after = bench.launch_counts()
    cons = calibrate.CalibrationProblem.constrain(res.samples)
    rec = {
        "metric": f"hmc_calibration_{n}cubed",
        "ndof": int(3 * model.nnode),
        "n_chains": args.chains,
        "n_samples": args.samples,
        "wall_seconds": round(wall, 1),
        "warmup_seconds": round(res.warmup_seconds, 1),
        "samples_per_s_chip": round(
            args.chains * sum(res.chunk_sizes[1:])
            / max(sum(res.chunk_seconds[1:]), 1e-9), 4),
        "accept_rate": float(np.mean(res.accept_rate)),
        "posterior_E_mean": float(cons[..., 0].mean()),
        "posterior_nu_mean": float(cons[..., 1].mean()),
        "truth": {"E": 190000.0, "nu": 0.28},
        "unconverged_forward": res.unconverged_forward,
        "unconverged_adjoint": res.unconverged_adjoint,
        "launches": {k: after[k] - before[k] for k in bench.KERNELS},
        "device": bench.device_info(dev),
    }
    runlog.append(args.runlog, runlog.make_record("calib_large", **rec))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
