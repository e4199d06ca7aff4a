"""Adapt the calibration cells' fixed step size and diagonal inverse mass
once, with the program's own warmup, and print what the cells' traffic
files take.

    python3 -m perfbench.tools.adapt [--cell calib32-hmc16] [--warmup 64]
        [--draws 16] [--device cuda] [--grid N N N]

It builds the cell's problem (observations with the noise of seed 0),
starts the cell's chains near the truth (the traffic's start_mean, 1e-3
times normal draws), runs ``infer.hmc.run_hmc`` (Stan's windowed warmup,
then a few draws), and prints one JSON line: the median step size and
inverse mass over the chains, the draws' mean and standard deviation per
parameter, the acceptance and the solves that stopped at the cap.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from perfbench import harness, tracing  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", default="calib32-hmc16")
    ap.add_argument("--warmup", type=int, default=64)
    ap.add_argument("--draws", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, nargs=3)
    args = ap.parse_args(argv)
    from stan_tpu_torch.infer import hmc

    cell = harness.find_cell(args.cell)
    drv = harness.driver_class(cell.workload["driver"])(
        cell.config, cell.workload, 0, args.device,
        tracing.Spans(args.device), scale=args.grid)
    drv.problem()
    t = cell.workload["traffic"]
    rng = np.random.default_rng(0)
    theta0 = torch.as_tensor(
        np.asarray(t["start_mean"])[None]
        + 1e-3 * rng.normal(size=(t["chains"], 3)), device=args.device)
    t0 = time.perf_counter()
    res = hmc.run_hmc(drv.prob.log_posterior, theta0, 0,
                      n_samples=args.draws, n_warmup=args.warmup,
                      n_leapfrog=t["n_leapfrog"], init_step=0.02,
                      solve_stats=drv.prob.fwd.stats)
    flat = res.samples.reshape(-1, 3)
    print(json.dumps({
        "cell": args.cell, "warmup": args.warmup, "draws": args.draws,
        "seconds": time.perf_counter() - t0,
        "step": float(np.median(res.step_size)),
        "inv_mass": np.median(res.inv_mass, axis=0).tolist(),
        "mean": flat.mean(axis=0).tolist(), "sd": flat.std(axis=0).tolist(),
        "accept": float(np.mean(res.accept_rate)),
        "rhat": res.rhat.tolist(), "solve_stats": res.solve_stats,
        "device": harness.device_info(args.device, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
