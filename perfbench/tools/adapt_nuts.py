"""Adapt the NUTS cell's fixed step size and diagonal inverse mass once,
with the program's own warmup, and print what the cell's traffic file
takes.

    python3 -m perfbench.tools.adapt_nuts [--cell calib32-nuts4]
        [--warmup 150] [--draws 16] [--device cuda] [--grid N N N]

It builds the cell's problem (observations with the noise of seed 0),
starts the cell's chains near the truth (the traffic's start_mean, 1e-3
times normal draws on the free coordinates, log s at 0), runs
``infer.nuts.run_nuts`` with the traffic's max_depth and log s held
(Stan's windowed warmup: at least 150 iterations close a mass window;
then a few draws), and prints one JSON line: the median step size and
inverse mass over the chains, the draws' mean and standard deviation per
parameter, the acceptance, the trees (TreeStats over warmup and draws)
and the solves that stopped at the cap.
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
    ap.add_argument("--cell", default="calib32-nuts4")
    ap.add_argument("--warmup", type=int, default=150)
    ap.add_argument("--draws", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, nargs=3)
    args = ap.parse_args(argv)
    from stan_tpu_torch.infer import nuts

    cell = harness.find_cell(args.cell)
    drv = harness.driver_class(cell.workload["driver"])(
        cell.config, cell.workload, 0, args.device,
        tracing.Spans(args.device), scale=args.grid)
    drv.problem()
    t = cell.workload["traffic"]
    held = np.asarray(t["inv_mass"]) == 0
    rng = np.random.default_rng(0)
    theta0 = torch.as_tensor(
        np.asarray(t["start_mean"])[None]
        + np.where(held, 0.0, 1e-3 * rng.normal(size=(t["chains"], 3))),
        device=args.device)
    trees = nuts.TreeStats()
    t0 = time.perf_counter()
    res = nuts.run_nuts(drv.prob.log_posterior, theta0, 0,
                        n_samples=args.draws, n_warmup=args.warmup,
                        max_depth=t["max_depth"], init_step=0.02,
                        solve_stats=drv.prob.fwd.stats, held=held,
                        stats=trees)
    flat = res.samples.reshape(-1, 3)
    print(json.dumps({
        "cell": args.cell, "warmup": args.warmup, "draws": args.draws,
        "seconds": time.perf_counter() - t0,
        "step": float(np.median(res.step_size)),
        "inv_mass": np.median(res.inv_mass, axis=0).tolist(),
        "mean": flat.mean(axis=0).tolist(), "sd": flat.std(axis=0).tolist(),
        "accept": float(np.mean(res.accept_rate)),
        "rhat": [None if np.isnan(r) else float(r) for r in res.rhat],
        "evals_per_sample": res.evals_per_sample.tolist(),
        "trees": trees.as_dict(), "solve_stats": res.solve_stats,
        "device": harness.device_info(args.device, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
