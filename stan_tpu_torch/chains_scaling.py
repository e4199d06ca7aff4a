"""Chain-placement scaling on a mesh of eight entries: the counterpart of the
JAX package's tools/chains_scaling.py.

HMC on the stencil forward's calibration posterior of an n^3 beam, in
float64 at cg_tol 1e-8, run three times: 1 chain; 8 chains placed over an
8 x 1 device mesh (make_problem(mesh=), run_hmc(mesh=): each row's one
chain evaluated on its row's device, the rows one after another from this
process's host thread, DeviceMesh.by_rows); 8 chains unplaced (one batch
on one device). Each run once untimed, then once timed. The record:

    scaling_efficiency = (samples/s per chain at 8 chains placed)
                       / (samples/s per chain at 1 chain)
    sharded_vs_vmap    = unplaced 8-chain seconds / placed 8-chain seconds

under the reference's keys, beside the card's name and power limit, each
timed run's launches of the three kernels, torch's thread count and the
mesh's distinct devices. The mesh stands in for the reference's eight
virtual CPU devices: ["cpu"] * 8 with --device cpu; with --device cuda the
8 rows take the visible cards round-robin ([cuda:0] * 8 on a one-card
host). The untimed runs are short (at most WARM_LENGTHS): they absorb the
kernels' build and first loads, and nothing of the port compiles per
shape. The record is appended to a run log (utils/runlog.py) and printed as
the last line; --json-out writes it to a file as well, never to the
repository's SCALING.json (the reference's recorded figure).

Run:  python -m stan_tpu_torch.chains_scaling [--grid 6] [--n-samples 20]
          [--n-warmup 20] [--n-leapfrog 4] [--device cuda|cpu]
          [--runlog runlog.jsonl] [--json-out PATH]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

ROWS = 8
SEED = 3
SIGMA = 1e-5
CG_TOL = 1e-8
INIT_STEP = 0.02
TRUE_THETA = np.array([np.log(190000.0), 0.28, 0.0])
THETA0 = np.array([np.log(210000.0), 0.0, 0.0])
# (warmup, draws) of the untimed runs, cut to the timed lengths.
WARM_LENGTHS = (2, 2)
RECORDED = pathlib.Path(__file__).resolve().parent.parent / "SCALING.json"
# Each run's chain count and whether its chains are placed over the mesh.
RUNS = {"1chain": (1, False), "8chains_placed": (ROWS, True),
        "8chains_unplaced": (ROWS, False)}


def posterior_inputs(grid: int, dev):
    """tools/chains_scaling.py's model and observations: hex_beam(grid,
    grid, grid) through the stencil forward (float64, cg_tol CG_TOL), the
    first 64 nodes whose |u| at the truth exceeds 0.3 of its largest, x 3
    directions, with noise of SIGMA from default_rng(0). Returns (model,
    obs_nodes, obs_dirs, y)."""
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.infer import forward

    model = meshgen.hex_beam(grid, grid, grid)
    fwd = forward.build_forward(model, dtype=torch.float64, device=dev,
                                cg_tol=CG_TOL)
    if not isinstance(fwd, forward.StencilForwardProblem):
        raise RuntimeError(f"the {grid}^3 beam took {type(fwd).__name__}")
    u_true = forward.displacement_fn(fwd, model.nelem)(
        torch.as_tensor(TRUE_THETA, dtype=fwd.dtype, device=fwd.device)
    ).detach().cpu().numpy()
    total = np.linalg.norm(u_true, axis=1)
    nodes = np.nonzero(total > 0.3 * total.max())[0][:64]
    obs_nodes = np.repeat(nodes, 3)
    obs_dirs = np.tile([0, 1, 2], len(nodes))
    rng = np.random.default_rng(0)
    y = u_true[obs_nodes, obs_dirs] + SIGMA * rng.normal(size=len(obs_nodes))
    return model, obs_nodes, obs_dirs, y


def row_mesh(dev: torch.device):
    """The ROWS x 1 mesh that stands in for the reference's virtual
    devices: ["cpu"] * ROWS on the CPU, else the visible cards taken
    round-robin from dev's."""
    from stan_tpu_torch.parallel import distributed

    if dev.type == "cpu":
        devices = ["cpu"] * ROWS
    else:
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", (dev.index + r) % n)
                   for r in range(ROWS)]
    return distributed.device_mesh(ROWS, 1, devices=devices)


def distinct_devices(mesh) -> list:
    return [str(d) for d in dict.fromkeys(mesh.devices.flat)]


def platform(mesh) -> str:
    kind = mesh.home.type
    if kind == "cpu":
        return "cpu-mesh"
    n = len(distinct_devices(mesh))
    return f"{kind}-mesh-{n}-card{'s' if n > 1 else ''}"


def measure(grid: int = 6, n_samples: int = 20, n_warmup: int = 20,
            n_leapfrog: int = 4, device="cuda") -> tuple:
    """The three runs, each untimed then timed. Returns (the record, the
    timed runs' HMCResults by RUNS name)."""
    from stan_tpu_torch import bench
    from stan_tpu_torch.fem.operator import resolve_device
    from stan_tpu_torch.infer import calibrate, hmc
    from stan_tpu_torch.parallel import distributed

    dev = distributed.canonical(resolve_device(device))
    f64 = torch.float64
    model, obs_nodes, obs_dirs, y = posterior_inputs(grid, dev)
    obs = (obs_nodes, obs_dirs, y, SIGMA)
    mesh = row_mesh(dev)
    probs = {False: calibrate.make_problem(
                 model, *obs, dtype=f64, device=dev, cg_tol=CG_TOL),
             True: calibrate.make_problem(
                 model, *obs, dtype=f64, mesh=mesh, cg_tol=CG_TOL)}
    warm = (min(WARM_LENGTHS[0], n_warmup), min(WARM_LENGTHS[1], n_samples))

    def run(name, lengths):
        n_chains, placed = RUNS[name]
        prob = probs[placed]
        theta0 = torch.as_tensor(np.tile(THETA0, (n_chains, 1)), device=dev)
        t0 = time.perf_counter()
        res = hmc.run_hmc(prob.log_posterior, theta0, SEED,
                          n_warmup=lengths[0], n_samples=lengths[1],
                          n_leapfrog=n_leapfrog, init_step=INIT_STEP,
                          solve_stats=prob.fwd.stats,
                          mesh=mesh if placed else None)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t0

    for name in RUNS:
        run(name, warm)
    results, seconds, launches = {}, {}, {}
    for name in RUNS:
        before = bench.launch_counts()
        results[name], seconds[name] = run(name, (n_warmup, n_samples))
        after = bench.launch_counts()
        launches[name] = {k: after[k] - before[k] for k in bench.KERNELS}
    sps1 = n_samples / seconds["1chain"]
    sps8 = ROWS * n_samples / seconds["8chains_placed"]
    sps8u = ROWS * n_samples / seconds["8chains_unplaced"]
    gap = (results["8chains_placed"].samples
           - results["8chains_unplaced"].samples)
    rec = {
        "metric": f"hmc_chains_scaling_{dev.type}_mesh",
        "measured_at": datetime.datetime.now().isoformat(timespec="seconds"),
        "grid": grid,
        "ndof": int(3 * model.nnode),
        "n_samples": n_samples,
        "n_leapfrog": n_leapfrog,
        "samples_per_s_1chain": sps1,
        "samples_per_s_8chains_8dev": sps8,
        "samples_per_s_8chains_vmap_1dev": sps8u,
        "scaling_efficiency": (sps8 / ROWS) / sps1,
        "sharded_vs_vmap": seconds["8chains_unplaced"]
        / seconds["8chains_placed"],
        "accept_rate_mean": float(np.mean(
            results["8chains_placed"].accept_rate)),
        "devices": ROWS,
        "platform": platform(mesh),
        "n_warmup": n_warmup,
        "warm_up_lengths": list(warm),
        "dtype": "float64",
        "cg_tol": CG_TOL,
        "seconds": seconds,
        "unconverged": {k: [r.unconverged_forward, r.unconverged_adjoint]
                        for k, r in results.items()},
        "placed_vs_unplaced_max_abs": float(np.max(np.abs(gap))),
        "mesh_devices": distinct_devices(mesh),
        "torch_threads": torch.get_num_threads(),
        "launches": launches,
        "device": bench.device_info(dev),
    }
    return rec, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=6,
                    help="elements per edge of the hex beam (default 6)")
    ap.add_argument("--n-samples", type=int, default=20)
    ap.add_argument("--n-warmup", type=int, default=20)
    ap.add_argument("--n-leapfrog", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--runlog", default="runlog.jsonl",
                    help="the run log the record is appended to")
    ap.add_argument("--json-out", default="",
                    help="also write the record to this file (never the "
                         "repository's SCALING.json)")
    args = ap.parse_args(argv)
    if args.json_out and (os.path.realpath(args.json_out)
                          == os.path.realpath(RECORDED)):
        ap.error(f"--json-out {args.json_out} is the reference's recorded "
                 f"figure ({RECORDED.name}); write elsewhere")

    from stan_tpu_torch.fem.operator import resolve_device
    from stan_tpu_torch.utils import runlog

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"stan_tpu_torch.chains_scaling: {e}", file=sys.stderr)
        return 2
    rec, _ = measure(args.grid, args.n_samples, args.n_warmup,
                     args.n_leapfrog, dev)
    runlog.append(args.runlog, runlog.make_record("chains_scaling", **rec))
    line = json.dumps(rec)
    print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
