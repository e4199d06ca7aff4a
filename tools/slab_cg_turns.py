#!/usr/bin/env python3
"""Time the one-process x-slab CG of chip_smoke.py's phase 19 in two or
more checkouts of stan_tpu_torch, in turns within one process, on one card.

Each checkout named on the command line (a directory holding
stan_tpu_torch/) is imported under the package's own name, its modules
kept apart and put back into sys.modules before each of its turns, so
that every checkout runs its own code. Each builds and loads its kernels
and its operators for hex_beam(71, 70, 70) (NNX = 72), float32. Then, for
--rounds rounds, every checkout in turn (the order reversed every other
round) solves to 1e-6 on one device and on a 1 x 4 mesh of [cuda:0] * 4
(sharded_stencil_pcg), each timed on the host clock from a synchronised
card to its end. Prints each checkout's ms per CG iteration (median and
quartiles over the rounds), its iterations and a SHA-256 of each u, then
one JSON line of every reading with the card's name and power limit. Run
from the repository root, for example against a parent checkout unpacked
by `git archive`:

  python3 tools/slab_cg_turns.py _archive/parent .
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

PACKAGE = "stan_tpu_torch"


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def ours(name: str) -> bool:
    return name == PACKAGE or name.startswith(PACKAGE + ".")


def load(tree: str) -> dict:
    """The checkout's modules (imported afresh) and its runs."""
    import torch

    for name in [n for n in sys.modules if ours(n)]:
        del sys.modules[name]
    sys.path.insert(0, tree)
    try:
        pkg = importlib.import_module(PACKAGE)
        assert pkg.__file__.startswith(tree), pkg.__file__
        build = importlib.import_module(PACKAGE + "._build")
        meshgen = importlib.import_module(PACKAGE + ".core.meshgen")
        stencil = importlib.import_module(PACKAGE + ".fem.stencil")
        distributed = importlib.import_module(PACKAGE +
                                              ".parallel.distributed")
        ss = importlib.import_module(PACKAGE + ".parallel.sharded_stencil")
        cg = importlib.import_module(PACKAGE + ".solvers.cg")
    finally:
        sys.path.remove(tree)
    for name in build.build():
        build.library(name)
    model = meshgen.hex_beam(71, 70, 70)
    sop = stencil.build_stencil_operator(model, dtype=torch.float32,
                                         device="cuda")
    op = ss.build_sharded_stencil_operator(model, 4, dtype=torch.float32,
                                           device="cuda")
    mesh = distributed.device_mesh(1, 4, devices=["cuda:0"] * 4)
    f = sop.to_grid(torch.as_tensor(model.load_vector(), dtype=torch.float32,
                                    device="cuda")).contiguous()
    rhs = (sop.free_mask * f).contiguous()
    diag = sop.diagonal()
    runs = {"single": lambda: cg.pcg(sop.apply, rhs, diag=diag, tol=1e-6),
            "sharded": lambda: ss.sharded_stencil_pcg(mesh, op, f,
                                                      tol=1e-6)}
    return {"modules": {n: m for n, m in sys.modules.items() if ours(n)},
            "runs": runs}


def main(argv) -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--rounds", type=int, default=20)
    args = parser.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    loaded = {t: load(t) for t in trees}
    got = {t: {k: {"ms_per_iteration": [], "iters": set(),
                   "u_sha256": set()} for k in ("single", "sharded")}
           for t in trees}
    for rnd in range(-1, args.rounds):  # round -1: first use, not kept
        for t in (trees if rnd % 2 == 0 else trees[::-1]):
            sys.modules.update(loaded[t]["modules"])
            for name, run in loaded[t]["runs"].items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                if rnd < 0:
                    continue
                g = got[t][name]
                g["ms_per_iteration"].append(secs / res.iters * 1e3)
                g["iters"].add(int(res.iters))
                g["u_sha256"].add(hashlib.sha256(np.ascontiguousarray(
                    res.u.cpu().numpy()).tobytes()).hexdigest())
    readings = []
    for t, tree in zip(trees, args.trees):
        row = {"tree": tree}
        for name, g in got[t].items():
            ms = g["ms_per_iteration"]
            q1, med, q3 = statistics.quantiles(ms, n=4)
            row[name] = {"ms_per_iteration": ms, "median": med,
                         "quartiles": [q1, q3], "iters": sorted(g["iters"]),
                         "u_sha256": sorted(g["u_sha256"])}
            print(f"{tree} {name}: {row[name]['iters']} iterations, ms per "
                  f"iteration median {med:.4f} (quartiles {q1:.4f}, "
                  f"{q3:.4f}) over {len(ms)} rounds, u "
                  f"{' '.join(h[:16] for h in row[name]['u_sha256'])}")
        readings.append(row)
    print(json.dumps({"card": card(), "rounds": args.rounds,
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
