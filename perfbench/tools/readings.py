"""Read a cell's compared numbers on many seeds in one process: the
program's (the lower readings of its limits) and those of a control or a
fault put in the program's place (the upper readings).

    python3 -m perfbench.tools.readings --cell NAME --variant program
        --seeds S ... --seconds SECONDS [--device cuda] [--grid N N N]

Each seed is one run of the cell as perfbench/run.py makes it (set-up,
window, check), with a short window; each prints one JSON line: the
variant, the seed, every compared number with its limit, the driver's
further readings ("notes"), the run's metrics, attempted and failed, and
its seconds.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--variant", default="program")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, nargs=3)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        notes = {}
        try:
            code, res = harness.run_cell(
                args.cell, seed, args.seconds, bool(args.trace),
                device=args.device, variant=args.variant, scale=args.grid,
                notes=notes)
        except Exception as e:  # a control that crashes has failed: say so
            print(json.dumps({"cell": args.cell, "variant": args.variant,
                              "seed": seed, "error": f"{type(e).__name__}: {e}"}),
                  flush=True)
            continue
        print(json.dumps({"cell": args.cell, "variant": args.variant,
                          "seed": seed, "code": code,
                          "seconds": time.perf_counter() - t0, "notes": notes,
                          **(res or {})}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
