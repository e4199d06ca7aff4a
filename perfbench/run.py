"""Run one cell of the benchmark of stan_tpu_torch and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cells are BENCHMARK.json's "workloads"; perfbench/harness.py says
what a run does. The last line of standard output is one JSON object
(correct, attempted, failed, metrics, device; with --trace 1 breakdown;
checks last), and the numbers that decided "correct" are the last lines of
standard error. Exit codes: 0 a result was printed; 2 no card, or fewer
cards than the cell asks for; 3 a forbidden module was loaded; 1 anything
else. Nothing is printed as a result in those cases.

Every cache the program builds stays in the checkout at a fixed path:
its kernels in stan_tpu_torch/_build/, and TORCH_EXTENSIONS_DIR,
TRITON_CACHE_DIR and CUDA_CACHE_PATH under .bench_cache/.

The run keeps to HOST_CORES fixed cores (the last of those it may use)
with as many torch and OpenMP threads, and OpenMP threads that sleep
rather than spin while they wait, so that every run has the same host
resources on any machine.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HOST_CORES = 4
CORES = sorted(os.sched_getaffinity(0))[-HOST_CORES:]
os.sched_setaffinity(0, CORES)  # before any thread starts: all inherit it
os.environ.update(OMP_NUM_THREADS=str(len(CORES)), OMP_WAIT_POLICY="PASSIVE",
                  OMP_PROC_BIND="close", OMP_PLACES="cores")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    torch.set_num_threads(len(CORES))

    chips = harness.find_cell(args.workload).entry.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    code, result = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), device="cuda", t0=T0)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"perfbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    if result is None:
        return code
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
