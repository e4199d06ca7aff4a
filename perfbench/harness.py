"""The benchmark's harness: one cell, one run, one result line.

Everything particular to a cell is data found by name:

  BENCHMARK.json                the cells, their chips, every metric and
                                which cells report it;
  perfbench/workloads/<cell>.json  the cell's configuration, driver, traffic
                                parameters and the limits of its check;
  perfbench/configs/<config>.json  the configuration's sizes;
  perfbench/drivers/<driver>.py    one kind of traffic (class Driver,
                                which declares its own rehearsal);
  perfbench/metrics/<metric>.py    one metric's reader, read(run) -> value
                                or None (nothing to read: left out).

A run: set-up (the driver builds the program's state from the seed and
warms the cell's shapes with one request; setup_s leaves out what the
reference computes there), the window, with set-up's objects frozen out
of the garbage collector's scans (requests one after
another until the given seconds have passed, then the one in flight is
finished; every rate is all the work over all the elapsed time), the check
for modules that must not be loaded, the device's peak memory, then with
--trace 1 a profiled slice of more requests, then the program's state is
released and the traffic driver's check compares what the window produced
with the plain reference. The last line of standard output is the result.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import sys
import time

import torch

from perfbench import tracing

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "stan_tpu"})


def forbidden_modules(names) -> list:
    """The forbidden top-level packages among module names, each compared
    whole by the part before its first dot (stan_tpu_torch is not
    stan_tpu)."""
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One cell with everything that its name leads to."""

    name: str
    entry: dict  # its line of BENCHMARK.json "workloads"
    workload: dict  # perfbench/workloads/<name>.json
    config: dict  # its configuration's file
    end_to_end: list  # the BENCHMARK.json metrics this cell reports
    per_layer: list


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether a metric is reported in `cell`: listed there, or, without a
    "workloads" key, wherever the end-to-end metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def find_cell(name: str, root=ROOT) -> Cell:
    bench = load_json(pathlib.Path(root) / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(pathlib.Path(root) / configs[entry["config"]]["file"])
    workload = load_json(pathlib.Path(root) / "perfbench" / "workloads"
                         / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, entry, workload, config, e2e, layer)


def _load(root, kind: str, name: str):
    """perfbench/<kind>/<name>.py under `root`, loaded by path (a name may
    hold dots, and a file added to a copy of the benchmark is found there)."""
    path = pathlib.Path(root) / "perfbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}._{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_class(name: str, root=ROOT):
    """perfbench/drivers/<name>.py's Driver: one kind of traffic, with its
    rehearsal (TINY, SMALL, FAULTS) declared on the class."""
    return _load(root, "drivers", name).Driver


def reader(metric: str, root=ROOT):
    """perfbench/metrics/<metric>.py's read function."""
    return _load(root, "metrics", metric).read


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: Cell
    setup_s: float
    window_s: float
    requests: list  # per request: "seconds" and the traffic driver's keys
    counters: dict  # the program's counters over the window
    spans: dict  # span name -> [seconds, ...]
    grid: tuple  # the beam's cells per axis, as run
    trace: dict = None  # tracing.profile's reduction (--trace 1)


def window(driver, seconds: float, device) -> tuple:
    """Requests until `seconds` have passed, then the one in flight;
    returns (the window's seconds, the requests' records)."""
    records = []
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        rec = driver.request(i)
        tracing.sync(device)
        t1 = time.perf_counter()
        rec["seconds"] = t1 - t0
        records.append(rec)
        i += 1
        if t1 - t_start >= seconds:
            return t1 - t_start, records


def device_info(device, count: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t0=None, variant: str = "program", scale=None,
             root=ROOT, notes: dict = None) -> tuple:
    """One run of the cell. Returns (exit code, result dict or None).

    variant: "program" (the measured run), or a control or fault that
    perfbench/tools and the tests put in the program's place. scale:
    a size override for rehearsals on the CPU (the traffic driver's
    "scale"). notes: a dict that gets the driver's readings beside the
    compared numbers (its "notes"), for perfbench/tools/readings.py."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = find_cell(name, root)
    spans = tracing.Spans(device, sync=trace)
    Driver = driver_class(cell.workload["driver"], root)
    drv = Driver(cell.config, cell.workload, seed, device, spans,
                 variant=variant, scale=scale)
    drv.setup()
    tracing.sync(device)
    drv.begin()
    spans.seconds.clear()
    setup_s = time.perf_counter() - t0 - drv.reference_s
    gc.freeze()  # set-up's objects leave the collector's scans
    try:
        window_s, records = window(drv, seconds, device)
    finally:
        gc.unfreeze()
    counters = drv.counters()
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"perfbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3, None
    info = device_info(device, cell.entry.get("chips", 1))
    run = Run(cell, setup_s, window_s, records, counters,
              {k: list(v) for k, v in spans.seconds.items()}, drv.grid)
    if trace:
        run.trace = tracing.profile(drv.profile, device)
        info["busy_s"] = run.trace["busy_s"]
        info["window_s"] = run.trace["window_s"]
    drv.release()
    checks = drv.check()
    if notes is not None:
        notes.update(getattr(drv, "notes", {}))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(lim is not None and math.isfinite(v) and v <= lim
                  for _, v, lim in checks)
    result = {"correct": correct,
              "attempted": sum(r["ops"] for r in records),
              "failed": sum(r["failed"] for r in records),
              "metrics": metrics, "device": info}
    if trace:
        result["breakdown"] = tracing.breakdown(run.trace)
    # A reading that is no number (a solve that broke down) goes out as null.
    result["checks"] = {n: {"value": v if math.isfinite(v) else None,
                            "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    return 0, result
