"""One module per kind of traffic, each with a class Driver (see Base)."""

import contextlib
import time

import torch

from perfbench import tracing


class Base:
    """What the harness calls on a driver: setup() builds the program's
    state from the seed and warms the cell's shapes; begin() marks the
    window's start; request(i) runs one request and returns {"ops",
    "failed", ...}; counters() gives the program's counters over the
    window; profile() runs the slice that --trace 1 profiles; release()
    frees the program's state; check() returns [(name, value, limit)].
    Work of the reference inside setup() (making the inputs) runs under
    reference_time(), which setup_s leaves out.

    variant: "program", or a control or fault put in the program's place
    (perfbench/tools/readings.py, the tests); scale: the beam's cells per
    axis instead of the configuration's (rehearsals on the CPU).

    Each Driver declares its own rehearsal (perfbench/tests), with no
    default here: TINY, the cells per axis of its runs on the CPU; SMALL,
    those of its control on a card; FAULTS, the variants that break its
    timed path, each of which the check has to find."""

    def __init__(self, config, workload, seed, device, spans, *,
                 variant="program", scale=None):
        self.cfg, self.t = config, workload["traffic"]
        self.limits = workload["limits"]
        self.seed, self.device, self.spans = seed, torch.device(device), spans
        self.variant = variant
        self.grid = tuple(scale or config["grid"])

    reference_s = 0.0

    @contextlib.contextmanager
    def reference_time(self):
        """Time the reference's part of set-up (reference_s) and free what
        it left on the device, resetting the device's peak, so that
        memory_peak_bytes is the program's."""
        tracing.sync(self.device)
        t0 = time.perf_counter()
        yield
        tracing.sync(self.device)
        self.reference_s += time.perf_counter() - t0
        self.empty_cache()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def begin(self):
        pass

    def counters(self):
        return {}

    def empty_cache(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
