"""Phase timing: a per-phase wall-time table plus a machine-readable record.

Port of stan_tpu/utils/timing.py with the same phase()/records/summary()
API. Where CUDA is in use, each phase edge synchronises the device, so a
phase's time includes the device work it queued, and each phase is an
NVTX range (the counterpart of the JAX package's profiler annotations).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    def __init__(self, verbose: bool = True):
        self.records: List[Dict] = []
        self.verbose = verbose

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        _sync()
        t0 = time.perf_counter()
        with (torch.cuda.nvtx.range(name) if torch.cuda.is_available()
              else contextlib.nullcontext()):
            yield
            _sync()
        dt = time.perf_counter() - t0
        self.records.append({"phase": name, "seconds": dt, **meta})
        if self.verbose:
            print(f"   {name + ':':<28s} Done in {dt:.2f}s")

    def total(self) -> float:
        return sum(r["seconds"] for r in self.records)

    def summary(self) -> str:
        sep = "  ========================================================== "
        lines = [sep]
        for r in self.records:
            extra = ", ".join(
                f"{k}={v}" for k, v in r.items() if k not in ("phase", "seconds")
            )
            lines.append(
                f"   {r['phase']:<24s} {r['seconds']:>9.2f} s"
                + (f"   [{extra}]" if extra else "")
            )
        lines.append(f"   {'Total':<24s} {self.total():>9.2f} s")
        lines.append(sep)
        return "\n".join(lines)
