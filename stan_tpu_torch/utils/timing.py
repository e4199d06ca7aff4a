"""Phase timing and the program's spans.

Port of stan_tpu/utils/timing.py with the same phase()/records/summary()
API. Where CUDA is in use, each phase edge synchronises the device, so a
phase's time includes the device work it queued.

span(name) is the program's one span: while a torch.profiler session
records, it is a record_function annotation, so it lands on the same
timeline as the kernels and copies it queued (the counterpart of the JAX
package's profiler annotations); otherwise it is a shared null context and
costs one flag read. Every phase is a span, and so is every part of a
phase (PhaseTimer.part), which also adds its host seconds to the phase's
record without synchronising. To see the spans, run any call under
``torch.profiler.profile`` and export a Chrome trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch
from torch.autograd import profiler as _autograd_profiler

_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler annotation named `name` while a profiler records, else a
    null context (record_function costs microseconds even when nothing
    records, so it is entered only then)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    def __init__(self, verbose: bool = True):
        self.records: List[Dict] = []
        self.verbose = verbose
        self._parts: List[Dict] = []  # the parts of each open phase

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        _sync()
        parts = {}
        self._parts.append(parts)
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
                _sync()
        finally:
            self._parts.pop()
        dt = time.perf_counter() - t0
        self.records.append({"phase": name, "seconds": dt, **meta, **parts})
        if self.verbose:
            print(f"   {name + ':':<28s} Done in {dt:.2f}s")

    @contextlib.contextmanager
    def part(self, name: str, key: str):
        """span(name), whose host seconds (no sync) add up under `key` in the
        innermost open phase's record; it appends no record of its own."""
        t0 = time.perf_counter()
        with span(name):
            yield
        if self._parts:
            parts = self._parts[-1]
            parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0

    def total(self) -> float:
        return sum(r["seconds"] for r in self.records)

    def summary(self) -> str:
        sep = "  ========================================================== "
        lines = [sep]
        for r in self.records:
            extra = ", ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in r.items() if k not in ("phase", "seconds")
            )
            lines.append(
                f"   {r['phase']:<24s} {r['seconds']:>9.2f} s"
                + (f"   [{extra}]" if extra else "")
            )
        lines.append(f"   {'Total':<24s} {self.total():>9.2f} s")
        lines.append(sep)
        return "\n".join(lines)
