"""Arithmetic that several metric readers share."""

from __future__ import annotations

import numpy as np


def mean(values):
    return float(np.mean(values)) if values else None


def percentile(values, q: float) -> float:
    return float(np.percentile(values, q))


def _records(run, prefix: str, keys):
    """Every PhaseTimer record of the window's solves whose phase starts
    with `prefix` and which holds all `keys`, by solve."""
    return [[r for r in recs if r["phase"].startswith(prefix)
             and all(k in r for k in keys)]
            for recs in run.counters.get("phases", ())]


def phase_mean(run, prefix: str, key: str = "seconds"):
    """Mean over the window's solves of `key` (a phase's seconds, or a part
    or counter it adds to its record) summed over the solve's phases whose
    name starts with `prefix`; None where no such phase holds it."""
    return mean([sum(r[key] for r in recs)
                 for recs in _records(run, prefix, (key,)) if recs])


def totals(run, prefix: str, *keys):
    """Each of `keys` summed over every phase that starts with `prefix` and
    holds them all, over the window; None where none does."""
    recs = [r for by_solve in _records(run, prefix, keys) for r in by_solve]
    if not recs:
        return None
    return tuple(sum(r[k] for r in recs) for k in keys)


def idle_percent(run):
    """100 (1 - busy / wall) of the traced slice; None without a trace or
    without device activity in it."""
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def roofline_percent(run, kernel: str, bound_s: float):
    """100 bound / (device seconds per launch) over the traced launches of
    the device operations whose name holds `kernel`; None without any."""
    if run.trace is None:
        return None
    hits = [v for n, v in run.trace["kernels"].items() if kernel in n]
    launches = sum(v[0] for v in hits)
    if not launches:
        return None
    return 100.0 * bound_s / (sum(v[1] for v in hits) / launches)
