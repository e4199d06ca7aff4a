"""Arithmetic that several metric readers share."""

from __future__ import annotations

import numpy as np


def mean(values):
    return float(np.mean(values)) if values else None


def percentile(values, q: float) -> float:
    return float(np.percentile(values, q))


def phase_mean(run, prefix: str):
    """Mean seconds per solve of the PhaseTimer phase whose name starts
    with `prefix`, over the window's solves; None without such phases."""
    per_solve = [sum(r["seconds"] for r in recs
                     if r["phase"].startswith(prefix))
                 for recs in run.counters.get("phases", ())
                 if any(r["phase"].startswith(prefix) for r in recs)]
    return mean(per_solve)


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
