"""Launch counters of the port's hand-written kernels.

``counts[name]`` is the number of launches on CUDA tensors since the last
reset, one key per kernel wrapper (stencil_sweep, theta_sweep,
theta_sweep_batched in fem/stencil.py; general_apply in fem/operator.py,
one an apply of its two kernels). The sweeps also count under
``(name, is_low, is_high)``, their x-face flags. A replayed CUDA graph
launches its kernels without a wrapper call, so solvers/cg.py adds the
launches the graph holds at each replay (add).
"""

from __future__ import annotations

import collections

counts = collections.Counter()


def count(name: str, is_low=None, is_high=None) -> None:
    """One launch of the wrapper `name`; with a sweep's flags, also under
    (name, is_low, is_high)."""
    counts[name] += 1
    if is_low is not None:
        counts[name, int(bool(is_low)), int(bool(is_high))] += 1


def snapshot() -> collections.Counter:
    """A copy of the counters, to subtract from a later one."""
    return collections.Counter(counts)


def add(delta: dict, times: int = 1) -> None:
    """Add times x delta (snapshot's form) to the counters: the launches of
    a replayed CUDA graph, and (times=-1) the calls that recorded the
    graph, which launched nothing."""
    for key, n in delta.items():
        counts[key] += times * n


def reset() -> None:
    counts.clear()
