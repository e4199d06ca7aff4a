"""The program's PhaseTimer record keys over the window's solves, for the
metric readers: the parts a phase adds to its record (seconds of a named
span) and its counters. A program whose records lack a key reads None."""

from __future__ import annotations

from perfbench import readers


def _records(run, prefix: str, keys):
    """Every record of the window's solves whose phase starts with `prefix`
    and which holds all `keys`, by solve."""
    return [[r for r in recs if r["phase"].startswith(prefix)
             and all(k in r for k in keys)]
            for recs in run.counters.get("phases", ())]


def mean_per_solve(run, prefix: str, key: str):
    """Mean over the window's solves of `key` summed over the solve's phases
    that start with `prefix`; None where no phase holds it."""
    return readers.mean([sum(r[key] for r in recs)
                         for recs in _records(run, prefix, (key,)) if recs])


def totals(run, prefix: str, *keys):
    """Each of `keys` summed over every phase that starts with `prefix` and
    holds them all, over the window; None where none does."""
    recs = [r for by_solve in _records(run, prefix, keys) for r in by_solve]
    if not recs:
        return None
    return tuple(sum(r[k] for r in recs) for k in keys)
