# Copied from stan_tpu/utils/runlog.py; _coerce also reads torch tensors.
"""Structured run records: machine-readable observability (SURVEY.md §5.5).

The reference's observability is Console.Write* only: a banner, the
database summary (Database.cs:123-133), per-phase "Done in Xs" lines and
ALGLIB termination codes (SolverFunctions.cs:15-46,305-327). This module
keeps the human-readable console output (utils/timing.PhaseTimer) and adds
a JSON-lines record per run: model counts, solver settings, per-phase
timings, iteration/residual stats, sampler statistics (samples/s,
acceptance, R-hat) — appended to a file so long campaigns accumulate a
queryable history.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from stan_tpu_torch.utils.timing import PhaseTimer

SCHEMA_VERSION = 1


def make_record(kind: str, *, model=None, timer: Optional[PhaseTimer] = None,
                **fields) -> Dict[str, Any]:
    """Assemble one run record. ``kind`` is e.g. "solve" or "calibrate"."""
    rec: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "kind": kind,
        "unix_time": time.time(),
        "pid": os.getpid(),
    }
    if model is not None:
        rec["model"] = {
            "nnode": int(model.nnode),
            "nelem": int(model.nelem),
            "ndof": int(model.ndof),
            "analysis": {
                "type": model.analysis.type,
                "solver": model.analysis.lin_solver,
                "tolerance": float(model.analysis.lin_solver_tolerance),
                "maxiter": int(model.analysis.lin_solver_maxiter),
                "increments": int(model.analysis.inc_numb),
            },
        }
    if timer is not None:
        rec["phases"] = list(timer.records)
        rec["total_seconds"] = timer.total()
    rec.update(fields)
    return rec


def append(path: str, record: Dict[str, Any]) -> None:
    """Append one JSON line (creates parent dirs as needed)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(record, default=_coerce) + "\n")


def _coerce(obj):
    """JSON fallback for numpy scalars and arrays and torch tensors.

    A tensor's ``size`` is a method, so the reference's ``size == 1`` test
    would fall through to ``str(tensor)``: tensors are read by numel."""
    import numpy as np
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.item() if obj.numel() == 1 else obj.tolist()
    if hasattr(obj, "item") and getattr(obj, "size", 2) == 1:
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)
