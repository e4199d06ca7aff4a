# Copied from stan_tpu/utils/checkpoint.py; the port keeps its own copy.
"""Checkpoint / resume: pytree snapshots for long solves and samplers.

The reference's only checkpoint is the STdb file itself (the solver
overwrites its input with results, Solver.cs:454-462; no mid-solve resume —
SURVEY.md §5.4). Here long-running components checkpoint their live state:

  * nonlinear statics: per-increment (u, increment index) so a killed run
    resumes at the last completed increment (analysis/nonlinear.py);
  * HMC/NUTS: post-warmup tuned state and periodic chain snapshots
    (positions, step sizes, mass matrices, RNG keys) (infer/hmc.py).

Format: a single .npz holding the flattened leaves plus a JSON treedef
descriptor — no framework dependency, atomic via write-to-temp + rename.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

import numpy as np


def _flatten(tree: Any, prefix: str, leaves: dict, spec: dict) -> None:
    if isinstance(tree, dict):
        spec["kind"] = "dict"
        spec["keys"] = sorted(tree.keys())
        spec["children"] = {}
        for k in spec["keys"]:
            spec["children"][k] = {}
            _flatten(tree[k], f"{prefix}.{k}", leaves, spec["children"][k])
    elif isinstance(tree, (list, tuple)):
        spec["kind"] = "list" if isinstance(tree, list) else "tuple"
        spec["children"] = []
        for i, v in enumerate(tree):
            child = {}
            _flatten(v, f"{prefix}.{i}", leaves, child)
            spec["children"].append(child)
    elif tree is None:
        spec["kind"] = "none"
    elif isinstance(tree, (str,)):
        spec["kind"] = "str"
        spec["value"] = tree
    elif isinstance(tree, (bool, np.bool_)):
        spec["kind"] = "bool"
        spec["value"] = bool(tree)
    elif isinstance(tree, (int, np.integer)):
        spec["kind"] = "int"
        spec["value"] = int(tree)
    elif isinstance(tree, (float, np.floating)):
        spec["kind"] = "float"
        spec["value"] = float(tree)
    else:
        # array leaf (numpy or jax)
        spec["kind"] = "array"
        spec["name"] = prefix
        leaves[prefix] = np.asarray(tree)


def _unflatten(spec: dict, leaves: dict) -> Any:
    kind = spec["kind"]
    if kind == "dict":
        return {k: _unflatten(spec["children"][k], leaves) for k in spec["keys"]}
    if kind in ("list", "tuple"):
        vals = [_unflatten(c, leaves) for c in spec["children"]]
        return vals if kind == "list" else tuple(vals)
    if kind == "none":
        return None
    if kind in ("str", "int", "float", "bool"):
        return spec["value"]
    return leaves[spec["name"]]


def save(path: str, tree: Any) -> None:
    """Atomically write a pytree (dicts/lists/tuples/scalars/arrays)."""
    leaves: dict = {}
    spec: dict = {}
    _flatten(tree, "root", leaves, spec)
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        np.savez(tmp, __spec__=json.dumps(spec), **leaves)
        # np.savez appends .npz to the filename
        os.replace(tmp + ".npz", path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load(path: str) -> Any:
    """Load a pytree written by save(); raises FileNotFoundError if absent."""
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(str(z["__spec__"]))
        leaves = {k: z[k] for k in z.files if k != "__spec__"}
    return _unflatten(spec, leaves)


def load_or_none(path: Optional[str]) -> Any:
    if not path or not os.path.exists(path):
        return None
    try:
        return load(path)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Append-only chunk sidecars
#
# Long samplers accumulate draws in fixed-size chunks. Rewriting one
# ever-growing array every chunk costs O(n^2) cumulative write traffic over
# a run; instead each chunk is written ONCE to its own sidecar file next to
# the main (small) state checkpoint, which only records how many chunks
# exist. Total write traffic is O(n).
# ---------------------------------------------------------------------------

def chunk_path(path: str, idx: int) -> str:
    return f"{path}.chunk{idx:05d}.npz"


def save_chunk(path: str, idx: int, array) -> None:
    """Write one draw chunk (atomic, write-once)."""
    save(chunk_path(path, idx), {"chunk": np.asarray(array)})


def load_chunks(path: str, n_chunks: int) -> list:
    """Load chunk sidecars 0..n_chunks-1; raises if any is missing."""
    return [load(chunk_path(path, i))["chunk"] for i in range(n_chunks)]


def clean_chunks(path: str) -> int:
    """Remove every chunk sidecar belonging to `path`.

    Called when a run starts fresh over an old checkpoint (identity
    mismatch or corrupt state): stale sidecars from the previous run would
    otherwise accumulate forever and could be picked up by a later resume
    whose n_chunks happens to match (ADVICE r2). Returns how many files
    were removed.
    """
    import glob

    n = 0
    for p in glob.glob(f"{glob.escape(path)}.chunk[0-9][0-9][0-9][0-9][0-9].npz"):
        try:
            os.remove(p)
            n += 1
        except OSError:
            pass
    return n
