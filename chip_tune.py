#!/usr/bin/env python3
"""Launch-shape probe of stencil_sweep (csrc/stencil_sweep.cu) on one GPU.

Each shape is R,THREADS,PAD,MAX_TZ,BLOCKS_PER_SM,EDGE: the fields of the
source's Shape<float> or Shape<double> (what they mean is written there).
For every shape asked for, the script writes a copy of csrc/ whose Shape
line of that type holds it, builds it with the port's nvcc flags (one
nvcc per shape, up to eight at a time) into stan_tpu_torch/_build/tune/,
prints the assembler's register report, checks the kernel against
stencil_sweep_reference (the 70^3 tables on [3,73,73,73], one x-plane of
the 32^3 grid and the 6x9x140 beam, four flag pairs, random ghosts, the
tolerances of chip_smoke.py) and then times every shape and the committed
kernel at [3,73,73,73] (the 70^3 solve's shape) from CUDA-graph replays,
in turns, twice. Ends with one JSON line of the readings.

--cut (a diagnostic; no checks): start, fetched or filled make every block
of every shape return at its start, once its first planes have arrived,
or once its slots are filled too (the time of the launch alone, and of
each block's fixed costs before its first group); noface skips the face
planes' corrections and nogroup the groups' sweeps (the time of the rest).

Run from the repository root:
  python3 chip_tune.py --f32 4,256,2,128,2,4 --f64 3,128,2,40,4,0 ...
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke
from stan_tpu_torch import _build

FIELDS = ("R", "THREADS", "PAD", "MAX_TZ", "BLOCKS_PER_SM", "EDGE")
CTYPE = {"f32": "float", "f64": "double"}
# --cut: (a line of sweep_tile.cuh, what goes before it).
CUTS = {
    "start": ("  constexpr int NP = 2 * R + 2;  // ring slots",
              "  if (SX > 0) return;\n"),
    "fetched": ("  // Form the slots once per block for the signatures this "
                "block meets.",
                '  asm volatile("cp.async.wait_all;\\n" ::);\n'
                "  __syncthreads();\n  if (SX > 0) return;\n"),
    "noface": ("        const T* const own = slot_of(i0 + r);",
               "        if (SX > 0) continue;\n"),
    "nogroup": ("      sweep_group<T, R>(ring, plane, PS, rowp, nb, grp, acc);",
                "      if (SX < 0)\n"),
    "filled": ("  const int groups = (x1 - x0 + R - 1) / R;",
               '  asm volatile("cp.async.wait_all;\\n" ::);\n'
               "  __syncthreads();\n  if (SX > 0) return;\n"),
}
DTYPE = {"f32": torch.float32, "f64": torch.float64}
TUNE_DIR = _build.BUILD_DIR / "tune"


def variant_source(text: str, kind: str, shape: tuple) -> str:
    """stencil_sweep.cu's text with the Shape line of kind ("f32"/"f64")
    replaced by shape."""
    fields = ", ".join(f"{k} = {v}" for k, v in zip(FIELDS, shape))
    line = (f"struct Shape<{CTYPE[kind]}> {{ static constexpr int {fields}; "
            f"}};")
    new, n = re.subn(rf"struct Shape<{CTYPE[kind]}> \{{[^}}]*\}};", line,
                     text)
    if n != 1:
        raise ValueError(f"no single Shape<{CTYPE[kind]}> line in the source")
    return new


def build(kind: str, shape: tuple, cut: str | None) -> tuple:
    """(library path, assembler log) of one shape."""
    tag = f"{kind}-" + "-".join(map(str, shape)) + (f"-{cut}" if cut else "")
    src_dir = TUNE_DIR / tag
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC, src_dir)
    src = src_dir / "stencil_sweep.cu"
    src.write_text(variant_source(src.read_text(), kind, shape))
    if cut:
        line, before = CUTS[cut]
        header = src_dir / "sweep_tile.cuh"
        text = header.read_text()
        if text.count(line) != 1:
            raise ValueError(f"--cut {cut}: no single line {line!r}")
        header.write_text(text.replace(line, before + line))
    lib = src_dir / "stencil_sweep.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
    return lib, log


def register_report(log: str, kind: str) -> str:
    """ptxas's registers and spills for the stencil kernel of kind."""
    mangled = {"f32": "If", "f64": "Id"}[kind]
    out, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
        elif current and re.search(rf"sweep_kernel{mangled}Li", current) \
                and "TableCoef" in current and ("registers" in line
                                               or "spill" in line):
            out.append(line.replace("ptxas info    :", "").strip())
    return "; ".join(out)


def load(lib: pathlib.Path, kind: str):
    import ctypes

    so = ctypes.CDLL(str(lib))
    fn = getattr(so, f"stencil_sweep_{kind}")
    fn.argtypes = _build._ENTRIES["stencil_sweep"][f"stencil_sweep_{kind}"]
    fn.restype = ctypes.c_int
    return fn


def sweep_with(fn, up, table, lo, hi):
    """fn (a variant's C entry) on up, as the wrapper calls the kernel."""
    import ctypes

    out = torch.empty((3, *(n - 2 for n in up.shape[1:])), dtype=up.dtype,
                      device=up.device)
    code = fn(ctypes.c_void_p(up.data_ptr()),
              ctypes.c_void_p(table.data_ptr()),
              ctypes.c_void_p(out.data_ptr()), *out.shape[1:], lo, hi,
              ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if code != 0:
        raise RuntimeError(f"launch failed: CUDA error {code}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--f32", action="append", default=[])
    parser.add_argument("--f64", action="append", default=[])
    parser.add_argument("--cut", choices=sorted(CUTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_tune: torch sees no CUDA device", file=sys.stderr)
        return 1
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.fem import stencil

    card = chip_smoke.card_line()
    print(card)
    todo = [(kind, tuple(int(v) for v in s.split(",")))
            for kind in ("f32", "f64") for s in getattr(args, kind)]
    for kind, shape in todo:
        if len(shape) != len(FIELDS):
            raise SystemExit(f"{kind} shape {shape}: want {FIELDS}")
    t0 = time.perf_counter()
    _build.build()
    TUNE_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        built = list(ex.map(lambda ks: build(*ks, args.cut), todo))
    print(f"[{card}] built {len(todo)} shapes in "
          f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    ops = {name: stencil.build_stencil_operator(meshgen.hex_beam(*n, **kw),
                                                dtype=torch.float64,
                                                device="cuda")
           for name, n, kw in (("70^3", (70, 70, 70), {}),
                               ("32^3", (32, 32, 32), {}),
                               ("6x9x140", (6, 9, 140),
                                {"lx": 6.0, "ly": 9.0, "lz": 140.0}))}
    checks = (("70^3", None), ("32^3 SX=1", 1), ("6x9x140", None))
    variants = []
    for (kind, shape), (lib, log) in zip(todo, built):
        regs = register_report(log, kind)
        print(f"[{card}] {kind} {shape}: {regs}")
        fn = load(lib, kind)
        dtype = DTYPE[kind]
        worst = 0.0
        for name, sx in () if args.cut else checks:
            op = ops[name.split()[0]]
            table = stencil.pack_tables(op.tables, dtype, "cuda")
            shp = op.node_shape if sx is None else (sx, *op.node_shape[1:])
            up = torch.as_tensor(
                rng.standard_normal((3, *(n + 2 for n in shp))),
                dtype=dtype, device="cuda")
            for lo, hi in chip_smoke.FLAGS:
                f = sweep_with(fn, up, table, lo, hi)
                ref = stencil.stencil_sweep_reference(up, table, lo, hi)
                torch.cuda.synchronize()
                rel = float((f - ref).abs().max()) / float(ref.abs().max())
                chip_smoke.require(rel <= chip_smoke.SWEEP_RTOL[dtype],
                                   f"{kind} {shape} {name} ({lo},{hi}): "
                                   f"relative error {rel}")
                worst = max(worst, rel)
        variants.append({"kind": kind, "shape": dict(zip(FIELDS, shape)),
                         "registers": regs, "max_rel_err": worst,
                         "fn": fn, "ms_graph": []})

    # Time the committed kernel and every shape in turns, twice.
    op70 = ops["70^3"]
    shape70 = op70.node_shape
    inputs = {}
    for kind, dtype in DTYPE.items():
        table = stencil.pack_tables(op70.tables, dtype, "cuda")
        up = chip_smoke.pad(torch.as_tensor(
            rng.standard_normal((3, *shape70)), dtype=dtype, device="cuda"))
        inputs[kind] = (up, table)
    base = {kind: {"ms_graph": []} for kind in DTYPE}
    for _ in range(2):
        for kind in DTYPE:
            up, table = inputs[kind]
            base[kind]["ms_graph"].append(chip_smoke.time_graph_ms(
                lambda: stencil.stencil_sweep(up, table, 1, 1)))
        for v in variants:
            up, table = inputs[v["kind"]]
            fn = v["fn"]
            v["ms_graph"].append(chip_smoke.time_graph_ms(
                lambda: sweep_with(fn, up, table, 1, 1)))
    for kind in DTYPE:
        up, _ = inputs[kind]
        out_numel = 3 * int(np.prod(shape70))
        bound_ms, _ = chip_smoke.bound(
            up, up.new_empty(out_numel), 27 * 243 * up.element_size(),
            DTYPE[kind])
        base[kind]["bound_ms"] = bound_ms
        print(f"[{card}] committed stencil_sweep {kind} [3,73,73,73]: "
              + ", ".join(f"{t * 1e3:.2f}" for t in base[kind]["ms_graph"])
              + f" µs (CUDA graph); bound {bound_ms * 1e3:.2f} µs")
    for v in variants:
        del v["fn"]
        ms = v["ms_graph"]
        print(f"[{card}] {v['kind']} {tuple(v['shape'].values())}: "
              + ", ".join(f"{t * 1e3:.2f}" for t in ms)
              + f" µs (CUDA graph); share of bound "
              f"{base[v['kind']]['bound_ms'] / min(ms):.1%}; max rel err "
              f"{v['max_rel_err']:.1e}")
    result = {"card": card, "cut": args.cut, "committed": base,
              "variants": variants}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
