#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stan_tpu_torch) on one GPU.

Phases, each of which raises on failure:
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build the CUDA kernel from stan_tpu_torch/csrc (nvcc), print the build
     time and the assembler's register report;
  3. the kernel against its plain PyTorch version on the card, on the 70^3
     beam's tables and on a small odd grid, with the x-face flags (1,1),
     (0,1), (1,0), (0,0), in float32 and float64;
  4. time per sweep of the kernel and of the plain version at
     [3, 72, 72, 72];
  5. the main path: solve_linear_statics(hex_beam(70, 70, 70),
     device="cuda") in float32 with float64 certification (1,073,733 DOF):
     operator "stencil", converged, certified residual <= 1e-6, and at
     least one kernel launch per CG iteration;
  6. an independent check of the answer: the float64 residual with the
     structured operator (which does not use the kernel), and the support
     reactions balancing the loads;
  7. the cost of the CG loop's per-iteration host sync.

Prints a JSON line of kernel facts and, last, one JSON line naming the
device. Exits non-zero, with no result, when there is no CUDA device.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N = 70  # bench.py's beam: 343,000 HEX8 elements, 1,073,733 DOF
SEED = 0
# The kernel and the plain version sum the same products in other orders.
SWEEP_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
FLAGS = ((1, 1), (0, 1), (1, 0), (0, 0))
SYNC_ITERS = 200


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare_sweeps(tables, node_shape, rng, label, card) -> dict:
    """Kernel vs plain version on random slabs (ghosts random too, as a
    slab's x ghosts carry a neighbour's plane); returns {(dtype, flags):
    max abs error}."""
    from stan_tpu_torch.fem import stencil

    errs = {}
    for dtype in (torch.float32, torch.float64):
        table = stencil.pack_tables(tables, dtype, "cuda")
        up_np = rng.standard_normal((3, *(n + 2 for n in node_shape)))
        up = torch.as_tensor(up_np, dtype=dtype, device="cuda")
        for lo, hi in FLAGS:
            f = stencil.stencil_sweep(up, table, lo, hi)
            f_ref = stencil.stencil_sweep_reference(up, table, lo, hi)
            torch.cuda.synchronize()
            err = float((f - f_ref).abs().max())
            scale = float(f_ref.abs().max())
            require(bool(torch.isfinite(f).all()), f"{label}: non-finite")
            require(err <= SWEEP_RTOL[dtype] * scale,
                    f"{label} {dtype} flags ({lo},{hi}): max error {err} > "
                    f"{SWEEP_RTOL[dtype]} x {scale}")
            errs[(dtype, (lo, hi))] = err
            print(f"[{card}] sweep {label} {str(dtype)[6:]} flags ({lo},{hi}):"
                  f" max|f-f_ref| = {err:.3e} (max|f_ref| = {scale:.3e})")
    return errs


def cg_without_sync(A, b, diag, iters: int):
    """The iteration of solvers/cg.pcg with no host read of the residual
    (the norm is still computed on the device)."""
    inv_diag = torch.where(diag != 0, 1.0 / diag, torch.zeros_like(diag))
    x = torch.zeros_like(b)
    r = b - A(x)
    z = inv_diag * r
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = A(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_n = torch.sum(r * z)
        p = z + (rz_n / rz) * p
        rz = rz_n
        torch.sqrt(torch.sum(r * r))
    return x


def wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from stan_tpu.core import meshgen
    from stan_tpu_torch import _build
    from stan_tpu_torch.analysis.linear import solve_linear_statics
    from stan_tpu_torch.fem import stencil, structured
    from stan_tpu_torch.solvers import cg
    from stan_tpu_torch.utils.timing import PhaseTimer

    card = card_line()
    print(card)
    print(f"[{card}] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"[{card}] kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"({lib_path.name})")
    print(lib_path.with_suffix(".log").read_text().strip())

    # -- kernel vs plain version ------------------------------------------
    rng = np.random.default_rng(SEED)
    model = meshgen.hex_beam(N, N, N)
    op32 = stencil.build_stencil_operator(model, dtype=torch.float32,
                                          device="cuda")
    require(op32 is not None, "70^3 beam refused by the stencil operator")
    errs = compare_sweeps(op32.tables, op32.node_shape, rng,
                          f"{N}^3", card)
    small = meshgen.hex_beam(5, 4, 3, lx=6.0, ly=1.5, lz=3.0)
    op_small = stencil.build_stencil_operator(small, dtype=torch.float64,
                                              device="cuda")
    compare_sweeps(op_small.tables, op_small.node_shape, rng,
                   "5x4x3 (lx=6, ly=1.5, lz=3)", card)

    # -- time per sweep at the main path's shape, in turns ----------------
    times = {}
    for dtype in (torch.float32, torch.float64):
        table = stencil.pack_tables(op32.tables, dtype, "cuda")
        up = torch.as_tensor(
            rng.standard_normal((3, *(n + 2 for n in op32.node_shape))),
            dtype=dtype, device="cuda")
        kern = lambda: stencil.stencil_sweep(up, table, 1, 1)  # noqa: E731
        plain = lambda: stencil.stencil_sweep_reference(  # noqa: E731
            up, table, 1, 1)
        p1 = time_ms(plain, 20)
        k1 = time_ms(kern, 200)
        k2 = time_ms(kern, 200)
        p2 = time_ms(plain, 20)
        times[dtype] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[{card}] sweep [3,72,72,72] {str(dtype)[6:]}: kernel "
              f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")

    # -- the main path ----------------------------------------------------
    model = meshgen.hex_beam(N, N, N)
    timer = PhaseTimer(verbose=False)
    stencil.launches = 0
    t0 = time.perf_counter()
    res = solve_linear_statics(model, device="cuda", timer=timer)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = stencil.launches
    print(f"[{card}] solve {model.ndof} DOF: operator {res.operator}, "
          f"{res.iters} CG iterations, converged {res.converged}, "
          f"residual {res.residual:.3e}, certified f64 residual "
          f"{res.true_residual}, {res.refine_cycles} refinement cycles, "
          f"{res.refine_iters} refinement iterations, {launches} kernel "
          f"launches, {solve_s:.3f} s")
    for r in timer.records:
        extra = {k: v for k, v in r.items() if k not in ("phase", "seconds")}
        print(f"[{card}] phase {r['phase']}: {r['seconds']:.4f} s {extra}")
        if r["phase"].startswith("Linear solve"):
            print(f"[{card}] CG iterations/s (base solve phase): "
                  f"{res.iters / r['seconds']:.1f}")
    require(res.operator == "stencil", f"operator {res.operator}")
    require(res.converged, "solve did not converge")
    require(res.true_residual is not None and res.true_residual <= 1e-6,
            f"certified residual {res.true_residual}")
    require(launches >= res.iters,
            f"{launches} kernel launches < {res.iters} CG iterations")
    require(res.u.shape == (model.nnode, 3) and np.isfinite(res.u).all(),
            "displacements not finite or misshapen")
    require(res.stress.shape == (model.nelem, 8, 6)
            and np.isfinite(res.stress).all()
            and np.isfinite(res.strain).all(), "stress/strain not finite")

    # -- independent check: float64 structured operator, no kernel --------
    sop64 = structured.build_structured_operator(
        model, dtype=torch.float64, device="cuda")
    loads = model.load_vector()
    b = sop64.free_mask * sop64.to_grid(
        torch.as_tensor(loads, dtype=torch.float64, device="cuda"))
    for name, u in (("certified float64 u", res.u_certified),
                    ("float32 u", res.u)):
        ug = sop64.to_grid(torch.as_tensor(u, dtype=torch.float64,
                                           device="cuda"))
        rel = float(torch.linalg.vector_norm(b - sop64.apply(ug))
                    / torch.linalg.vector_norm(b))
        print(f"[{card}] structured-operator f64 relative residual of the "
              f"{name}: {rel:.3e}")
        if u is res.u_certified:
            require(rel <= 1e-6, f"independent f64 residual {rel}")
    fix = model.fix_mask()
    supports = res.reactions.astype(np.float64).reshape(-1)[fix.reshape(-1)]
    gap = np.abs(supports.reshape(-1, 3).sum(axis=0) + loads.sum(axis=0))
    total = float(np.linalg.norm(loads.sum(axis=0)))
    print(f"[{card}] reactions + loads at the supports: {gap.tolist()} "
          f"(total load {total})")
    require(float(gap.max()) <= 1e-3 * total, f"reaction gap {gap}")

    # -- the per-iteration host sync of the CG loop, in turns -------------
    rhs = (op32.free_mask * op32.to_grid(torch.as_tensor(
        loads, dtype=torch.float32, device="cuda"))).contiguous()
    diag = op32.diagonal()
    with_sync = lambda: cg.pcg(op32.apply, rhs, diag=diag, tol=0.0,  # noqa
                               maxiter=SYNC_ITERS)
    no_sync = lambda: cg_without_sync(op32.apply, rhs, diag,  # noqa: E731
                                      SYNC_ITERS)
    with_sync()
    s1, n1, n2, s2 = wall(with_sync), wall(no_sync), wall(no_sync), \
        wall(with_sync)
    per_s = (s1 + s2) / 2 / SYNC_ITERS * 1e3
    per_n = (n1 + n2) / 2 / SYNC_ITERS * 1e3
    print(f"[{card}] CG iteration, float32 stencil, {SYNC_ITERS} iterations: "
          f"{per_s:.4f} ms with the per-iteration sync, {per_n:.4f} ms "
          f"without; sync cost {per_s - per_n:.4f} ms/iteration")

    ms, plain_ms = times[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "stencil_sweep",
        "route": "cuda",
        "source": "stan_tpu_torch/csrc/stencil_sweep.cu",
        "replaces": "stan_tpu/fem/stencil.py:218",
        "launches": launches,
        "max_abs_err": errs[(torch.float32, (1, 1))],
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
