"""Assembled 27-point stencil operator, with a hand-written CUDA sweep.

Port of stan_tpu/fem/stencil.py (the single-device path). On a uniform-
material structured HEX8 grid the assembled K is translation-invariant in
the interior: row n couples node n to its 26 lattice neighbours through
constant 3x3 blocks,

    f[c, n] = sum_{o in {-1,0,1}^3} A[o][c, d] * u[d, n + o].

A boundary node's row misses the elements outside the grid, so every node
is classified per axis as L(ow edge) / F(ree interior) / H(igh edge), and
each of the 27 signatures has its own exact table (signature_tables). The
sweep (stencil_sweep) applies to every node the table of its own
signature. On the card it is the CUDA kernel in csrc/stencil_sweep.cu; on
the CPU it is stencil_sweep_reference, the plain PyTorch version with the
same contract.

The x-axis L/H rows depend on the global position of the slab, so the
sweep takes two flags (this slab owns the global low / high x face), as the
TPU kernel does; the single-device path passes (1, 1).

The calibration's forward model needs K(θ)·u = λ·K_λu + μ·K_μu with the
unit-λ and unit-μ tables fixed and (λ, μ) changing at run time, per chain.
theta_sweep (one grid) and theta_sweep_batched (a [B, ...] batch of chains,
one launch) compute it in one pass, on the kernel of csrc/theta_sweep.cu,
with the coefficients read from device memory; theta_sweep_reference is
their plain version. The solve's gradient in (λ, μ) takes theta_coef_grads
(infer/forward.StencilForwardProblem.param_grads).

exact_tables builds the float64 tables from the float64 element stiffness
on the host, whatever the operator dtype, and apply_numpy applies them on
the host (the interior sweep in the host runtime, csrc/stanfem.cpp; the
boundary deltas in numpy): the host float64 reference for the sweep. The
float64 StencilOperator carries the same tables (to 1e-14) on a device,
where the sweep's double instantiation gives the float64 residual of the
certified solve (solvers/cg.pcg_certified).
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from stan_tpu_torch.core.model import FEModel
from stan_tpu_torch import _build, native
from stan_tpu_torch.fem import hostops, launches, structured
from stan_tpu_torch.fem.operator import resolve_device
from stan_tpu_torch.fem.structured import StructuredOperator

_OFFSETS = tuple(itertools.product((-1, 0, 1), repeat=3))
# Allowed values of the anchor corner's index per axis signature: the
# element that contributes through corner pair (a, b) sits at n - ca, so
# ca=0 needs an element on the high side, ca=1 on the low side.
_ALLOWED = {"F": (0, 1), "L": (0,), "H": (1,)}
_SIGS = tuple(itertools.product("FLH", repeat=3))
_INTERIOR = ("F", "F", "F")


def signature_tables(ke: np.ndarray) -> dict:
    """Exact assembled stencil tables for all 27 L/F/H boundary signatures.

    Returns {sig: {offset: 3x3 ndarray}} with exact zeros dropped; sig
    ('F','F','F') is the interior 27-point table.
    """
    ke = np.asarray(ke, np.float64)
    tiny = 1e-12 * np.abs(ke).max()
    tables = {}
    for sig in _SIGS:
        T = {}
        for a in range(8):
            ca = structured._CORNERS[a]
            if any(int(ca[k]) not in _ALLOWED[sig[k]] for k in range(3)):
                continue
            for b in range(8):
                off = tuple(int(v) for v in structured._CORNERS[b] - ca)
                blk = ke[3 * a:3 * a + 3, 3 * b:3 * b + 3]
                T[off] = T.get(off, 0.0) + blk
        clean = {}
        for off, m in T.items():
            m = np.where(np.abs(m) < tiny, 0.0, m)
            if np.any(m != 0.0):
                clean[off] = m
        tables[sig] = clean
    return tables


def delta_tables(tables: dict) -> dict:
    """Corrections Delta_sig = T_sig - T_interior for the 26 boundary
    signatures, zeros dropped."""
    t0 = tables[_INTERIOR]
    deltas = {}
    for sig in _SIGS:
        if sig == _INTERIOR:
            continue
        d = {}
        for off in set(tables[sig]) | set(t0):
            m = np.asarray(tables[sig].get(off, 0.0) - t0.get(off, 0.0))
            if np.any(m != 0.0):
                d[off] = m
        if d:
            deltas[sig] = d
    return deltas


def pack_tables(tables: dict, dtype, device) -> torch.Tensor:
    """Lay the 27 signature tables out densely as [27 signatures, 27 offsets,
    3, 3] (the order of _SIGS and _OFFSETS), zeros for absent entries.

    Every signature of a grid that build_stencil_operator accepts has a
    nonempty table, so the sweep never needs the TPU kernel's skip of an
    empty tier; an empty one is refused here."""
    packed = np.zeros((27, 27, 3, 3))
    for s, sig in enumerate(_SIGS):
        if not tables.get(sig):
            raise ValueError(f"signature {sig} has an empty stencil table")
        for (ox, oy, oz), m in tables[sig].items():
            packed[s, 9 * (ox + 1) + 3 * (oy + 1) + (oz + 1)] = m
    return torch.as_tensor(packed, dtype=dtype, device=device)


def _axis_regions(n: int, low: bool, high: bool) -> dict:
    """{L, F, H: (start, stop)} along one axis of n nodes: L is node 0 when
    `low`, H is node n-1 when `high` (and not already L), F the rest."""
    lo = min(n, 1) if low else 0
    hi = max(n - 1, lo) if high else n
    return {"L": (0, lo), "F": (lo, hi), "H": (hi, n)}


def stencil_sweep_reference(up: torch.Tensor, table: torch.Tensor,
                            is_low, is_high) -> torch.Tensor:
    """Plain PyTorch version of stencil_sweep, same contract.

    For each signature region, the 27 shifted slices of `up` are stacked
    and contracted with that signature's table in one einsum.
    """
    _, SXp, NNYp, NNZp = up.shape
    SX, NNY, NNZ = SXp - 2, NNYp - 2, NNZp - 2
    out = up.new_empty((3, SX, NNY, NNZ))
    xr = _axis_regions(SX, bool(is_low), bool(is_high))
    yr = _axis_regions(NNY, True, True)
    zr = _axis_regions(NNZ, True, True)
    for s, (sx, sy, sz) in enumerate(_SIGS):
        (x0, x1), (y0, y1), (z0, z1) = xr[sx], yr[sy], zr[sz]
        if x1 <= x0 or y1 <= y0 or z1 <= z0:
            continue
        shifted = torch.stack([
            up[:, 1 + x0 + ox:1 + x1 + ox, 1 + y0 + oy:1 + y1 + oy,
               1 + z0 + oz:1 + z1 + oz]
            for ox, oy, oz in _OFFSETS])
        out[:, x0:x1, y0:y1, z0:z1] = torch.einsum(
            "ocd,odxyz->cxyz", table[s], shifted)
    return out


def stencil_sweep(up: torch.Tensor, table: torch.Tensor, is_low,
                  is_high) -> torch.Tensor:
    """Exact assembled K·u over a ghost-padded slab.

    up: [3, SX+2, NNY+2, NNZ+2], the node slab with a one-node ghost layer
    (zeros for a whole grid). table: pack_tables output in up's dtype.
    is_low / is_high: 0/1, whether this slab owns the global low / high x
    face. Returns [3, SX, NNY, NNZ].

    A CPU tensor takes stencil_sweep_reference. A CUDA tensor launches the
    kernel of csrc/stencil_sweep.cu on the current stream, or raises.
    """
    if up.device.type == "cpu":
        return stencil_sweep_reference(up, table, is_low, is_high)
    if up.device.type != "cuda":
        raise ValueError(f"stencil_sweep: unsupported device {up.device}")
    if up.dim() != 4 or up.shape[0] != 3 or min(up.shape[1:]) < 3:
        raise ValueError(f"stencil_sweep: up must be [3, SX+2, NNY+2, NNZ+2] "
                         f"with SX, NNY, NNZ >= 1, got {tuple(up.shape)}")
    if tuple(table.shape) != (27, 27, 3, 3):
        raise ValueError(f"stencil_sweep: table must be [27, 27, 3, 3], got "
                         f"{tuple(table.shape)}")
    if up.dtype not in (torch.float32, torch.float64) or table.dtype != up.dtype:
        raise TypeError(f"stencil_sweep: up and table must share float32 or "
                        f"float64, got {up.dtype} and {table.dtype}")
    if table.device != up.device:
        raise ValueError("stencil_sweep: up and table are on different devices")
    if not (up.is_contiguous() and table.is_contiguous()):
        raise ValueError("stencil_sweep: up and table must be contiguous")
    _, SXp, NNYp, NNZp = up.shape
    out = torch.empty((3, SXp - 2, NNYp - 2, NNZp - 2), dtype=up.dtype,
                      device=up.device)
    lib = _build.library("stencil_sweep")
    fn = (lib.stencil_sweep_f32 if up.dtype == torch.float32
          else lib.stencil_sweep_f64)
    with torch.cuda.device(up.device):
        stream = torch.cuda.current_stream(up.device).cuda_stream
        code = fn(ctypes.c_void_p(up.data_ptr()),
                  ctypes.c_void_p(table.data_ptr()),
                  ctypes.c_void_p(out.data_ptr()), SXp - 2, NNYp - 2,
                  NNZp - 2, int(bool(is_low)), int(bool(is_high)),
                  ctypes.c_void_p(stream))
    _build.check(code, "stencil_sweep launch", "stencil_sweep")
    launches.count("stencil_sweep", is_low, is_high)
    return out


def pack_theta_tables(tables_lam: dict, tables_mu: dict, dtype, device
                      ) -> torch.Tensor:
    """The unit-λ and unit-μ signature tables packed side by side as
    [2, 27, 27, 3, 3] (pack_tables layout): the theta sweeps' table input."""
    return torch.stack([pack_tables(tables_lam, dtype, device),
                        pack_tables(tables_mu, dtype, device)])


def theta_sweep_reference(up_b: torch.Tensor, tables2: torch.Tensor,
                          coef: torch.Tensor, is_low, is_high
                          ) -> torch.Tensor:
    """Plain PyTorch version of theta_sweep_batched, same contract.

    Combines the two table sets per chain (coef[b, 0]·T_λ + coef[b, 1]·T_μ,
    as the kernel forms each coefficient), then for each signature region
    contracts that signature's table with the region's 3x3x3 neighbour
    windows (an unfold view of up_b, window index = offset + 1 per axis),
    all chains in one einsum.
    """
    B, _, SXp, NNYp, NNZp = up_b.shape
    SX, NNY, NNZ = SXp - 2, NNYp - 2, NNZp - 2
    tab = torch.einsum("bt,tsocd->bsocd", coef, tables2).reshape(
        B, 27, 3, 3, 3, 3, 3)  # [B, sig, ox, oy, oz, c, d]
    win = up_b.unfold(2, 3, 1).unfold(3, 3, 1).unfold(4, 3, 1)
    out = up_b.new_empty((B, 3, SX, NNY, NNZ))
    xr = _axis_regions(SX, bool(is_low), bool(is_high))
    yr = _axis_regions(NNY, True, True)
    zr = _axis_regions(NNZ, True, True)
    for s, (sx, sy, sz) in enumerate(_SIGS):
        (x0, x1), (y0, y1), (z0, z1) = xr[sx], yr[sy], zr[sz]
        if x1 <= x0 or y1 <= y0 or z1 <= z0:
            continue
        out[:, :, x0:x1, y0:y1, z0:z1] = torch.einsum(
            "bpqrcd,bdxyzpqr->bcxyz", tab[:, s],
            win[:, :, x0:x1, y0:y1, z0:z1])
    return out


def _check_theta(name, up_b, tables2, coef) -> None:
    """Refuse what the theta kernel does not take (up_b is 5-D here)."""
    B = up_b.shape[0]
    if up_b.shape[1] != 3 or min(up_b.shape[2:]) < 3:
        raise ValueError(f"{name}: up must be [3, SX+2, NNY+2, NNZ+2] per "
                         f"chain with SX, NNY, NNZ >= 1, got "
                         f"{tuple(up_b.shape)}")
    if not 1 <= B <= 65535:
        raise ValueError(f"{name}: 1 <= chains <= 65535, got {B}")
    if tuple(tables2.shape) != (2, 27, 27, 3, 3):
        raise ValueError(f"{name}: tables must be [2, 27, 27, 3, 3], got "
                         f"{tuple(tables2.shape)}")
    if tuple(coef.shape) != (B, 2):
        raise ValueError(f"{name}: coef must be [{B}, 2] (or [2] for one "
                         f"grid), got {tuple(coef.shape)}")
    if (up_b.dtype not in (torch.float32, torch.float64)
            or tables2.dtype != up_b.dtype or coef.dtype != up_b.dtype):
        raise TypeError(f"{name}: up, tables and coef must share float32 or "
                        f"float64, got {up_b.dtype}, {tables2.dtype}, "
                        f"{coef.dtype}")
    if tables2.device != up_b.device or coef.device != up_b.device:
        raise ValueError(f"{name}: up, tables and coef are on different "
                         f"devices")
    if not (up_b.is_contiguous() and tables2.is_contiguous()
            and coef.is_contiguous()):
        raise ValueError(f"{name}: up, tables and coef must be contiguous")


def _launch_theta(up_b, tables2, coef, is_low, is_high) -> torch.Tensor:
    B, _, SXp, NNYp, NNZp = up_b.shape
    out = torch.empty((B, 3, SXp - 2, NNYp - 2, NNZp - 2), dtype=up_b.dtype,
                      device=up_b.device)
    lib = _build.library("theta_sweep")
    fn = (lib.theta_sweep_f32 if up_b.dtype == torch.float32
          else lib.theta_sweep_f64)
    with torch.cuda.device(up_b.device):
        stream = torch.cuda.current_stream(up_b.device).cuda_stream
        code = fn(ctypes.c_void_p(up_b.data_ptr()),
                  ctypes.c_void_p(tables2.data_ptr()),
                  ctypes.c_void_p(coef.data_ptr()),
                  ctypes.c_void_p(out.data_ptr()), B, SXp - 2, NNYp - 2,
                  NNZp - 2, int(bool(is_low)), int(bool(is_high)),
                  ctypes.c_void_p(stream))
    _build.check(code, "theta_sweep launch", "theta_sweep")
    return out


def theta_sweep(up: torch.Tensor, tables2: torch.Tensor, coef: torch.Tensor,
                is_low, is_high) -> torch.Tensor:
    """coef[0]·K_λu + coef[1]·K_μu over one ghost-padded slab.

    up: [3, SX+2, NNY+2, NNZ+2] (the stencil_sweep contract); tables2:
    pack_theta_tables output in up's dtype; coef: [2] tensor on up's
    device (never read on the host). Returns [3, SX, NNY, NNZ].

    A CPU tensor takes theta_sweep_reference. A CUDA tensor launches the
    kernel of csrc/theta_sweep.cu with one chain, or raises.
    """
    if up.dim() != 4 or coef.dim() != 1:
        raise ValueError(f"theta_sweep: up must be 4-D and coef [2], got "
                         f"{tuple(up.shape)} and {tuple(coef.shape)}")
    if up.device.type == "cpu":
        return theta_sweep_reference(up[None], tables2, coef[None], is_low,
                                     is_high)[0]
    if up.device.type != "cuda":
        raise ValueError(f"theta_sweep: unsupported device {up.device}")
    _check_theta("theta_sweep", up[None], tables2, coef[None])
    out = _launch_theta(up[None], tables2, coef[None], is_low, is_high)[0]
    launches.count("theta_sweep", is_low, is_high)
    return out


def theta_sweep_batched(up_b: torch.Tensor, tables2: torch.Tensor,
                        coef: torch.Tensor, is_low, is_high) -> torch.Tensor:
    """coef[b, 0]·K_λu_b + coef[b, 1]·K_μu_b for a batch of B chains in one
    launch.

    up_b: [B, 3, SX+2, NNY+2, NNZ+2]; coef: [B, 2] tensor on up_b's device.
    Returns [B, 3, SX, NNY, NNZ]. A CPU tensor takes theta_sweep_reference;
    a CUDA tensor launches the kernel of csrc/theta_sweep.cu, or raises.
    """
    if up_b.dim() != 5 or coef.dim() != 2:
        raise ValueError(f"theta_sweep_batched: up must be 5-D and coef "
                         f"[B, 2], got {tuple(up_b.shape)} and "
                         f"{tuple(coef.shape)}")
    if up_b.device.type == "cpu":
        return theta_sweep_reference(up_b, tables2, coef, is_low, is_high)
    if up_b.device.type != "cuda":
        raise ValueError(f"theta_sweep_batched: unsupported device "
                         f"{up_b.device}")
    _check_theta("theta_sweep_batched", up_b, tables2, coef)
    out = _launch_theta(up_b, tables2, coef, is_low, is_high)
    launches.count("theta_sweep_batched", is_low, is_high)
    return out


def theta_apply_padded(tables2: torch.Tensor, coef: torch.Tensor,
                       up: torch.Tensor, is_low, is_high) -> torch.Tensor:
    """coef[b, 0]·K_λu_b + coef[b, 1]·K_μu_b on ghost-padded slabs up [B, 3,
    SX+2, NNY+2, NNZ+2] with coef [B, 2]: one chain goes through
    theta_sweep, more through one theta_sweep_batched launch."""
    if up.shape[0] == 1:
        return theta_sweep(up[0], tables2, coef[0], is_low, is_high)[None]
    return theta_sweep_batched(up, tables2, coef, is_low, is_high)


def theta_apply(tables2: torch.Tensor, lam: torch.Tensor, mu: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """λ_b·K_λu_b + μ_b·K_μu_b on whole node grids u [B, 3, X, Y, Z] with
    λ, μ [B] (zero ghosts, flags (1, 1))."""
    up = F.pad(u, (1, 1, 1, 1, 1, 1)).contiguous()
    coef = torch.stack([lam, mu], dim=-1).to(u.dtype)
    return theta_apply_padded(tables2, coef, up, 1, 1)


def theta_coef_grads(tables2: torch.Tensor, ct: torch.Tensor,
                     u: torch.Tensor):
    """(⟨ct_b, K_λu_b⟩, ⟨ct_b, K_μu_b⟩) per chain, from the unit-coefficient
    sweeps (1, 0) and (0, 1): the cotangents of λ and μ in a·K_λu + b·K_μu.
    """
    one, nil = torch.ones_like(ct[:, 0, 0, 0, 0]), torch.zeros_like(
        ct[:, 0, 0, 0, 0])
    axes = tuple(range(1, ct.dim()))
    return ((ct * theta_apply(tables2, one, nil, u)).sum(axes),
            (ct * theta_apply(tables2, nil, one, u)).sum(axes))


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """Masked stiffness operator backed by the stencil sweep. Diagonal,
    masks and grid translation are delegated to the structured operator."""

    base: StructuredOperator
    tables: dict  # {sig: {offset: 3x3 float64 ndarray}} exact tables
    table: torch.Tensor  # pack_tables(tables) in the operator dtype

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    @property
    def nelems(self):
        return self.base.nelems

    @property
    def node_shape(self):
        return self.base.node_shape

    @property
    def free_mask(self):
        return self.base.free_mask

    def to_grid(self, u_flat):
        return self.base.to_grid(u_flat)

    def to_flat(self, u_grid):
        return self.base.to_flat(u_grid)

    def diagonal(self):
        return self.base.diagonal()

    def apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        """K.u on the whole node grid [3, nnx, nny, nnz]."""
        up = F.pad(u, (1, 1, 1, 1, 1, 1)).contiguous()
        return stencil_sweep(up, self.table, 1, 1)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Masked SPD action: M K (M u) + (I - M) u."""
        m = self.free_mask
        return m * self.apply_raw(m * u) + (1.0 - m) * u


def _stencil_qualifies(model: FEModel) -> Optional[dict]:
    """detect_structured's grid info if the model qualifies for the stencil
    operator, else None: the structured grid, a single isotropic material
    (tested on the float64 Lame fields, whatever the operator dtype), and
    at least 3 nodes along every axis (so the L/F/H regions do not
    overlap). Host only: no device operator is built to answer."""
    info = structured.detect_structured(model)
    if info is None or min(info["nelems"]) < 2:
        return None
    lam_e, mu_e = structured.lame_fields(model)
    if not (np.all(lam_e == lam_e[0]) and np.all(mu_e == mu_e[0])):
        return None
    return info


def build_stencil_operator(model: FEModel, *, dtype=None, device="cuda"
                           ) -> Optional[StencilOperator]:
    """Build the stencil operator, or None if the model doesn't qualify
    (_stencil_qualifies). In float64 its apply is the masked float64 action
    on stencil_sweep's double instantiation: the high-precision operator of
    pcg_certified, with tables equal to exact_tables(model) to 1e-14."""
    device = resolve_device(device)
    info = _stencil_qualifies(model)
    if info is None:
        return None
    base = structured.build_from_grid(model, info, dtype=dtype, device=device)
    lam = base.lam_e.reshape(-1)
    mu = base.mu_e.reshape(-1)
    ke = (base.ke_lam.to(torch.float64).cpu().numpy() * float(lam[0])
          + base.ke_mu.to(torch.float64).cpu().numpy() * float(mu[0]))
    tables = signature_tables(ke)
    return StencilOperator(base=base, tables=tables,
                           table=pack_tables(tables, base.dtype, base.device))


def exact_tables(model: FEModel):
    """(tables, deltas) from the float64 element stiffness, whatever the
    operator dtype, or None when the model does not qualify for the stencil
    operator. The high-precision operator definition for apply_numpy.

    The tables come from hostops.element_stiffness_np in float64, never
    from an operator's ke: a float32 operator's ke_lam and ke_mu are
    rounded, and a residual against tables built from them reads 1e-5 where
    the exact one reads 1e-12. The qualification is build_stencil_operator's
    own (_stencil_qualifies), on the host, without a device operator.
    """
    info = _stencil_qualifies(model)
    if info is None:
        return None
    lam_e, mu_e = structured.lame_fields(model)
    hx, hy, hz = info["spacing"]
    corners = np.array(
        [[dx * hx, dy * hy, dz * hz] for dx, dy, dz in structured._CORNERS],
        np.float64)
    ke = hostops.element_stiffness_np(
        corners[None], hostops.d_np(float(lam_e[0]), float(mu_e[0]))[None],
        model.formulation())[0]
    tables = signature_tables(ke)
    return tables, delta_tables(tables)


def _region_apply(up: np.ndarray, table: dict, xs, xlen, ys, ylen, zs,
                  zlen) -> np.ndarray:
    """One table over the region [xs, xs+xlen) x [ys, ...) x [zs, ...) of
    the node grid, in numpy, from the ghost-padded grid up."""
    out = np.zeros((3, xlen, ylen, zlen))
    for (ox, oy, oz), m in table.items():
        sub = up[:,
                 1 + xs + ox:1 + xs + ox + xlen,
                 1 + ys + oy:1 + ys + oy + ylen,
                 1 + zs + oz:1 + zs + oz + zlen]
        out += np.einsum("cd,dxyz->cxyz", np.asarray(m, np.float64), sub)
    return out


def _add_deltas(f: np.ndarray, deltas: dict, up: np.ndarray) -> np.ndarray:
    """f plus each boundary signature's delta table over its region."""
    _, NNX, NNY, NNZ = f.shape
    x_region = {"L": (0, 1), "H": (NNX - 1, 1), "F": (1, NNX - 2)}
    y_region = {"L": (0, 1), "H": (NNY - 1, 1), "F": (1, NNY - 2)}
    z_region = {"L": (0, 1), "H": (NNZ - 1, 1), "F": (1, NNZ - 2)}
    for sig, dsig in deltas.items():
        xs, xlen = x_region[sig[0]]
        ys, ylen = y_region[sig[1]]
        zs, zlen = z_region[sig[2]]
        if xlen <= 0 or ylen <= 0 or zlen <= 0:
            continue
        f[:, xs:xs + xlen, ys:ys + ylen, zs:zs + zlen] += _region_apply(
            up, dsig, xs, xlen, ys, ylen, zs, zlen)
    return f


def apply_numpy(tables: dict, deltas: dict, u: np.ndarray) -> np.ndarray:
    """Host float64 K·u on the node grid [3, nnx, nny, nnz]: the interior
    table over the whole grid in the host runtime (native.
    stencil_interior_f64, OpenMP over x-planes), then each boundary
    signature's delta over its region in numpy. The reference for the
    device sweep, independent of it; apply_numpy_reference is its plain
    numpy version."""
    up = np.pad(np.asarray(u, np.float64), ((0, 0), (1, 1), (1, 1), (1, 1)))
    tab = np.zeros((27, 3, 3), np.float64)
    for (ox, oy, oz), m in tables[_INTERIOR].items():
        tab[(ox + 1) * 9 + (oy + 1) * 3 + (oz + 1)] = m
    return _add_deltas(native.stencil_interior_f64(up, tab), deltas, up)


def apply_numpy_reference(tables: dict, deltas: dict, u: np.ndarray
                          ) -> np.ndarray:
    """apply_numpy with the interior table in numpy as well: its plain
    version, for the tests."""
    u = np.asarray(u, np.float64)
    _, NNX, NNY, NNZ = u.shape
    up = np.pad(u, ((0, 0), (1, 1), (1, 1), (1, 1)))
    f = _region_apply(up, tables[_INTERIOR], 0, NNX, 0, NNY, 0, NNZ)
    return _add_deltas(f, deltas, up)
