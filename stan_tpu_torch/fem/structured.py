"""Structured-grid stiffness operator: slice gather + block matmul.

Port of stan_tpu/fem/structured.py. On an axis-aligned brick grid in
meshgen order, gather and scatter become slices:

  u_e [24, nx, ny, nz] = 8 shifted sub-grids of u
  f_e = lam_e * (ke_lam . u_e) + mu_e * (ke_mu . u_e)   (one [48,24]x[24,N]
        torch.matmul; ke is linear in the isotropic Lame constants, so
        per-element material fields still work)
  f   = 8 zero-padded shifted reads                      (no scatter)

The grid layout is channel-first [3, nnx, nny, nnz], as in the JAX package.
Grids may carry leading batch axes ([B, 3, nnx, nny, nnz], with lam_e and
mu_e [B, nx, ny, nz]): one system per chain of the calibration's field
forward problem.
The unit-coefficient element stiffnesses are computed in float64 on the
host (fem.hostops) and cast to the operator dtype; Lame and D come from
hostops.d_np, so this module does not depend on the inference layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from stan_tpu_torch.core.model import FEModel
from stan_tpu_torch.fem import hostops
from stan_tpu_torch.fem.elements import ElementFormulation
from stan_tpu_torch.fem.operator import default_dtype, resolve_device

# HEX8 node -> grid-corner offset (meshgen.hex_beam ordering).
_CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    dtype=np.int64,
)


@dataclasses.dataclass(frozen=True)
class StructuredOperator:
    """Masked stiffness operator on an (nx, ny, nz)-element brick grid."""

    nelems: tuple  # (nx, ny, nz)
    ke_lam: torch.Tensor  # [24, 24] unit-lambda element stiffness
    ke_mu: torch.Tensor  # [24, 24] unit-mu element stiffness
    lam_e: torch.Tensor  # [nx, ny, nz]
    mu_e: torch.Tensor  # [nx, ny, nz]
    free_mask: torch.Tensor  # [3, nnx, nny, nnz]
    form: ElementFormulation

    @property
    def dtype(self):
        return self.ke_lam.dtype

    @property
    def device(self):
        return self.ke_lam.device

    @property
    def node_shape(self):
        nx, ny, nz = self.nelems
        return (nx + 1, ny + 1, nz + 1)

    # -- grid <-> flat (meshgen node id = i*nyz + j*(nz+1) + k) --
    def to_grid(self, u_flat: torch.Tensor) -> torch.Tensor:
        """[nnode, 3] -> [3, nnx, nny, nnz]."""
        return u_flat.reshape(*self.node_shape, 3).permute(3, 0, 1, 2)

    def to_flat(self, u_grid: torch.Tensor) -> torch.Tensor:
        """[3, nnx, nny, nnz] -> [nnode, 3]."""
        return u_grid.permute(1, 2, 3, 0).reshape(-1, 3)

    def gather_elements(self, u: torch.Tensor) -> torch.Tensor:
        """u [...,3,nnx,nny,nnz] -> u_e [...,24,nx,ny,nz]; slot 3*a + c is
        corner a, component c (the element DOF order of the general
        kernels)."""
        nx, ny, nz = self.nelems
        return torch.cat([u[..., ox:ox + nx, oy:oy + ny, oz:oz + nz]
                          for ox, oy, oz in _CORNERS], dim=-4)

    def scatter_elements(self, f_e: torch.Tensor) -> torch.Tensor:
        """f_e [...,24,nx,ny,nz] -> f [...,3,nnx,nny,nnz]: node (i,j,k) sums
        f_e[a] at element (i,j,k) - corner_a, as 8 zero-padded shifted
        slabs."""
        total = None
        for a, (ox, oy, oz) in enumerate(_CORNERS):
            # corner offset 1 -> zero in front; 0 -> zero behind
            term = F.pad(f_e[..., 3 * a:3 * a + 3, :, :, :],
                         (oz, 1 - oz, oy, 1 - oy, ox, 1 - ox))
            total = term if total is None else total + term
        return total

    def unit_products(self, u: torch.Tensor) -> torch.Tensor:
        """[ke_lam . u_e, ke_mu . u_e] per element, [..., 2, 24, nx, ny, nz]
        (one stacked matmul)."""
        u_e = self.gather_elements(u)
        batch, n = u_e.shape[:-4], u_e.shape[-3:]
        ke2 = torch.cat([self.ke_lam, self.ke_mu], dim=0)
        f2 = torch.matmul(ke2, u_e.reshape(*batch, 24, -1))
        return f2.reshape(*batch, 2, 24, *n)

    def apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        """K.u on the node grid (no BC masking)."""
        f2 = self.unit_products(u)
        return self.scatter_elements(
            self.lam_e.unsqueeze(-4) * f2[..., 0, :, :, :, :]
            + self.mu_e.unsqueeze(-4) * f2[..., 1, :, :, :, :])

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Masked SPD action on the grid: M K (M u) + (I - M) u."""
        m = self.free_mask
        return m * self.apply_raw(m * u) + (1.0 - m) * u

    def diagonal(self) -> torch.Tensor:
        """Masked Jacobi diagonal on the node grid."""
        d_lam = torch.diagonal(self.ke_lam)[:, None, None, None]
        d_mu = torch.diagonal(self.ke_mu)[:, None, None, None]
        d_e = (self.lam_e.unsqueeze(-4) * d_lam
               + self.mu_e.unsqueeze(-4) * d_mu)
        d = self.scatter_elements(d_e)
        return self.free_mask * d + (1.0 - self.free_mask)


def detect_structured(model: FEModel) -> Optional[dict]:
    """Detect a hex_beam-style structured grid; return its geometry or None.

    Requirements: HEX8 single formulation, nodes on an axis-aligned uniform
    lattice in meshgen order (id = i*nyz + j*(nz+1) + k), connectivity
    exactly the structured pattern.
    """
    if model.nelem == 0 or model.conn.shape[1] != 8:
        return None
    kinds = set(model.elem_type)
    if len(kinds) != 1 or not next(iter(kinds)).startswith("HEX8"):
        return None
    coords = np.asarray(model.coords)
    xs = np.unique(coords[:, 0])
    ys = np.unique(coords[:, 1])
    zs = np.unique(coords[:, 2])
    nnx, nny, nnz = len(xs), len(ys), len(zs)
    if nnx * nny * nnz != model.nnode:
        return None
    for arr in (xs, ys, zs):
        if len(arr) > 1 and not np.allclose(np.diff(arr), arr[1] - arr[0],
                                            rtol=1e-10, atol=1e-12):
            return None
    expect = np.stack(
        np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1
    ).reshape(-1, 3)
    if not np.allclose(coords, expect, rtol=1e-12, atol=1e-12):
        return None
    nx, ny, nz = nnx - 1, nny - 1, nnz - 1
    if nx * ny * nz != model.nelem:
        return None

    def nid(i, j, k):
        return i * nny * nnz + j * nnz + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    expect_conn = np.stack(
        [nid(I + dx, J + dy, K + dz) for dx, dy, dz in _CORNERS], axis=1
    )
    if not np.array_equal(np.asarray(model.conn), expect_conn):
        return None
    hx = xs[1] - xs[0] if nnx > 1 else 1.0
    hy = ys[1] - ys[0] if nny > 1 else 1.0
    hz = zs[1] - zs[0] if nnz > 1 else 1.0
    return {
        "nelems": (nx, ny, nz),
        "spacing": (float(hx), float(hy), float(hz)),
    }


def lame_fields(model: FEModel) -> tuple:
    """Per-element Lame constants (lam_e, mu_e), float64 [nelem], from the
    material records (0 for an element whose material id has no record)."""
    lam_e = np.zeros(model.nelem)
    mu_e = np.zeros(model.nelem)
    for mid, mat in model.materials.items():
        sel = np.asarray(model.elem_mat) == mid
        lam_e[sel] = (mat.E * mat.poisson) / (
            (1 - 2 * mat.poisson) * (1 + mat.poisson))
        mu_e[sel] = 0.5 * mat.E / (1 + mat.poisson)
    return lam_e, mu_e


def build_structured_operator(model: FEModel, *, dtype=None, device="cuda"
                              ) -> Optional[StructuredOperator]:
    """Build the structured-grid operator, or None if the mesh doesn't
    qualify."""
    dev = resolve_device(device)
    info = detect_structured(model)
    if info is None:
        return None
    return build_from_grid(model, info, dtype=dtype, device=dev)


def build_from_grid(model: FEModel, info: dict, *, dtype=None,
                    device="cuda") -> StructuredOperator:
    """The structured-grid operator of a model whose grid
    detect_structured(model) has already returned as ``info``."""
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    nx, ny, nz = info["nelems"]
    hx, hy, hz = info["spacing"]
    form = model.formulation()

    # ke is linear in D, and isotropic D = lam*D_lam + mu*D_mu, so
    # ke = lam*ke_lam + mu*ke_mu: two 24x24 float64 stiffnesses.
    corners = np.array([[dx * hx, dy * hy, dz * hz]
                        for dx, dy, dz in _CORNERS])[None]
    ke_lam = hostops.element_stiffness_np(
        corners, hostops.d_np(1.0, 0.0)[None], form)[0]
    ke_mu = hostops.element_stiffness_np(
        corners, hostops.d_np(0.0, 1.0)[None], form)[0]

    lam_e, mu_e = lame_fields(model)
    free = 1.0 - np.asarray(model.fix_mask(), dtype=np.float64)
    kw = dict(dtype=dtype, device=dev)
    return StructuredOperator(
        nelems=(nx, ny, nz),
        ke_lam=torch.as_tensor(ke_lam, **kw),
        ke_mu=torch.as_tensor(ke_mu, **kw),
        lam_e=torch.as_tensor(lam_e.reshape(nx, ny, nz), **kw),
        mu_e=torch.as_tensor(mu_e.reshape(nx, ny, nz), **kw),
        free_mask=torch.as_tensor(
            free.reshape(nx + 1, ny + 1, nz + 1, 3).transpose(3, 0, 1, 2), **kw),
        form=form,
    )
