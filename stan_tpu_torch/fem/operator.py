"""Global stiffness operator: matrix-free action, Jacobi diagonal, BC masks.

Port of stan_tpu/fem/operator.py. K.u is gather -> batched element
contraction (fem/kernels.py) -> scatter, and the scatter is a gather
through the transposed incidence map plus a sum over a small axis: no
atomics, so a solve gives the same bits on every run (``index_add_`` on
CUDA adds with atomics in a varying order). Fixed DOFs are masked, so the
operator is A = M K M + (I - M) and the right-hand side M f, with M the
free mask.

The operator also acts on a batch of systems: with D [B, E, 6, 6] (one
material field per system) it maps u [B, nnode, 3] to [B, nnode, 3]; the
geometry and the masks are shared.

Dtype and device policy (the counterpart of the JAX package's
default_dtype): the port computes in float32 on the card, with float64
certification of the result, and in float64 wherever the caller asks for it
(the CPU parity tests do). Entry points take ``device=`` (default
``"cuda"``) and never fall back to the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stan_tpu_torch.fem.elements import ElementFormulation
from stan_tpu_torch.fem import kernels


def default_dtype() -> torch.dtype:
    """float32: the port's working precision (results are certified in
    float64 by analysis/linear.py)."""
    return torch.float32


def resolve_device(device) -> torch.device:
    """The torch.device for ``device``; raises if it is CUDA and no card is
    visible. On CUDA it switches TF32 off: TF32 keeps about three decimal
    digits, which stalls CG (the JAX package pins HIGHEST precision on
    every contraction for the same reason)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested, but torch sees "
                               "no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


@dataclasses.dataclass(frozen=True)
class StiffnessOperator:
    """Matrix-free masked stiffness operator for one uniform element block.

      conn:      i64[E, nn] dense node indices
      dN:        [E, G, 3, nn] shape-function gradients
      detJw:     [E, G]
      D:         [E, 6, 6]
      free_mask: [nnode, 3] 1.0 where the DOF is free, 0.0 where fixed
      inc_idx:   i64[nnode, maxdeg] transposed incidence into the flattened
                 [E*nn (+1 zero row)] element-node axis (node_incidence)
    """

    conn: torch.Tensor
    dN: torch.Tensor
    detJw: torch.Tensor
    D: torch.Tensor
    free_mask: torch.Tensor
    nnode: int
    form: ElementFormulation
    inc_idx: torch.Tensor

    @property
    def dtype(self):
        return self.dN.dtype

    @property
    def device(self):
        return self.dN.device

    def gather(self, u: torch.Tensor) -> torch.Tensor:
        """u[..., nnode, 3] -> u_e[..., E, nn, 3]."""
        return u[..., self.conn, :]

    def scatter_add(self, f_e: torch.Tensor) -> torch.Tensor:
        """f_e[..., E, nn, 3] -> f[..., nnode, 3], deterministic (incidence
        gather)."""
        flat = f_e.reshape(*f_e.shape[:-3], -1, 3)
        padded = torch.cat([flat, flat.new_zeros((*flat.shape[:-2], 1, 3))],
                           dim=-2)
        return padded[..., self.inc_idx, :].sum(dim=-2)

    def apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        """K.u without BC masking; u and the result are [..., nnode, 3]."""
        f_e = kernels.internal_force(self.dN, self.detJw, self.D,
                                     self.gather(u))
        return self.scatter_add(f_e)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Masked SPD action A.u = M K (M u) + (1-M) u."""
        m = self.free_mask
        return m * self.apply_raw(m * u) + (1.0 - m) * u

    def diagonal(self) -> torch.Tensor:
        """Masked Jacobi diagonal [nnode, 3]: diag(K) at free DOFs, 1 at
        fixed ones."""
        d = self.scatter_add(_element_diag(self.dN, self.detJw, self.D))
        return self.free_mask * d + (1.0 - self.free_mask)


def _element_diag(dN, detJw, D):
    """diag(ke) as [..., E, nn, 3] for D [..., E, 6, 6], from the gradients
    without forming B.

    Column (n, j) of B has nonzeros in Voigt rows j and the two shear rows
    that involve direction j.
    """
    dx, dy, dz = dN[..., 0, :], dN[..., 1, :], dN[..., 2, :]  # [E, G, nn]
    zero = torch.zeros_like(dx)
    cols = [
        torch.stack([dx, zero, zero, dy, zero, dz], dim=-1),  # j=0
        torch.stack([zero, dy, zero, dx, dz, zero], dim=-1),  # j=1
        torch.stack([zero, zero, dz, zero, dy, dx], dim=-1),  # j=2
    ]
    out = []
    for c in cols:  # c: [E, G, nn, 6]
        dc = torch.einsum("...eij,egnj->...egni", D, c)
        out.append(torch.einsum("egni,...egni,eg->...en", c, dc, detJw))
    return torch.stack(out, dim=-1)


def node_incidence(conn: np.ndarray, nnode: int) -> np.ndarray:
    """Transposed incidence map for the gather-based scatter.

    Returns i64[nnode, maxdeg]: for each node, the positions in the
    flattened [E*nn] element-node axis that touch it; padding entries point
    one past the end (where scatter_add appends a zero row).
    """
    flat = np.asarray(conn).reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=nnode)
    maxdeg = int(counts.max()) if flat.size else 0
    starts = np.cumsum(counts) - counts
    pos = np.arange(flat.size) - starts[flat[order]]
    idx = np.full((nnode, maxdeg), flat.size, dtype=np.int64)
    idx[flat[order], pos] = order
    return idx


def build_operator(coords, conn, D_e, fix_mask, form: ElementFormulation, *,
                   dtype=None, device="cuda") -> StiffnessOperator:
    """Precompute the element geometry and build the masked operator."""
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    conn_np = np.asarray(conn)
    nnode = int(np.asarray(coords).shape[0])
    kw = dict(dtype=dtype, device=dev)
    coords_t = torch.as_tensor(np.asarray(coords), **kw)
    conn_t = torch.as_tensor(conn_np, dtype=torch.int64, device=dev)
    dN, detJw = kernels.element_geometry(coords_t[conn_t], form)
    return StiffnessOperator(
        conn=conn_t,
        dN=dN,
        detJw=detJw,
        D=torch.as_tensor(np.asarray(D_e), **kw),
        free_mask=1.0 - torch.as_tensor(np.asarray(fix_mask), **kw),
        nnode=nnode,
        form=form,
        inc_idx=torch.as_tensor(node_incidence(conn_np, nnode),
                                dtype=torch.int64, device=dev),
    )
