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

On a CUDA tensor the masked action is the two hand-written kernels of
csrc/general_apply.cu (general_apply: an element kernel and a node pass,
also without atomics); on a CPU tensor it is the plain gather, einsums and
scatter above (StiffnessOperator.apply_reference). fem/launches counts the
CUDA applies under general_apply.

Dtype and device policy (the counterpart of the JAX package's
default_dtype): the port computes in float32 on the card, with float64
certification of the result, and in float64 wherever the caller asks for it
(the CPU parity tests do). Entry points take ``device=`` (default
``"cuda"``) and never fall back to the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from stan_tpu_torch import _build
from stan_tpu_torch.fem.elements import ElementFormulation
from stan_tpu_torch.fem import kernels, launches

# (nodes, Gauss points) of the formulations the kernels are built for.
_SHAPES = ((8, 8), (8, 1), (4, 4), (4, 1))


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
    # int32 copies of conn and inc_idx for the kernels, made at the first
    # CUDA apply (index32) and shared by the operators with_D builds.
    _index32: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)

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
        """Masked SPD action A.u = M K (M u) + (1-M) u. A CPU tensor takes
        apply_reference; a CUDA tensor launches general_apply's kernels, or
        raises."""
        if u.device.type == "cpu":
            return self.apply_reference(u)
        conn32, inc32 = self.index32()
        return general_apply(u, self.free_mask, conn32, self.dN, self.detJw,
                             self.D, inc32)

    def apply_reference(self, u: torch.Tensor) -> torch.Tensor:
        """apply in plain PyTorch: gather, fem/kernels.internal_force's
        einsums, the incidence scatter."""
        m = self.free_mask
        return m * self.apply_raw(m * u) + (1.0 - m) * u

    def index32(self) -> tuple:
        """(conn, inc_idx) as int32, made once and kept with the operator."""
        if not self._index32:
            for name in ("conn", "inc_idx"):
                self._index32[name] = getattr(self, name).to(
                    torch.int32).contiguous()
        return self._index32["conn"], self._index32["inc_idx"]

    def with_D(self, D: torch.Tensor) -> "StiffnessOperator":
        """The operator of the same mesh and masks with D replaced; it
        shares this operator's int32 index copies."""
        op = dataclasses.replace(self, D=D)
        object.__setattr__(op, "_index32", self._index32)
        return op

    def diagonal(self) -> torch.Tensor:
        """Masked Jacobi diagonal [nnode, 3]: diag(K) at free DOFs, 1 at
        fixed ones."""
        d = self.scatter_add(_element_diag(self.dN, self.detJw, self.D))
        return self.free_mask * d + (1.0 - self.free_mask)


def general_apply(u: torch.Tensor, free_mask: torch.Tensor,
                  conn32: torch.Tensor, dN: torch.Tensor, detJw: torch.Tensor,
                  D: torch.Tensor, inc32: torch.Tensor) -> torch.Tensor:
    """The masked action m·K(m·u) + (1-m)·u by the kernels of
    csrc/general_apply.cu, on the current stream.

    u [nnode, 3] or [B, nnode, 3]; free_mask [nnode, 3]; conn32 i32[E, nn];
    dN [E, G, 3, nn]; detJw [E, G]; D [E, 6, 6] (shared) or [B, E, 6, 6];
    inc32 i32[nnode, maxdeg] (node_incidence). The floating tensors share
    float32 or float64; (nn, G) is a formulation's (HEX8_G1/G2, TET4_G1/
    G2); every tensor is on one CUDA device and contiguous, except that dN
    and detJw may take any element and Gauss-point strides (element_geometry
    lays them out Gauss-point major) and D any system and element strides
    (0 where one D is expanded over the elements, as the general forward
    passes a homogeneous material), as long as each [3, nn] slice of dN and
    each 6 x 6 of D is contiguous and starts on 16 bytes. Raises on anything
    else, and on an input that asks for a gradient: the kernels are not
    differentiated. Returns a tensor shaped like u.
    """
    floats = (u, free_mask, dN, detJw, D)
    if u.dtype not in (torch.float32, torch.float64) or any(
            t.dtype != u.dtype for t in floats):
        raise TypeError("general_apply: u, free_mask, dN, detJw and D must "
                        "share float32 or float64, got "
                        f"{[str(t.dtype) for t in floats]}")
    if conn32.dtype != torch.int32 or inc32.dtype != torch.int32:
        raise TypeError(f"general_apply: conn32 and inc32 must be int32, got "
                        f"{conn32.dtype} and {inc32.dtype}")
    if dN.dim() != 4 or dN.shape[2] != 3:
        raise ValueError(f"general_apply: dN must be [E, G, 3, nn], got "
                         f"{tuple(dN.shape)}")
    E, G, _, nn = dN.shape
    if (nn, G) not in _SHAPES:
        raise ValueError(f"general_apply: no kernel for {nn} nodes and {G} "
                         f"Gauss points (HEX8_G1/G2, TET4_G1/G2 only)")
    if u.dim() not in (2, 3) or u.shape[-1] != 3:
        raise ValueError(f"general_apply: u must be [nnode, 3] or [B, nnode, "
                         f"3], got {tuple(u.shape)}")
    nnode = u.shape[-2]
    B = u.shape[0] if u.dim() == 3 else 1
    if D.dim() == 4 and u.dim() != 3:
        raise ValueError(f"general_apply: a D per system {tuple(D.shape)} "
                         f"needs u [B, nnode, 3], got {tuple(u.shape)}")
    shapes = {"free_mask": (free_mask, (nnode, 3)),
              "conn32": (conn32, (E, nn)), "detJw": (detJw, (E, G)),
              "D": (D, (E, 6, 6) if D.dim() == 3 else (B, E, 6, 6)),
              "inc32": (inc32, (nnode, inc32.shape[-1]))}
    for name, (t, want) in shapes.items():
        if t.dim() != len(want) or tuple(t.shape) != want:
            raise ValueError(f"general_apply: {name} must be {list(want)}, "
                             f"got {tuple(t.shape)}")
    if not 1 <= B <= 65535 or max(E * nn, 3 * nnode) >= 2**31:
        raise ValueError(f"general_apply: {B} systems (1 to 65535), {E * nn} "
                         f"element nodes and {3 * nnode} DOF (under 2^31)")
    tensors = (u, free_mask, conn32, dN, detJw, D, inc32)
    if not all(t.is_contiguous() for t in (u, free_mask, conn32, inc32)):
        raise ValueError("general_apply: u, free_mask, conn32 and inc32 must "
                         "be contiguous")
    vec = 16 // u.element_size()  # values in 16 bytes
    for name, t, inner in (("dN", dN, (nn, 1)), ("D", D, (6, 1))):
        if (t.stride()[-2:] != inner or any(s % vec for s in t.stride()[:-2])
                or t.data_ptr() % 16):
            raise ValueError(f"general_apply: {name}'s last two axes must be "
                             f"contiguous and every slice of them start on 16 "
                             f"bytes; strides {t.stride()}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in floats):
        raise ValueError("general_apply: the kernels are not differentiated; "
                         "call it under torch.no_grad()")
    if u.device.type != "cuda" or any(t.device != u.device for t in tensors):
        raise ValueError("general_apply: every tensor must be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    f_e = torch.empty((B, E, nn, 3), dtype=u.dtype, device=u.device)
    out = torch.empty_like(u)
    lib = _build.library("general_apply")
    fn = (lib.general_apply_f32 if u.dtype == torch.float32
          else lib.general_apply_f64)
    ptr = [ctypes.c_void_p(t.data_ptr())
           for t in (u, free_mask, conn32, dN, detJw, D, inc32, f_e, out)]
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        d_strides = D.stride()[:2] if D.dim() == 4 else (0, D.stride(0))
        code = fn(*ptr, B, E, nn, G, nnode, inc32.shape[-1], *d_strides,
                  *dN.stride()[:2], *detJw.stride(), ctypes.c_void_p(stream))
    _build.check(code, "general_apply launch", "general_apply")
    launches.count("general_apply")
    return out


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
