"""The general stiffness operator and its CG over a device mesh.

Port of stan_tpu/parallel/sharded.py. The mesh is cut by the BFS
partition of parallel/partition.py: device d of the domain axis owns node
block d (new numbering) and the elements assigned to it. Two exchange
modes, chosen when the operator is built:

  * ring (preferred): when every element's nodes lie in its owner's block
    or a neighbour's, a device needs only its two neighbours' blocks. It
    copies them to itself (left | own | right, numbered by conn_ext),
    computes its elements' forces over that extended range, keeps its own
    third and adds the thirds its neighbours computed for it;
  * all-gather: every device copies the whole padded node vector to
    itself, computes its elements' forces over all nodes, and each block's
    sum is taken over the devices in order (the reference's
    psum_scatter). Correct for any partition.

The device code is plain torch, as it is XLA in the reference: the
element forces of fem/kernels.internal_force, and each node's sum a gather
through the transposed incidence map plus a sum over a small axis (no
index_add_, so a solve gives the same bits on every run). Over several
processes each computes the forces of its own blocks, and every block it
needs from another process, or sends to one, goes through the mesh's
transport (DeviceMesh.exchange), two rounds per apply; every sum is taken
in device order, so the bits are those of one process.

Array layout: node arrays [nnode_pad, 3] with nnode_pad = ndev * block;
element arrays [ndev * epb, ...], device d's slice d*epb:(d+1)*epb.
Padding nodes are fixed, so the masked operator pins them at zero;
padding elements have conn 0 and zero D and detJw.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stan_tpu_torch.fem import kernels
from stan_tpu_torch.fem.elements import ElementFormulation
from stan_tpu_torch.fem.operator import (_element_diag, default_dtype,
                                         node_incidence, resolve_device)
from stan_tpu_torch.parallel.distributed import DeviceMesh, Move, Slabs
from stan_tpu_torch.parallel.partition import (Partition,
                                               partition as make_partition)
from stan_tpu_torch.solvers import cg as cg_mod


@dataclasses.dataclass(frozen=True)
class ShardedOperator:
    """Masked stiffness operator in the global padded layout.

      conn:      i64[ndev*epb, nn]   (new node numbering, 0..nnode_pad)
      dN:        [ndev*epb, G, 3, nn]
      detJw:     [ndev*epb, G]
      D:         [ndev*epb, 6, 6]
      free_mask: [nnode_pad, 3]
      diag:      [nnode_pad, 3]
      inc_idx:   i64[ndev, nnode_pad, maxdeg]  each device's incidence
                 transpose (all-gather mode; operator.node_incidence)
      conn_ext:  i64[ndev*epb, nn]   extended-local numbering, ring mode
                 (index into [3*block): left halo | own | right halo)
      inc_ext:   i64[ndev, 3*block, maxdeg]    incidence over the extended
                 range, ring mode
    """

    conn: torch.Tensor
    dN: torch.Tensor
    detJw: torch.Tensor
    D: torch.Tensor
    free_mask: torch.Tensor
    diag: torch.Tensor
    nnode_pad: int
    block: int
    form: ElementFormulation
    inc_idx: Optional[torch.Tensor] = None
    ring: bool = False
    conn_ext: Optional[torch.Tensor] = None
    inc_ext: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _Block:
    """Device d's share of the operator, on its device."""

    conn: torch.Tensor   # conn_ext in ring mode
    inc: torch.Tensor    # inc_ext[d] in ring mode, inc_idx[d] otherwise
    dN: torch.Tensor
    detJw: torch.Tensor
    D: torch.Tensor


def _place(mesh: DeviceMesh, op: ShardedOperator):
    """(the devices' blocks, None where another process owns one; free mask
    and diagonal as Slabs) on a one-row mesh whose domain axis has one
    device per block."""
    devs = mesh.devices[0]
    ndev = op.nnode_pad // op.block
    if mesh.shape["chains"] != 1 or len(devs) != ndev:
        raise ValueError(f"the operator is cut for a 1 x {ndev} mesh, got "
                         f"{mesh.shape}")
    epb = op.conn.shape[0] // ndev
    conn, inc = ((op.conn_ext, op.inc_ext) if op.ring
                 else (op.conn, op.inc_idx))
    blocks = []
    for d, dev in enumerate(devs):
        e = slice(d * epb, (d + 1) * epb)
        blocks.append(_Block(conn[e].to(dev), inc[d].to(dev), op.dN[e].to(dev),
                             op.detJw[e].to(dev), op.D[e].to(dev))
                      if mesh.is_local(0, d) else None)
    return blocks, mesh.split(op.free_mask, 0), mesh.split(op.diag, 0)


def _element_forces(blk: _Block, u_src: torch.Tensor) -> torch.Tensor:
    """Σ over the block's elements of their forces, per node of the range
    u_src covers ([N, 3] -> [N, 3])."""
    f_e = kernels.internal_force(blk.dN, blk.detJw, blk.D, u_src[blk.conn])
    flat = f_e.reshape(-1, 3)
    padded = torch.cat([flat, flat.new_zeros((1, 3))])
    return padded[blk.inc].sum(dim=1)


def _rows(t: Optional[torch.Tensor], lo: int, hi: int):
    return None if t is None else t[lo:hi]


def _empty(like: Optional[torch.Tensor], rows: int):
    return None if like is None else like.new_empty((rows, 3))


def _gather_scatter_apply(mesh, blocks, um: list, b: int) -> list:
    """all-gather mode: every device's forces over the whole padded vector,
    then block d summed over the devices in order, on device d."""
    n = len(um)
    whole = [_empty(own, n * b) for own in um]
    mesh.exchange([Move((0, e), (0, d), um[e], _rows(whole[d], e * b,
                                                     (e + 1) * b))
                   for d in range(n) for e in range(n)])
    partial = [None if blk is None else _element_forces(blk, w)
               for blk, w in zip(blocks, whole)]
    terms = [[_empty(own, b) for _ in range(n)] for own in um]
    mesh.exchange([Move((0, e), (0, d), _rows(partial[e], d * b,
                                              (d + 1) * b), terms[d][e])
                   for d in range(n) for e in range(n)])
    out = []
    for row in terms:
        acc = None
        for term in row:
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def _ring_apply(mesh, blocks, um: list, b: int) -> list:
    """ring mode: the neighbours' blocks in, the neighbours' thirds of the
    forces back."""
    n = len(um)
    ext = [_empty(own, 3 * b) for own in um]
    for x, own in zip(ext, um):
        if x is not None:
            x[b:2 * b] = own
    mesh.exchange([mv for d in range(n) for mv in (
        Move((0, (d - 1) % n), (0, d), um[(d - 1) % n], _rows(ext[d], 0, b)),
        Move((0, (d + 1) % n), (0, d), um[(d + 1) % n],
             _rows(ext[d], 2 * b, 3 * b)))])
    f_ext = [None if blk is None else _element_forces(blk, x)
             for blk, x in zip(blocks, ext)]
    left = [_empty(own, b) for own in um]
    right = [_empty(own, b) for own in um]
    mesh.exchange([mv for d in range(n) for mv in (
        Move((0, (d - 1) % n), (0, d), _rows(f_ext[(d - 1) % n], 2 * b,
                                             3 * b), left[d]),
        Move((0, (d + 1) % n), (0, d), _rows(f_ext[(d + 1) % n], 0, b),
             right[d]))])
    return [None if f is None else f[b:2 * b] + lt + rt
            for f, lt, rt in zip(f_ext, left, right)]


def _local_apply(op: ShardedOperator, blocks, m: Slabs, u: Slabs) -> Slabs:
    """Masked SpMV M K (M u) + (I - M) u over the devices."""
    um = (m * u).parts[0]
    exchange = _ring_apply if op.ring else _gather_scatter_apply
    f = u.like([exchange(u.mesh, blocks, um, op.block)])
    return m * f + (1.0 - m) * u


def build_sharded_operator(
    coords: np.ndarray,
    conn: np.ndarray,
    D_e: np.ndarray,
    fix_mask: np.ndarray,
    form: ElementFormulation,
    ndev: int,
    dtype=None,
    prefer_ring: bool = True,
    device="cuda",
) -> tuple[ShardedOperator, Partition]:
    """Partition the mesh and lay out the padded sharded arrays (on
    `device`; the partition is host numpy).

    When every element's (new-numbered) nodes fall inside its owner's
    block or a neighbour's, as BFS blocks of meshes whose frontier fits in
    a block give, the ring mode is chosen (prefer_ring); otherwise the
    all-gather mode.
    """
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    conn = np.asarray(conn)
    nnode = np.asarray(coords).shape[0]
    part = make_partition(conn, nnode, ndev)

    # Geometry in the original element order, then into the shard slots.
    kw = dict(dtype=dtype, device=dev)
    coords_t = torch.as_tensor(np.asarray(coords), **kw)
    dN, detJw = kernels.element_geometry(
        coords_t[torch.as_tensor(conn, device=dev)], form)
    nn = conn.shape[1]
    ne_pad = ndev * part.epb
    slot = torch.as_tensor(part.elem_owner * part.epb + part.elem_pos,
                           device=dev)
    dN_sh = dN.new_zeros((ne_pad, form.ngp, 3, nn))
    detJw_sh = dN.new_zeros((ne_pad, form.ngp))
    D_sh = dN.new_zeros((ne_pad, 6, 6))
    dN_sh[slot] = dN
    detJw_sh[slot] = detJw
    D_sh[slot] = torch.as_tensor(np.asarray(D_e), **kw)

    # Node masks in the new numbering; padding nodes are fixed.
    free = np.zeros((part.nnode_pad, 3), dtype=np.float64)
    free[part.perm] = 1.0 - np.asarray(fix_mask, dtype=np.float64)

    conn_flat = part.conn.reshape(ne_pad, nn)
    b = part.block

    # Ring compatibility: every element's nodes within owner-1..owner+1.
    owners_flat = np.repeat(np.arange(ndev), part.epb)
    node_dev = conn_flat // b  # device owning each referenced node
    pad_flat = part.pad_elem.reshape(-1)
    delta = node_dev - owners_flat[:, None]
    ring_ok = prefer_ring and ndev > 1 and bool(
        np.all((np.abs(delta) <= 1) | pad_flat[:, None]))

    def stacked(rows_of, width):
        """Each device's incidence over `width` nodes, padded to one
        maxdeg with the index one past its element-node axis."""
        incs = [node_incidence(rows_of(d), width) for d in range(ndev)]
        maxdeg = max(i.shape[1] for i in incs)
        out = np.full((ndev, width, maxdeg), part.epb * nn, dtype=np.int64)
        for d, i in enumerate(incs):
            out[d, :, :i.shape[1]] = i
        return torch.as_tensor(out, device=dev)

    conn_ext = inc_ext = inc = None
    if ring_ok:
        # Extended-local numbering: index into [left | own | right] blocks.
        # Padding elements (conn 0) of devices > 1 would go negative; clamp
        # them into the (inert) local range.
        conn_ext_np = np.clip(conn_flat - (owners_flat[:, None] - 1) * b,
                              0, 3 * b - 1)
        conn_ext = torch.as_tensor(conn_ext_np, device=dev)
        inc_ext = stacked(
            lambda d: conn_ext_np[d * part.epb:(d + 1) * part.epb], 3 * b)
    else:
        inc = stacked(lambda d: part.conn[d], part.nnode_pad)

    free_t = torch.as_tensor(free, **kw)
    # Jacobi diagonal (set-up, over all elements at once).
    d_e = _element_diag(dN_sh, detJw_sh, D_sh).reshape(-1, 3)
    padded = torch.cat([d_e, d_e.new_zeros((1, 3))])
    d = padded[torch.as_tensor(node_incidence(conn_flat, part.nnode_pad),
                               device=dev)].sum(dim=1)
    op = ShardedOperator(
        conn=torch.as_tensor(conn_flat, device=dev),
        dN=dN_sh, detJw=detJw_sh, D=D_sh, free_mask=free_t,
        diag=free_t * d + (1.0 - free_t),
        nnode_pad=part.nnode_pad, block=b, form=form, inc_idx=inc,
        ring=ring_ok, conn_ext=conn_ext, inc_ext=inc_ext)
    return op, part


def sharded_apply(mesh: DeviceMesh, op: ShardedOperator, u: torch.Tensor
                  ) -> torch.Tensor:
    """Masked K·u of u [nnode_pad, 3] over the mesh, on u's device (one
    apply, for tests)."""
    blocks, m, _ = _place(mesh, op)
    return _local_apply(op, blocks, m, mesh.split(u, 0)).gather(u.device)


def sharded_pcg(mesh: DeviceMesh, op: ShardedOperator, f: torch.Tensor, *,
                tol: float = 1e-6, maxiter: int = 0) -> cg_mod.CGResult:
    """Jacobi PCG over the mesh's domain axis.

    f: [nnode_pad, 3] right-hand side in the new node numbering (padding
    rows zero). Returns the CGResult with u in the same layout, on f's
    device."""
    blocks, m, diag = _place(mesh, op)
    res = cg_mod.pcg(lambda u: _local_apply(op, blocks, m, u),
                     m * mesh.split(f, 0), diag=diag, tol=tol,
                     maxiter=maxiter, ndof=op.nnode_pad * 3, dot=Slabs.dot)
    return res._replace(u=res.u.gather(f.device))


def shard_rhs(part: Partition, loads: np.ndarray) -> np.ndarray:
    """[nnode, 3] loads (old numbering) -> padded [nnode_pad, 3] (new)."""
    f = np.zeros((part.nnode_pad, 3), dtype=np.float64)
    f[part.perm] = np.asarray(loads)
    return f


def unshard_u(part: Partition, u: np.ndarray) -> np.ndarray:
    """Padded solution [nnode_pad, 3] (new numbering) -> [nnode, 3] (old)."""
    return np.asarray(u)[part.perm]
