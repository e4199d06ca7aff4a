"""The (chains x domain) device mesh, and vectors sharded over it.

Port of stan_tpu/parallel/distributed.py for one process that drives every
device of the mesh itself, as JAX's single controller drives a Mesh under
shard_map:

  * DeviceMesh is a [chains, domain] array of torch.devices. A device may
    appear more than once (["cpu"] * 4 in the CPU tests, [cuda:0] * 4 on a
    one-card host), which plays the part of the reference's virtual CPU
    devices. A mesh whose devices are of more than one type is refused.
  * Slabs is a vector sharded over the mesh: block [r][s] lies on device
    [r, s]. The blocks of one row are consecutive along one axis (the
    domain decomposition); with ``chains`` the rows hold consecutive chains
    on axis 0 (the chain decomposition), else every row holds the same
    vector. Elementwise torch functions and operators act block by block,
    so solvers/cg.py runs on Slabs unchanged, given Slabs.dot as its
    reduction.
  * Slabs.dot reduces each block on its own device, copies the partials to
    the row's first device and sums them there in slab order, so a result
    does not depend on timing. Per-chain values then go to the mesh's
    first device.
  * Chain placement for the samplers (DeviceMesh.chain_rows, join_rows,
    by_rows): a chain-batched function evaluated row by row, row r's
    block of chains on the row's first device, the results joined in row
    order on the mesh's first device. The rows run one after another from
    the one host thread.

Every cut of chains over the rows is row_blocks (torch.tensor_split).

Several processes (torch.distributed, NCCL) are not ported: initialize
raises for more than one process.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

AXES = ("chains", "domain")


def canonical(device) -> torch.device:
    """torch.device(device), with a CUDA device's index filled in (the
    current card's), so that it compares equal to a tensor's device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def row_blocks(t: torch.Tensor, n_rows: int) -> tuple:
    """The chains of t (axis 0) cut into n_rows consecutive blocks, row r's
    block r: the one cut of chains over a mesh's rows."""
    return t.tensor_split(n_rows)


class DeviceMesh:
    """A [chains, domain] grid of torch.devices of one type."""

    def __init__(self, devices):
        shape = np.shape(np.array(devices, dtype=object))
        if len(shape) != 2 or 0 in shape:
            raise ValueError(f"a mesh is a non-empty [chains, domain] grid, "
                             f"got shape {shape}")
        grid = np.empty(shape, dtype=object)
        for r, s in np.ndindex(shape):
            grid[r, s] = canonical(devices[r][s])
        kinds = {d.type for d in grid.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's devices must be of one type, got "
                             f"{sorted(kinds)}")
        self.devices = grid
        self.axis_names = AXES

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def split(self, t: torch.Tensor, axis: int, chains: bool = False
              ) -> "Slabs":
        """t cut into equal blocks along `axis`, one per domain slab, each on
        its device; with `chains`, axis 0 is also cut into one block of
        chains per row, else every row gets the whole of it."""
        n_rows, n_slabs = self.devices.shape
        rows = row_blocks(t, n_rows) if chains else [t] * n_rows
        return Slabs([[b.to(dev).contiguous()
                       for b, dev in zip(row.tensor_split(n_slabs, dim=axis),
                                         self.devices[r])]
                      for r, row in enumerate(rows)], axis, chains)

    def per_chain(self, t: torch.Tensor) -> list:
        """[r][s]: row r's block of the chains of t (axis 0) on device
        [r, s]."""
        return [[row.to(dev) for dev in self.devices[r]]
                for r, row in enumerate(row_blocks(t, self.devices.shape[0]))]

    def row_devices(self, axis: str = "chains") -> list:
        """The first device of each block of `axis`: devices[r, 0] for the
        chains axis, devices[0, s] for the domain axis."""
        if axis not in self.axis_names:
            raise ValueError(f"no mesh axis {axis!r}; the axes are "
                             f"{self.axis_names}")
        return list(self.devices[:, 0] if axis == "chains"
                    else self.devices[0, :])

    def chain_rows(self, t: torch.Tensor, axis: str = "chains") -> list:
        """t's chains (axis 0) cut into one block per row of `axis`, block
        r on row r's first device. Refuses a chain count that the rows do
        not divide, as placing chains over a mesh axis does."""
        devs = self.row_devices(axis)
        if t.shape[0] % len(devs):
            raise ValueError(f"{t.shape[0]} chains not divisible by the "
                             f"{axis} mesh axis ({len(devs)})")
        return [b.to(dev) for b, dev in zip(row_blocks(t, len(devs)), devs)]

    def join_rows(self, blocks, device=None) -> torch.Tensor:
        """chain_rows' inverse: the blocks concatenated in row order on
        `device` (default: the mesh's first)."""
        device = self.devices[0, 0] if device is None else device
        return torch.cat([b.to(device) for b in blocks])

    def by_rows(self, fn, axis: str = "chains"):
        """fn, a chain-batched function of t [C, ...] to a tensor or a tuple
        of tensors with the chains on axis 0, evaluated row by row: row r's
        block of chains on its first device (chain_rows), the results
        joined in row order on t's device. Only the first device of a row
        evaluates: the rest of the row (its domain devices) is not used."""

        def placed(t):
            outs = [fn(b) for b in self.chain_rows(t, axis)]
            if isinstance(outs[0], tuple):
                return tuple(self.join_rows(parts, t.device)
                             for parts in zip(*outs))
            return self.join_rows(outs, t.device)

        return placed

    def replicate(self, t: torch.Tensor) -> list:
        """[r][s]: t on device [r, s]."""
        return [[t.to(dev) for dev in row] for row in self.devices]


class Slabs:
    """A vector sharded over a DeviceMesh (see the module docstring):
    parts[r][s] on device [r, s], slabs consecutive along `axis`, chains
    split over rows when `chains`."""

    def __init__(self, parts: list, axis: int, chains: bool = False):
        self.parts = parts
        self.axis = axis
        self.chains = chains

    @property
    def device(self) -> torch.device:
        return self.parts[0][0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0][0].dtype

    @property
    def shape(self) -> tuple:
        """The shape of the whole vector (gather()'s)."""
        shape = list(self.parts[0][0].shape)
        shape[self.axis] = sum(p.shape[self.axis] for p in self.parts[0])
        if self.chains:
            shape[0] = sum(row[0].shape[0] for row in self.parts)
        return tuple(shape)

    def dim(self) -> int:
        return self.parts[0][0].dim()

    def gather(self, device=None) -> torch.Tensor:
        """The whole vector on `device` (default: the mesh's first)."""
        device = self.device if device is None else device
        rows = [torch.cat([p.to(device) for p in row], dim=self.axis)
                for row in self.parts]
        return torch.cat(rows) if self.chains else rows[0]

    def dot(self, other) -> torch.Tensor:
        """Σ self·other: a scalar, or per chain ([chains], axis 0 of each
        block) when self holds chains; on the mesh's first device. other
        may be a Slabs of the same layout or one without chains that
        broadcasts against self's blocks."""
        out = []
        for row, orow in zip(self.parts, other.parts):
            home, acc = row[0].device, None
            for a, b in zip(row, orow):
                prod = a * b
                part = (prod.reshape(prod.shape[0], -1).sum(1) if self.chains
                        else torch.sum(prod)).to(home)
                acc = part if acc is None else acc + part
            out.append(acc.to(self.device))
        if self.chains:
            return torch.cat(out)
        if len(out) != 1:
            raise ValueError("a dot of vectors without chains needs a "
                             "one-row mesh")
        return out[0]

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        """func block by block. Each block sees a Slabs argument's own
        block, a tensor of per-chain values (axis 0 the chains) cut to its
        row's chains, and any tensor on its own device; the layout is that
        of the first argument holding chains, else of the first Slabs."""
        kwargs = kwargs or {}
        every = [a for a in (*args, *kwargs.values()) if isinstance(a, Slabs)]
        lead = next((a for a in every if a.chains), every[0])
        n_rows = len(lead.parts)
        n_chains = lead.shape[0] if lead.chains and n_rows > 1 else None

        def block(a, r, s, dev):
            if isinstance(a, Slabs):
                return a.parts[r][s]
            if isinstance(a, torch.Tensor):
                if n_chains is not None and a.dim() and \
                        a.shape[0] == n_chains:
                    a = row_blocks(a, n_rows)[r]
                return a.to(dev)
            return a

        parts = [[func(*(block(a, r, s, p.device) for a in args),
                       **{k: block(v, r, s, p.device)
                          for k, v in kwargs.items()})
                  for s, p in enumerate(row)]
                 for r, row in enumerate(lead.parts)]
        return Slabs(parts, lead.axis, lead.chains)

    def __add__(self, o):
        return torch.add(self, o)

    def __radd__(self, o):
        return torch.add(o, self)

    def __sub__(self, o):
        return torch.sub(self, o)

    def __rsub__(self, o):
        return torch.sub(o, self)

    def __mul__(self, o):
        return torch.mul(self, o)

    def __rmul__(self, o):
        return torch.mul(o, self)

    def __truediv__(self, o):
        return torch.div(self, o)

    def __rtruediv__(self, o):
        return torch.div(o, self)

    def __ne__(self, o):
        return torch.ne(self, o)

    def __neg__(self):
        return torch.neg(self)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """A no-op for one process, so callers may call it unconditionally.
    Several processes over torch.distributed and NCCL are not ported
    (ROADMAP.md queue 1, item 10c): it raises for them."""
    if num_processes is None:
        num_processes = int(os.environ.get("STAN_TPU_NUM_PROCESSES", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return
    raise NotImplementedError(
        "several processes (torch.distributed, NCCL) are not ported: "
        "ROADMAP.md queue 1, item 10c; one process drives every device of "
        "a DeviceMesh")


def device_mesh(n_chains: int = 1, n_domain: Optional[int] = None,
                devices: Optional[Sequence] = None) -> DeviceMesh:
    """The (chains, domain) mesh over `devices` (default: the visible CUDA
    cards). ``n_domain=None`` takes every remaining device. Raises
    ValueError if the extents do not fit the devices (refuse, do not
    shrink)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("device_mesh: torch sees no CUDA device; pass "
                               "devices= (e.g. ['cpu'] * 4)")
    devs = [torch.device(d) for d in devices]
    if n_domain is None:
        if len(devs) % n_chains:
            raise ValueError(
                f"{len(devs)} devices not divisible by chains={n_chains}")
        n_domain = len(devs) // n_chains
    need = n_chains * n_domain
    if need > len(devs):
        raise ValueError(f"mesh {n_chains}x{n_domain} needs {need} devices, "
                         f"have {len(devs)}")
    return DeviceMesh([devs[r * n_domain:(r + 1) * n_domain]
                       for r in range(n_chains)])


def describe(mesh: DeviceMesh) -> str:
    """One-line summary for logs."""
    shape = mesh.shape
    kinds = {d.type for d in mesh.devices.flat}
    distinct = len(set(mesh.devices.flat))
    return (f"mesh chains={shape['chains']} x domain={shape['domain']} on "
            f"{mesh.devices.size} {'/'.join(sorted(kinds))} device(s) "
            f"({distinct} distinct)")
