"""Several processes, the (chains x domain) device mesh, and vectors sharded
over it.

Port of stan_tpu/parallel/distributed.py. One process may drive every
device of a mesh, as JAX's single controller drives a Mesh under
shard_map; after initialize(), N processes run the same program (SPMD, as
a JAX multi-controller does) and each drives only the blocks on its own
devices:

  * initialize joins N processes over torch.distributed (gloo or NCCL);
    devices() is then the global device list, process-major, as
    jax.devices() orders it. A global device is a Device(process, device):
    cuda:0 on process 1 is not cuda:0 on process 0.
  * DeviceMesh is a [chains, domain] grid of devices of one type with the
    owning process of each. A device may appear more than once (["cpu"] *
    4 in the CPU tests, [cuda:0] * 4 on a one-card host), which plays the
    part of the reference's virtual CPU devices. A mesh of plain devices
    is this process's own; a mesh of global devices under several
    processes spans them (``spmd``), and every process must own a device
    of it. ``home`` is this process's first device of the mesh: the
    sampler state and every per-chain or whole result live there,
    replicated on every process.
  * Slabs is a vector sharded over the mesh: block [r][s] lies on device
    [r, s], None where another process owns it. The blocks of one row are
    consecutive along one axis (the domain decomposition); with
    ``chains`` the rows hold consecutive chains on axis 0 (the chain
    decomposition), else every row holds the same vector. Elementwise
    torch functions and operators act block by block, so solvers/cg.py
    runs on Slabs unchanged, given Slabs.dot as its reduction.
  * Slabs.dot reduces each block on its own device and sums the partials
    in slab order, so a result does not depend on timing; across
    processes the partials are first made whole on every process by one
    all_reduce in which each entry has one contributor (all_sum), so
    every process sums the same bits in the same order and its CG takes
    the same branches as every other's.
  * DeviceMesh.exchange is the one transport between blocks: a copy on
    this process, a send/receive pair between processes, posted as one
    batch per round in the same order on every process.
  * Chain placement for the samplers (DeviceMesh.chain_rows, join_rows,
    by_rows): a chain-batched function evaluated row by row, row r's
    block of chains on the row's first device, the results joined in row
    order on home (across processes by all_sum). The rows of one process
    run one after another from its one host thread.

Under gloo a CUDA tensor crosses processes through pinned host memory,
copied there and back explicitly. Every cut of chains over the rows is
row_blocks (torch.tensor_split).
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("chains", "domain")


class Device(NamedTuple):
    """A device of the global list: the process that owns it and the
    torch.device as that process names it."""

    process: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class _Runtime:
    backend: str
    local: tuple    # this process's torch.devices
    devices: tuple  # every process's, as Devices, process-major


# Set once by initialize(); None in a one-process run.
_runtime: Optional[_Runtime] = None


def process_index() -> int:
    return dist.get_rank() if _runtime is not None else 0


def process_count() -> int:
    return dist.get_world_size() if _runtime is not None else 1


def backend() -> Optional[str]:
    """The transport's backend ("gloo", "nccl"), None in one process."""
    return None if _runtime is None else _runtime.backend


def devices() -> list:
    """The global device list, process-major: every process's local
    devices after initialize(), else this process's visible CUDA cards."""
    if _runtime is not None:
        return list(_runtime.devices)
    return [Device(0, torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


def canonical(device) -> torch.device:
    """torch.device(device), with a CUDA device's index filled in (the
    current card's), so that it compares equal to a tensor's device. Only
    a local device's index can be filled in."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def row_blocks(t: torch.Tensor, n_rows: int) -> tuple:
    """The chains of t (axis 0) cut into n_rows consecutive blocks, row r's
    block r: the one cut of chains over a mesh's rows."""
    return t.tensor_split(n_rows)


def _sizes(n: int, k: int) -> list:
    """The lengths of tensor_split's k pieces of n."""
    return [n // k + (i < n % k) for i in range(k)]


def _offsets(sizes: list) -> list:
    return np.concatenate([[0], np.cumsum(sizes)]).tolist()


# ------------------------------------------------------------ transport

def _wire(t: torch.Tensor) -> torch.Tensor:
    """t as the transport sends it: under gloo a CUDA tensor goes through
    pinned host memory (gloo's own CUDA support is not relied on)."""
    if _runtime.backend == "gloo" and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)
    if _runtime.backend == "nccl" and not t.is_cuda:
        return t.to(_runtime.local[0])
    return t.contiguous()


def _landing(out: torch.Tensor) -> torch.Tensor:
    """The buffer a tensor for `out` is received into (out itself where
    the backend can write it directly)."""
    if _runtime.backend == "gloo" and out.is_cuda:
        return torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    if _runtime.backend == "nccl" and not out.is_cuda:
        return torch.empty(out.shape, dtype=out.dtype,
                           device=_runtime.local[0])
    return out if out.is_contiguous() else torch.empty_like(
        out, memory_format=torch.contiguous_format)


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over every process (all_reduce SUM), in place, on t's
    device; a collective, so every process calls it in the same order.
    Callers fill the entries another process owns with -0.0, the identity
    of IEEE addition (x + -0.0 == x for every x, -0.0 and NaN included),
    so every process gets every owner's entries bit for bit."""
    wire = _wire(t)
    dist.all_reduce(wire)
    if wire is not t:
        t.copy_(wire)
    return t


class Move(NamedTuple):
    """One transfer of an exchange round: block src's tensor `t` (None on a
    process that does not own src) copied into `out` on block dst's device
    (None on a process that does not own dst). src and dst are (r, s)."""

    src: tuple
    dst: tuple
    t: Optional[torch.Tensor]
    out: Optional[torch.Tensor]


# ---------------------------------------------------------------- mesh

class DeviceMesh:
    """A [chains, domain] grid of devices of one type (module docstring)."""

    def __init__(self, devices):
        rows = [None if isinstance(row, (str, torch.device, Device))
                else list(row) for row in devices]
        if not rows or None in rows or len({len(r) for r in rows}) != 1 \
                or not rows[0]:
            raise ValueError(f"a mesh is a non-empty [chains, domain] grid, "
                             f"got {devices!r}")
        shape = (len(rows), len(rows[0]))
        entries = [rows[r][s] for r, s in np.ndindex(shape)]
        glob = {isinstance(d, Device) for d in entries}
        if len(glob) != 1:
            raise ValueError("a mesh's devices are all global (Device) or "
                             "all this process's own")
        me = process_index()
        grid = np.empty(shape, dtype=object)
        procs = np.empty(shape, dtype=np.int64)
        for (r, s), d in zip(np.ndindex(shape), entries):
            p, dev = (d.process, d.device) if glob == {True} else (me, d)
            procs[r, s] = p
            grid[r, s] = canonical(dev) if p == me else torch.device(dev)
        if procs.max() >= process_count():
            raise ValueError(f"a mesh names process {procs.max()}; the "
                             f"runtime has {process_count()}")
        kinds = {d.type for d in grid.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's devices must be of one type, got "
                             f"{sorted(kinds)}")
        self.devices = grid
        self.processes = procs
        self.axis_names = AXES
        self.spmd = glob == {True} and process_count() > 1
        if self.spmd:
            idle = sorted(set(range(process_count())) - set(procs.flat))
            if idle:
                raise ValueError(
                    f"process(es) {idle} own no device of the "
                    f"{shape[0]}x{shape[1]} mesh: every process takes part "
                    f"in a mesh's exchanges; pass devices= that give each "
                    f"one a block")
        self.home = next(grid[r, s] for r, s in np.ndindex(shape)
                         if procs[r, s] == me)
        # [r][s]: device [r, s] where this process owns it, else None.
        self.owned = [[grid[r, s] if procs[r, s] == me else None
                       for s in range(shape[1])] for r in range(shape[0])]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def is_local(self, r: int, s: int) -> bool:
        """Whether this process owns device [r, s]."""
        return self.owned[r][s] is not None

    def _here(self, r, s, fn):
        dev = self.owned[r][s]
        return None if dev is None else fn(dev)

    def split(self, t: torch.Tensor, axis: Optional[int],
              chains: bool = False) -> "Slabs":
        """t cut into blocks along `axis`, one per domain slab, each on its
        device (None where another process owns it); with `chains`, axis 0
        is also cut into one block of chains per row, else every row gets
        the whole of it. axis None: every slab of a row gets the row's
        whole block (a per-chain value, say)."""
        n_rows, n_slabs = self.devices.shape
        rows = row_blocks(t, n_rows) if chains else [t] * n_rows
        parts = []
        for r, row in enumerate(rows):
            pieces = (row.tensor_split(n_slabs, dim=axis) if axis is not None
                      else [row] * n_slabs)
            parts.append([self._here(r, s, lambda dev, b=b:
                                     b.to(dev).contiguous())
                          for s, b in enumerate(pieces)])
        return Slabs(self, parts, axis, chains, tuple(t.shape))

    def per_chain(self, t: torch.Tensor) -> list:
        """[r][s]: row r's block of the chains of t (axis 0) on device
        [r, s] (None where another process owns it)."""
        return self.split(t, None, chains=True).parts

    def replicate(self, t: torch.Tensor) -> list:
        """[r][s]: t on device [r, s] (None where another process owns
        it)."""
        return [[self._here(r, s, t.to) for s in range(self.devices.shape[1])]
                for r in range(self.devices.shape[0])]

    def exchange(self, moves: Sequence[Move]) -> None:
        """One exchange round (the transport): each move's t into its out,
        a copy where this process owns both blocks, a send or a receive
        where it owns one, nothing where it owns neither. The transfers
        between processes are posted as one batch_isend_irecv in the order
        of `moves`, which every process gives alike, and awaited."""
        ops, landed = [], []
        for tag, (src, dst, t, out) in enumerate(moves):
            if t is not None and out is not None:
                out.copy_(t)
            elif t is not None:
                ops.append(dist.P2POp(dist.isend, _wire(t),
                                      int(self.processes[dst]), tag=tag))
            elif out is not None:
                buf = _landing(out)
                ops.append(dist.P2POp(dist.irecv, buf,
                                      int(self.processes[src]), tag=tag))
                landed.append((out, buf))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for out, buf in landed:
            if buf is not out:
                out.copy_(buf)

    def _row_heads(self, axis: str) -> list:
        """The (r, s) of the first device of each block of `axis`."""
        if axis not in self.axis_names:
            raise ValueError(f"no mesh axis {axis!r}; the axes are "
                             f"{self.axis_names}")
        n_rows, n_slabs = self.devices.shape
        return ([(r, 0) for r in range(n_rows)] if axis == "chains"
                else [(0, s) for s in range(n_slabs)])

    def local_rows(self, axis: str = "chains") -> list:
        """The blocks of `axis` whose first device this process owns (all
        of them in one process). Every process of a mesh that spans
        several must own one, since each evaluates only its own."""
        heads = self._row_heads(axis)
        if self.spmd:
            idle = sorted(set(range(process_count()))
                          - {int(self.processes[p]) for p in heads})
            if idle:
                raise ValueError(f"process(es) {idle} own no first device "
                                 f"of a block of the {axis} axis: each "
                                 f"process evaluates its own blocks")
        return [i for i, p in enumerate(heads) if self.is_local(*p)]

    def chain_rows(self, t: torch.Tensor, axis: str = "chains") -> list:
        """t's chains (axis 0) cut into one block per row of `axis`, block
        r on row r's first device (None where another process owns it).
        Refuses a chain count that the rows do not divide, as placing
        chains over a mesh axis does."""
        heads = self._row_heads(axis)
        if t.shape[0] % len(heads):
            raise ValueError(f"{t.shape[0]} chains not divisible by the "
                             f"{axis} mesh axis ({len(heads)})")
        mine = set(self.local_rows(axis))
        return [b.to(self.devices[p]) if i in mine else None
                for i, (b, p) in enumerate(zip(row_blocks(t, len(heads)),
                                               heads))]

    def join_rows(self, blocks, device=None) -> torch.Tensor:
        """chain_rows' inverse: the blocks concatenated in row order on
        `device` (default: home); across processes each block comes from
        its owner (all_sum), so every process holds the whole."""
        device = self.home if device is None else device
        own = [(i, b) for i, b in enumerate(blocks) if b is not None]
        n = own[0][1].shape[0]  # chain_rows cuts evenly
        whole = torch.full((n * len(blocks), *own[0][1].shape[1:]), -0.0,
                           dtype=own[0][1].dtype, device=device)
        for i, b in own:
            whole[i * n:(i + 1) * n] = b.to(device)
        return all_sum(whole) if self.spmd else whole

    def by_rows(self, fn, axis: str = "chains"):
        """fn, a chain-batched function of t [C, ...] to a tensor or a tuple
        of tensors with the chains on axis 0, evaluated row by row: row r's
        block of chains on its first device (chain_rows), the results
        joined in row order on t's device. Only the first device of a row
        evaluates: the rest of the row (its domain devices) is not used.
        Across processes each evaluates its own rows and every process
        gets the whole result."""

        def placed(t):
            outs = [None if b is None else fn(b)
                    for b in self.chain_rows(t, axis)]
            first = next(o for o in outs if o is not None)
            if isinstance(first, tuple):
                return tuple(self.join_rows(
                    [None if o is None else o[k] for o in outs], t.device)
                    for k in range(len(first)))
            return self.join_rows(outs, t.device)

        return placed


class Slabs:
    """A vector sharded over a DeviceMesh (see the module docstring):
    parts[r][s] on device [r, s] (None where another process owns it),
    slabs consecutive along `axis` (None: each slab holds the row's whole
    block), chains split over rows when `chains`; `shape` is the whole
    vector's."""

    def __init__(self, mesh: DeviceMesh, parts: list, axis: Optional[int],
                 chains: bool, shape: tuple):
        self.mesh = mesh
        self.parts = parts
        self.axis = axis
        self.chains = chains
        self.shape = tuple(shape)

    def like(self, parts: list) -> "Slabs":
        """Blocks of the same layout and shape as self."""
        return Slabs(self.mesh, parts, self.axis, self.chains, self.shape)

    def _local(self):
        """(r, s, block) of every block this process owns."""
        return [(r, s, p) for r, row in enumerate(self.parts)
                for s, p in enumerate(row) if p is not None]

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    @property
    def dtype(self) -> torch.dtype:
        return self._local()[0][2].dtype

    def dim(self) -> int:
        return len(self.shape)

    def _index(self, r: int, s: int) -> tuple:
        """Block [r][s]'s slices into the whole vector."""
        n_rows, n_slabs = self.mesh.devices.shape
        idx = [slice(None)] * len(self.shape)
        if self.chains:
            off = _offsets(_sizes(self.shape[0], n_rows))
            idx[0] = slice(off[r], off[r + 1])
        if self.axis is not None:
            off = _offsets(_sizes(self.shape[self.axis], n_slabs))
            idx[self.axis] = slice(off[s], off[s + 1])
        return tuple(idx)

    def gather(self, device=None) -> torch.Tensor:
        """The whole vector on `device` (default: home), on every
        process."""
        device = self.device if device is None else device
        whole = torch.full(self.shape, -0.0, dtype=self.dtype, device=device)
        for r, s, p in self._local():
            # One owner per entry: row 0 unless the rows hold chains, slab
            # 0 unless the slabs cut an axis.
            if (self.chains or r == 0) and (self.axis is not None or s == 0):
                whole[self._index(r, s)] = p.to(device)
        return all_sum(whole) if self.mesh.spmd else whole

    def dot(self, other) -> torch.Tensor:
        """Σ self·other: a scalar, or per chain ([chains], axis 0 of each
        block) when self holds chains; on home, the same bits on every
        process. other may be a Slabs of the same layout or one without
        chains that broadcasts against self's blocks. Each block's partial
        is summed on its device and moved to home, where a row's partials
        are added in slab order (across processes after all_sum has given
        every process every partial)."""
        n_rows, n_slabs = self.mesh.devices.shape
        if not self.chains and n_rows != 1:
            raise ValueError("a dot of vectors without chains needs a "
                             "one-row mesh")

        home, chains = self.device, self.chains
        parts = [[None if a is None else
                  ((a * b).flatten(1).sum(1) if chains else torch.sum(a * b)
                   ).to(home)
                  for a, b in zip(row, orow)]
                 for row, orow in zip(self.parts, other.parts)]
        if self.mesh.spmd:
            parts = self._everyones(parts)
        out = [functools.reduce(torch.add, row) for row in parts]
        return torch.cat(out) if self.chains else out[0]

    def _everyones(self, parts: list) -> list:
        """dot's partials [r][s] of every process on every process: each
        process's own in a tensor of -0.0, made whole by all_sum."""
        n_rows, n_slabs = self.mesh.devices.shape
        lens = [n for n in (_sizes(self.shape[0], n_rows) if self.chains
                            else [1] * n_rows) for _ in range(n_slabs)]
        flat = all_sum(torch.cat([
            torch.full((n,), -0.0, dtype=self.dtype, device=self.device)
            if p is None else p.reshape(-1)
            for n, p in zip(lens, (p for row in parts for p in row))]))
        pieces = [p if self.chains else p.reshape(())
                  for p in flat.split(lens)]
        return [pieces[r * n_slabs:(r + 1) * n_slabs] for r in range(n_rows)]

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        """An elementwise func block by block. Each block sees a Slabs
        argument's own block, a tensor of per-chain values (axis 0 the
        chains) cut to its row's chains, and any tensor on its own device.
        The result's shape is the arguments' broadcast, its slabs cut the
        axis the arguments' slabs cut, and it holds chains when an
        argument does."""
        kwargs = kwargs or {}
        vals = (*args, *kwargs.values())
        every = [a for a in vals if isinstance(a, Slabs)]
        lead = every[0]
        mesh = lead.mesh
        shape, axis, chains = lead.shape, lead.axis, lead.chains
        if [a for a in every
                if (a.shape, a.axis, a.chains) != (shape, axis, chains)]:
            shape = torch.broadcast_shapes(*(
                tuple(a.shape) for a in vals
                if isinstance(a, (Slabs, torch.Tensor))))
            axes = {a.axis + len(shape) - len(a.shape) for a in every
                    if a.axis is not None}
            if len(axes) > 1:
                raise ValueError(f"Slabs cut along different axes: {axes}")
            axis = axes.pop() if axes else None
            chains = any(a.chains for a in every)
        n_rows = len(mesh.owned)
        n_chains = shape[0] if chains and n_rows > 1 else None

        def block(a, r, s, dev):
            if isinstance(a, Slabs):
                return a.parts[r][s]
            if isinstance(a, torch.Tensor):
                if n_chains is not None and a.dim() and \
                        a.shape[0] == n_chains:
                    a = row_blocks(a, n_rows)[r]
                return a.to(dev)
            return a

        parts = [[None if dev is None else func(
                      *(block(a, r, s, dev) for a in args),
                      **{k: block(v, r, s, dev) for k, v in kwargs.items()})
                  for s, dev in enumerate(row)]
                 for r, row in enumerate(mesh.owned)]
        return Slabs(mesh, parts, axis, chains, shape)

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


# ------------------------------------------------------ the runtime

def _init_method(coordinator_address: Optional[str]) -> str:
    """torch.distributed's init method: "host:port" as tcp://host:port, a
    URL (tcp://, file://, env://) as given, None as torchrun's
    MASTER_ADDR / MASTER_PORT."""
    if coordinator_address is None:
        if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
            return "env://"
        raise ValueError(
            "several processes need an init method: coordinator_address="
            "'host:port' or 'file:///path', or torchrun's MASTER_ADDR and "
            "MASTER_PORT")
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def _default_devices(process_id: int, backend: Optional[str]) -> list:
    """A process's devices when the caller names none: cuda:{LOCAL_RANK}
    under torchrun; else under NCCL (the backend for cards by default) the
    card process_id % cards, one rank per card as NCCL needs; else (gloo)
    every visible card."""
    if "LOCAL_RANK" in os.environ:
        return [f"cuda:{os.environ['LOCAL_RANK']}"]
    cards = torch.cuda.device_count()
    if not cards:
        raise ValueError("torch sees no CUDA device: pass local_devices= "
                         "(e.g. ['cpu'] * 2)")
    if backend in (None, "nccl"):
        return [f"cuda:{process_id % cards}"]
    return [f"cuda:{i}" for i in range(cards)]


def _card(dev: torch.device) -> str:
    """A card's identity across the processes and hosts of a run (its
    UUID: one card may have other indices in other processes)."""
    return str(torch.cuda.get_device_properties(dev).uuid)


def _share_devices(store, rank: int, world: int, local: list,
                   backend: str) -> list:
    """Every process's device names, process-major, exchanged through the
    rendezvous store before any collective. Under NCCL a card that two
    ranks would share is refused (ValueError) on every rank alike: NCCL
    gives each rank a card of its own. The backend is never switched
    behind the caller's back."""
    mine = {"devices": [str(d) for d in local],
            "cards": ([[str(d), _card(d)] for d in local]
                      if backend == "nccl" else [])}
    store.set(f"stan_tpu_torch/devices/{rank}", json.dumps(mine))
    every = [json.loads(store.get(f"stan_tpu_torch/devices/{p}"))
             for p in range(world)]
    owner = {}
    for p, entry in enumerate(every):
        for name, card in entry["cards"]:
            q, other = owner.setdefault(card, (p, name))
            if q != p:
                raise ValueError(
                    f"backend='nccl' with ranks {q} and {p} on one card "
                    f"({other} of rank {q}, {name} of rank {p}), which NCCL "
                    f"refuses; pass backend='gloo' to run several ranks on "
                    f"one card")
    return [entry["devices"] for entry in every]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               local_devices: Optional[Sequence] = None,
               timeout: float = 300.0) -> None:
    """Join (or start) the several-process runtime over torch.distributed.

    A no-op for one process, so callers may call it unconditionally: the
    count is num_processes, else STAN_TPU_NUM_PROCESSES, else torchrun's
    WORLD_SIZE, else 1. For more, coordinator_address is "host:port" (as
    tcp://host:port) or an init URL such as "file:///path"; None reads
    torchrun's MASTER_ADDR / MASTER_PORT, and process_id None its RANK.
    local_devices: this process's devices (default cuda:{LOCAL_RANK} when
    LOCAL_RANK is set, else under NCCL the card process_id % cards, else
    every visible card; the CPU tests pass ["cpu"] * k). backend: "nccl"
    for CUDA devices and "gloo" for the CPU by default; NCCL with a card
    that two ranks would share is refused (ValueError, on every rank,
    before any collective): pass backend="gloo" to run several ranks on
    one card. timeout (seconds) bounds the rendezvous and every
    collective, so one that is never matched fails instead of hanging."""
    global _runtime
    if num_processes is None:
        num_processes = int(os.environ.get(
            "STAN_TPU_NUM_PROCESSES", os.environ.get("WORLD_SIZE", "1")))
    if num_processes <= 1 and coordinator_address is None:
        return
    if _runtime is not None:
        raise RuntimeError("distributed.initialize was already called")
    init_method = _init_method(coordinator_address)
    if process_id is None:
        if "RANK" not in os.environ:
            raise ValueError("process_id is needed (or torchrun's RANK)")
        process_id = int(os.environ["RANK"])
    if local_devices is None:
        local_devices = _default_devices(process_id, backend)
    local = [torch.device(d) for d in local_devices]
    if len({d.type for d in local}) != 1:
        raise ValueError(f"a process's devices must be of one type, got "
                         f"{[str(d) for d in local]}")
    backend = backend or ("nccl" if local[0].type == "cuda" else "gloo")
    if backend == "nccl" and local[0].type != "cuda":
        raise ValueError(f"backend='nccl' needs CUDA devices, got "
                         f"{[str(d) for d in local]}; pass backend='gloo'")
    local = [canonical(d) for d in local]
    wait = datetime.timedelta(seconds=timeout)
    store, _, _ = next(dist.rendezvous(init_method, process_id,
                                       num_processes, timeout=wait))
    store.set_timeout(wait)
    names = _share_devices(store, process_id, num_processes, local, backend)
    if local[0].type == "cuda":
        torch.cuda.set_device(local[0])
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg",
                                                            store),
                            world_size=num_processes, rank=process_id,
                            timeout=wait)
    _runtime = _Runtime(backend, tuple(local), tuple(
        Device(p, torch.device(d)) for p, ds in enumerate(names)
        for d in ds))


_all_devices = devices


def device_mesh(n_chains: int = 1, n_domain: Optional[int] = None,
                devices: Optional[Sequence] = None) -> DeviceMesh:
    """The (chains, domain) mesh over `devices` (default: the global list,
    devices()): global Devices, or this process's own devices. ``n_domain=
    None`` takes every remaining device. Raises ValueError if the extents
    do not fit the devices (refuse, do not shrink)."""
    if devices is None:
        devices = _all_devices()
        if not devices:
            raise RuntimeError("device_mesh: torch sees no CUDA device; pass "
                               "devices= (e.g. ['cpu'] * 4)")
    devs = [d if isinstance(d, Device) else torch.device(d) for d in devices]
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
    distinct = len(set(zip(mesh.processes.flat, mesh.devices.flat)))
    procs = sorted({int(p) for p in mesh.processes.flat})
    where = (f"in {len(procs)} processes ({', '.join(map(str, procs))}; "
             f"{backend()})" if mesh.spmd else "in one process")
    return (f"mesh chains={shape['chains']} x domain={shape['domain']} on "
            f"{mesh.devices.size} {'/'.join(sorted(kinds))} device(s) "
            f"({distinct} distinct) {where}")
