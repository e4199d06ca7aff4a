# Copied from stan_tpu/parallel/partition.py.
"""Domain decomposition: node/element partitioning for the device mesh.

The reference's AssignDOF graph walk (src/STAN_Database/Database.cs:140-234)
gives a locality-preserving 1-D node order. The port's banded direct
solver (solvers/banded.py) uses it to narrow the band; here it is also cut
into P equal contiguous blocks, one per device of the domain axis, and
elements are assigned to the device owning most of their nodes.

Everything here is host-side numpy preprocessing; the output is a
`Partition` of padded, statically-shaped per-device arrays consumed by
parallel/sharded.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def bfs_node_order(conn: np.ndarray, nnode: int) -> np.ndarray:
    """BFS node ordering seeded at a peripheral node.

    Same algorithm as Database.AssignDOF (Database.cs:178-233): build the
    node adjacency from shared elements, seed at a node with the fewest
    incident elements, breadth-first assign new indices. Returns
    `order[new_index] = old_index` covering all nodes (isolated nodes are
    appended at the end). The walk runs in the host runtime
    (native.bfs_order); the numpy body below is its spec, and runs only if
    the native walk reports a node it missed.
    """
    from stan_tpu_torch import native

    nat = native.bfs_order(conn, nnode)
    if nat is not None:
        return nat

    nelem, nn = conn.shape
    # node -> element incidence counts (for the peripheral seed)
    counts = np.bincount(conn.ravel(), minlength=nnode)

    # Build CSR adjacency: nodes sharing an element are neighbors.
    # Pairs (a, b) for all ordered pairs within each element.
    a = np.repeat(conn, nn, axis=1).ravel()
    b = np.tile(conn, (1, nn)).ravel()
    keep = a != b
    a, b = a[keep], b[keep]
    pairs = np.unique(a.astype(np.int64) * nnode + b.astype(np.int64))
    adj_src = (pairs // nnode).astype(np.int64)
    adj_dst = (pairs % nnode).astype(np.int64)
    indptr = np.zeros(nnode + 1, dtype=np.int64)
    np.add.at(indptr, adj_src + 1, 1)
    indptr = np.cumsum(indptr)
    # adj_dst is already grouped by adj_src because pairs are sorted

    visited = np.zeros(nnode, dtype=bool)
    order = np.empty(nnode, dtype=np.int64)
    pos = 0
    # Components loop (mesh may be disconnected)
    seed_order = np.argsort(np.where(counts > 0, counts, np.iinfo(np.int64).max))
    for seed in seed_order:
        if visited[seed] or counts[seed] == 0:
            continue
        # BFS from seed
        queue = [int(seed)]
        visited[seed] = True
        while queue:
            next_queue = []
            for u in queue:
                order[pos] = u
                pos += 1
                nbrs = adj_dst[indptr[u] : indptr[u + 1]]
                fresh = nbrs[~visited[nbrs]]
                visited[fresh] = True
                next_queue.extend(int(x) for x in fresh)
            queue = next_queue
    # isolated nodes last
    rest = np.nonzero(~visited)[0]
    order[pos : pos + len(rest)] = rest
    return order


@dataclasses.dataclass
class Partition:
    """Padded per-device layout over `ndev` domain shards.

    perm:        i64[nnode]      old node index -> new (BFS-blocked) index
    inv_perm:    i64[nnode]      new -> old
    nnode_pad:   int             nnode rounded up to ndev * block
    block:       int             nodes per device (nnode_pad // ndev)
    conn:        i64[ndev, epb, nn]  reordered-connectivity per device,
                                 padded with degenerate elements (conn=0)
    elem_owner:  i64[nelem]      device owning each original element
    elem_pos:    i64[nelem]      slot of each original element in its shard
    epb:         int             elements per block (padded)
    pad_elem:    bool[ndev, epb] True for padding slots
    """

    perm: np.ndarray
    inv_perm: np.ndarray
    nnode_pad: int
    block: int
    conn: np.ndarray
    elem_owner: np.ndarray
    elem_pos: np.ndarray
    epb: int
    pad_elem: np.ndarray


def partition(conn: np.ndarray, nnode: int, ndev: int) -> Partition:
    """Partition the mesh over `ndev` devices.

    Nodes: BFS order cut into equal contiguous blocks (padded).
    Elements: assigned to the device owning the majority of their (new-index)
    nodes -- cheap heuristic with good locality on BFS-ordered meshes.
    """
    order = bfs_node_order(conn, nnode)  # new -> old
    perm = np.empty(nnode, dtype=np.int64)  # old -> new
    perm[order] = np.arange(nnode)

    block = -(-nnode // ndev)
    nnode_pad = block * ndev

    new_conn = perm[conn]  # [E, nn] in new numbering
    # Owner = device of the median node (majority-ish, O(E nn log nn))
    owner = np.median(new_conn // block, axis=1).astype(np.int64)
    owner = np.clip(owner, 0, ndev - 1)

    nelem, nn = conn.shape
    counts = np.bincount(owner, minlength=ndev)
    epb = int(counts.max())
    # Vectorized bucket fill: stable-sort by owner, position = rank within
    # the owner's run.
    sort_idx = np.argsort(owner, kind="stable")
    starts = np.zeros(ndev, dtype=np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    pos_sorted = np.arange(nelem) - starts[owner[sort_idx]]
    elem_pos = np.empty(nelem, dtype=np.int64)
    elem_pos[sort_idx] = pos_sorted
    conn_sh = np.zeros((ndev, epb, nn), dtype=np.int64)
    pad = np.ones((ndev, epb), dtype=bool)
    conn_sh[owner, elem_pos] = new_conn
    pad[owner, elem_pos] = False
    return Partition(
        perm=perm,
        inv_perm=order,
        nnode_pad=nnode_pad,
        block=block,
        conn=conn_sh,
        elem_owner=owner,
        elem_pos=elem_pos,
        epb=epb,
        pad_elem=pad,
    )
