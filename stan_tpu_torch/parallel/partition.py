# Copied from stan_tpu/parallel/partition.py (bfs_node_order only, without the native fast path).
"""Bandwidth-reducing BFS node ordering (host-side numpy).

The reference's AssignDOF graph walk (src/STAN_Database/Database.cs:140-234).
The port's banded direct solver (solvers/banded.py) uses it to narrow the
band; the domain partition built on the same order comes with multi-GPU.
"""

from __future__ import annotations

import numpy as np


def bfs_node_order(conn: np.ndarray, nnode: int) -> np.ndarray:
    """BFS node ordering seeded at a peripheral node.

    Same algorithm as Database.AssignDOF (Database.cs:178-233): build the
    node adjacency from shared elements, seed at a node with the fewest
    incident elements, breadth-first assign new indices. Returns
    `order[new_index] = old_index` covering all nodes (isolated nodes are
    appended at the end).
    """
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
