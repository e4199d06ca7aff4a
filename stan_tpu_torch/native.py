# Copied from stan_tpu/native.py, with the library built by _build,
# without available and node_incidence, which no path of the port calls,
# and with element_stiffness_f64 and element_apply_f64 added.
"""ctypes bindings for the port's host runtime (csrc/stanfem.cpp).

C++ implementations of the host-side hot paths: .bdf parsing and the
protobuf wire scan (the data loaders), the BFS node order (the graph
builder), the float64 interior stencil sweep and the float64 element
stiffnesses with their sweep (the host float64 operators). The library is built with the host C++
compiler at the first call (_build.host_library) and raises if it cannot
be built: nothing here falls back. The Python implementations stay as the
semantic spec; tests hold the two to identical outputs.

Numpy in, numpy out. A function returns None only for a reason of content
that the caller handles (a mesh of mixed element families, a malformed
protobuf body), as in the reference.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from stan_tpu_torch import _build

_lib: Optional[ctypes.CDLL] = None


def _node_indices(conn: np.ndarray, nnode: int) -> np.ndarray:
    """conn as C-contiguous int64, every entry a node index in [0, nnode):
    the C code indexes its per-node arrays with them unchecked."""
    conn = np.ascontiguousarray(conn, dtype=np.int64)
    if conn.size and (conn.min() < 0 or conn.max() >= nnode):
        raise ValueError(f"node indices outside [0, {nnode})")
    return conn


class _BdfMesh(ctypes.Structure):
    _fields_ = [
        ("n_nodes", ctypes.c_int64),
        ("n_elems", ctypes.c_int64),
        ("nodes_per_elem", ctypes.c_int64),
        ("node_ids", ctypes.POINTER(ctypes.c_int64)),
        ("coords", ctypes.POINTER(ctypes.c_double)),
        ("elem_ids", ctypes.POINTER(ctypes.c_int64)),
        ("elem_pids", ctypes.POINTER(ctypes.c_int64)),
        ("conn", ctypes.POINTER(ctypes.c_int64)),
        ("n_errors", ctypes.c_int64),
    ]


def _load() -> ctypes.CDLL:
    """Load the host library, building it at the first call; raises
    RuntimeError (with the compiler's output) when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.host_library("stanfem")

    lib.stanfem_bdf_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.stanfem_bdf_parse.restype = ctypes.POINTER(_BdfMesh)
    lib.stanfem_bdf_free.argtypes = [ctypes.POINTER(_BdfMesh)]
    lib.stanfem_bdf_free.restype = None
    lib.stanfem_bfs_order.argtypes = [
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    lib.stanfem_bfs_order.restype = ctypes.c_int
    lib.stanfem_pb_scan_many.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64,
    ]
    lib.stanfem_pb_scan_many.restype = ctypes.c_int64
    lib.stanfem_stencil_interior_f64.argtypes = [
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    lib.stanfem_stencil_interior_f64.restype = None
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.stanfem_element_stiffness_f64.argtypes = [
        f64, i64, ctypes.c_int64, ctypes.c_int64, f64, f64, f64,
        ctypes.c_int64, f64]
    lib.stanfem_element_stiffness_f64.restype = ctypes.c_int
    lib.stanfem_element_apply_f64.argtypes = [
        f64, i64, ctypes.c_int64, ctypes.c_int64, f64, i64, ctypes.c_int64,
        ctypes.c_int64, f64, f64]
    lib.stanfem_element_apply_f64.restype = None
    _lib = lib
    return _lib


def bdf_parse(path: str, strict: bool = False):
    """Parse a .bdf with the native parser.

    Returns (node_ids, coords, elem_ids, elem_pids, conn, n_errors), or None
    when the file cannot be opened or holds a mesh the parser does not
    model (mixed element families): the caller then reads it with the
    Python parser.
    """
    lib = _load()
    mp = lib.stanfem_bdf_parse(path.encode(), 1 if strict else 0)
    if not mp:
        return None
    try:
        m = mp.contents
        nn, ne, npe = m.n_nodes, m.n_elems, m.nodes_per_elem
        node_ids = np.ctypeslib.as_array(m.node_ids, (nn,)).copy() if nn else np.zeros(0, np.int64)
        coords = (np.ctypeslib.as_array(m.coords, (nn * 3,)).copy().reshape(nn, 3)
                  if nn else np.zeros((0, 3)))
        elem_ids = np.ctypeslib.as_array(m.elem_ids, (ne,)).copy() if ne else np.zeros(0, np.int64)
        elem_pids = np.ctypeslib.as_array(m.elem_pids, (ne,)).copy() if ne else np.zeros(0, np.int64)
        conn = (np.ctypeslib.as_array(m.conn, (ne * npe,)).copy().reshape(ne, npe)
                if ne else np.zeros((0, npe), np.int64))
        n_err = int(m.n_errors)
    finally:
        lib.stanfem_bdf_free(mp)
    return node_ids, coords, elem_ids, elem_pids, conn, n_err


def bfs_order(conn: np.ndarray, nnode: int) -> Optional[np.ndarray]:
    """Native BFS node ordering; None when the walk misses a node."""
    lib = _load()
    conn = _node_indices(conn, nnode)
    ne, npe = conn.shape
    out = np.empty(nnode, dtype=np.int64)
    rc = lib.stanfem_bfs_order(conn, ne, npe, nnode, out)
    return out if rc == 0 else None


def pb_scan_many(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Scan protobuf message bodies into a flat field table.

    buf: uint8 byte array; starts/ends: int64 body ranges. Returns
    (body i32, field i32, wt i8, a i64, b i64) arrays — see
    csrc/stanfem.cpp stanfem_pb_scan_many for record semantics — or None
    when the input is malformed (the STdb reader then parses the file with
    the generated-protobuf parser).
    """
    lib = _load()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    if starts.shape != ends.shape or starts.ndim != 1:
        raise ValueError(f"starts {starts.shape} and ends {ends.shape}")
    n = lib.stanfem_pb_scan_many(buf, buf.size, starts, ends, len(starts),
                                 None, None, None, None, None, 0)
    if n < 0:
        return None
    body = np.empty(n, dtype=np.int32)
    field = np.empty(n, dtype=np.int32)
    wt = np.empty(n, dtype=np.int8)
    a = np.empty(n, dtype=np.int64)
    b = np.empty(n, dtype=np.int64)
    n2 = lib.stanfem_pb_scan_many(
        buf, buf.size, starts, ends, len(starts),
        body.ctypes.data_as(ctypes.c_void_p),
        field.ctypes.data_as(ctypes.c_void_p),
        wt.ctypes.data_as(ctypes.c_void_p),
        a.ctypes.data_as(ctypes.c_void_p),
        b.ctypes.data_as(ctypes.c_void_p), n)
    if n2 != n:
        return None
    return body, field, wt, a, b


def stencil_interior_f64(up: np.ndarray, tab: np.ndarray) -> np.ndarray:
    """Float64 interior-table stencil sweep (the host float64 operator's
    hot loop, OpenMP over x-planes).

    up: [3, nnx+2, nny+2, nnz+2] ghost-padded grid; tab: [27, 3, 3]
    offset-major ((ox+1)*9 + (oy+1)*3 + (oz+1)) interior table. Returns
    [3, nnx, nny, nnz].
    """
    lib = _load()
    up = np.ascontiguousarray(up, dtype=np.float64)
    tab = np.ascontiguousarray(tab, dtype=np.float64)
    if up.ndim != 4 or up.shape[0] != 3 or min(up.shape[1:]) < 3 \
            or tab.shape != (27, 3, 3):
        raise ValueError(f"up {up.shape}, tab {tab.shape}: want [3, nnx+2, "
                         "nny+2, nnz+2] with every n >= 1, and [27, 3, 3]")
    _, pxx, pyy, pzz = up.shape
    nnx, nny, nnz = pxx - 2, pyy - 2, pzz - 2
    out = np.empty((3, nnx, nny, nnz), dtype=np.float64)
    lib.stanfem_stencil_interior_f64(up.reshape(-1), nnx, nny, nnz,
                                     tab.reshape(-1), out.reshape(-1))
    return out


def element_stiffness_f64(coords: np.ndarray, conn: np.ndarray,
                          D: np.ndarray, gauss_dN: np.ndarray,
                          gauss_w: np.ndarray) -> np.ndarray:
    """Float64 element stiffnesses ke [E, 3nn, 3nn] = sum_g B^T D B det(J) w
    (fem/hostops.element_stiffness_np's arithmetic, OpenMP over elements).

    coords: [nnode, 3]; conn: [E, nn], nn <= 8; D: [E, 6, 6]; gauss_dN:
    [G, 3, nn] natural-coordinate gradients; gauss_w: [G].
    """
    lib = _load()
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    conn = _node_indices(conn, coords.shape[0])
    D = np.ascontiguousarray(D, dtype=np.float64)
    gdn = np.ascontiguousarray(gauss_dN, dtype=np.float64)
    gw = np.ascontiguousarray(gauss_w, dtype=np.float64)
    E, nn = conn.shape
    if (coords.ndim != 2 or coords.shape[1] != 3 or D.shape != (E, 6, 6)
            or gdn.shape != (gw.size, 3, nn) or not 1 <= nn <= 8):
        raise ValueError(f"coords {coords.shape}, conn {conn.shape}, D "
                         f"{D.shape}, gauss_dN {gdn.shape}, gauss_w "
                         f"{gw.shape}: want [nnode, 3], [E, nn <= 8], "
                         "[E, 6, 6], [G, 3, nn], [G]")
    ke = np.empty((E, 3 * nn, 3 * nn), dtype=np.float64)
    lib.stanfem_element_stiffness_f64(coords.reshape(-1), conn.reshape(-1),
                                      E, nn, D.reshape(-1), gdn.reshape(-1),
                                      gw, gw.size, ke.reshape(-1))
    return ke


def element_apply_f64(ke: np.ndarray, conn: np.ndarray, inc: np.ndarray,
                      u: np.ndarray, fe: np.ndarray) -> np.ndarray:
    """f = K u [nnode, 3] from element stiffnesses ke [E, 3nn, 3nn]: one
    product per element into the scratch fe (E * nn * 3 + 3 float64), then
    a gather through the transposed incidence map inc [nnode, maxdeg]
    (fem/operator.node_incidence). ke, conn and inc must be C-contiguous
    of their dtypes, and conn's entries node indices (element_stiffness_f64
    and the caller's node_incidence make them so): they are passed as they
    are, since a sweep runs many times on one set."""
    lib = _load()
    E, nc, _ = ke.shape
    nnode, maxdeg = inc.shape
    u = np.ascontiguousarray(u, dtype=np.float64)
    if (u.shape != (nnode, 3) or conn.shape != (E, nc // 3)
            or fe.shape != (E * nc + 3,) or fe.dtype != np.float64):
        raise ValueError(f"u {u.shape}, conn {conn.shape}, fe {fe.shape}: "
                         f"want [{nnode}, 3], [{E}, {nc // 3}], "
                         f"[{E * nc + 3}] float64")
    out = np.empty((nnode, 3), dtype=np.float64)
    lib.stanfem_element_apply_f64(ke.reshape(-1), conn.reshape(-1), E,
                                  nc // 3, u.reshape(-1), inc.reshape(-1),
                                  nnode, maxdeg, fe, out.reshape(-1))
    return out
