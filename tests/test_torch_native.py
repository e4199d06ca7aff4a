"""The port's host runtime (stan_tpu_torch/native.py over csrc/stanfem.cpp,
built here by the host C++ compiler) against the reference's
(stan_tpu.native over native/stanfem.cpp) and against the port's own
Python bodies, on the same numpy inputs: the BFS order (equal arrays), the
.bdf parse (equal ids, coordinates,
connectivity, part ids, types and import errors), the STdb fast decode
(equal models, with and without results; a packed node list still goes to
from_proto), and apply_numpy's float64 interior sweep (to 1e-13 of
max|f|). Then the host build: keyed by source and flags, built once,
never through nvcc, and a failed build raises with the compiler's output.
"""

import ctypes
import dataclasses
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from stan_tpu import native as jnative
from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.fem import stencil as jstencil
from stan_tpu.io import nastran as jnastran
from stan_tpu.io import stdb as jstdb
from stan_tpu_torch import _build, native
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.core.model import Material
from stan_tpu_torch.fem import stencil
from stan_tpu_torch.io import nastran, stdb, wire
from stan_tpu_torch.parallel import partition

# The sweep sums the same products as the numpy form in another order
# (8.3e-16 of max|f| measured at 70^3).
SWEEP_RTOL = 1e-13
# The six tetrahedra of a HEX8 around its corner-0 to corner-6 diagonal.
HEX_TO_TETS = np.array([[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
                        [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]])
ENTRIES = ("stanfem_bdf_parse", "stanfem_bdf_free", "stanfem_bfs_order",
           "stanfem_pb_scan_many", "stanfem_stencil_interior_f64")


def _tet_model(n=(3, 3, 2)):
    """hex_beam(*n) with every HEX8 split into 6 TET4 on the same nodes."""
    m = meshgen.hex_beam(*n)
    m.conn = np.asarray(m.conn)[:, HEX_TO_TETS].reshape(-1, 4)
    m.elem_ids = np.arange(1, len(m.conn) + 1, dtype=np.int64)
    m.elem_pid = np.ones(len(m.conn), np.int64)
    m.elem_mat = np.ones(len(m.conn), np.int64)
    m.elem_type = ["TET4_G2"] * len(m.conn)
    return m


MESHES = {"hex": lambda: meshgen.hex_beam(6, 5, 4), "tet": _tet_model}


# -- the graph builder -------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
def test_bfs_order_matches_reference_and_python(mesh, monkeypatch):
    m = MESHES[mesh]()
    conn = np.asarray(m.conn)
    got = native.bfs_order(conn, m.nnode)
    np.testing.assert_array_equal(got, jnative.bfs_order(conn, m.nnode))
    np.testing.assert_array_equal(got, partition.bfs_node_order(conn,
                                                                m.nnode))
    # Other integer types reach the C call as int64.
    np.testing.assert_array_equal(
        native.bfs_order(conn.astype(np.int32), m.nnode), got)
    # The numpy body of bfs_node_order, the spec of the native walk.
    monkeypatch.setattr(native, "bfs_order", lambda *a, **k: None)
    np.testing.assert_array_equal(got, partition.bfs_node_order(conn,
                                                                m.nnode))
    assert sorted(got) == list(range(m.nnode))


def test_native_refuses_inputs_it_would_index_out_of_bounds():
    """The C code indexes with its inputs unchecked, so the bindings
    check them first."""
    conn = np.asarray(meshgen.hex_beam(2, 2, 2).conn)
    for bad in (conn - 1, conn + 1):
        with pytest.raises(ValueError, match="node indices"):
            native.bfs_order(bad, int(conn.max()) + 1)
    with pytest.raises(ValueError):
        native.stencil_interior_f64(np.zeros((3, 4, 4)), np.zeros((27, 3, 3)))
    with pytest.raises(ValueError):
        native.stencil_interior_f64(np.zeros((3, 4, 4, 4)), np.zeros((9, 3)))
    with pytest.raises(ValueError):
        native.pb_scan_many(np.zeros(4, np.uint8), np.array([0, 1]),
                            np.array([4]))


# -- the .bdf parser ---------------------------------------------------------

QUIRKY = "\n".join([
    "$ comment",
    "GRID    1               1.5-1   .5      -0.5",
    "GRID    2               1.0     0.0     0.0",
    "GRID    3               1.0     1.0     0.0",
    "GRID    4               0.0     1.0     0.0",
    "GRID    5               0.0     0.0     1.0",
    "GRID    6               1.0     0.0     1.0",
    "GRID    7               1.0     1.0     1.0",
    "GRID    8               0.0     1.0     1.0",
    "CHEXA   10      7       1       2       3       4       5       6+",
    "+       7       8",
])
ERRORS = "\n".join([
    "GRID    1               0.0     0.0     0.0",
    "GRID    2               1.0     0.0     0.0",
    "GRID    XX              oops",
    "GRID    3               1.0     1.0-x   0.0",
    "GRID    4               0.0     1.0     0.0",
    "CTETRA  5       2       1       2       4       9",  # node 9 unknown
    "CHEXA   6       1       1       2",  # too few nodes
    "CTETRA  7       2       1       2       4       1",
    "ENDDATA",
])


def _bdf(tmp_path, case):
    path = tmp_path / f"{case}.bdf"
    if case in ("hex", "strict"):
        nastran.write_bdf(meshgen.hex_beam(4, 3, 2), str(path))
    elif case == "tet":
        nastran.write_bdf(_tet_model(), str(path))
    else:
        path.write_text(QUIRKY if case == "quirky" else ERRORS)
    return str(path)


def _same_mesh(a, b):
    for name in ("node_ids", "coords", "elem_ids", "conn", "elem_pid",
                 "elem_mat"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.elem_type == b.elem_type
    assert a.import_errors == b.import_errors
    assert {k: vars(v) for k, v in a.part_info.items()} == {
        k: vars(v) for k, v in b.part_info.items()}


@pytest.mark.parametrize("case", ["hex", "tet", "quirky", "errors",
                                  "strict"])
def test_bdf_parse_matches_reference(tmp_path, case):
    path = _bdf(tmp_path, case)
    strict = case == "strict"
    got = native.bdf_parse(path, strict=strict)
    want = jnative.bdf_parse(path, strict=strict)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[5] > 0) == (case == "errors")
    if case == "quirky":
        assert got[1][0] == pytest.approx([0.15, 0.5, -0.5])
        np.testing.assert_array_equal(got[3], [7])
        np.testing.assert_array_equal(got[4][0], np.arange(8))
    assert native.bdf_parse(str(tmp_path / "missing.bdf")) is None


@pytest.mark.parametrize("case", ["hex", "tet", "quirky", "errors",
                                  "strict"])
def test_read_bdf_matches_reference_and_python(tmp_path, case):
    """read_bdf's native path against its Python parser and the
    reference's read_bdf; a file with errors is read by the Python parser,
    so its import errors are the reference's."""
    path = _bdf(tmp_path, case)
    strict = case == "strict"
    got = nastran.read_bdf(path, strict=strict)
    _same_mesh(got, nastran.read_bdf_python(path, strict=strict))
    _same_mesh(got, jnastran.read_bdf(path, strict=strict))
    if case == "errors":
        assert got.nnode == 3 and got.nelem == 1
        assert len(got.import_errors) == 4
    else:
        assert got.import_errors == []
    if case == "strict":  # CHEXA only: the beam's elements all pass
        assert got.nelem == 24


# -- the STdb fast decode ----------------------------------------------------

def _stdb_model(results: bool):
    """A two-material beam; with results, two increments of random
    displacements, strains and stresses."""
    m = meshgen.hex_beam(6, 5, 4)
    m.materials[2] = Material(id=2, name="soft", E=70000.0, poisson=0.33)
    m.elem_mat = m.elem_mat.copy()
    m.elem_mat[m.nelem // 2:] = 2
    if results:
        rng = np.random.default_rng(3)
        m.analysis.result_step_no = 1
        m.disp = rng.standard_normal((2, m.nnode, 3))
        m.strain = rng.standard_normal((2, m.nelem, 8, 6))
        m.stress = rng.standard_normal((2, m.nelem, 8, 6))
    return m


def _same_model(a, b):
    for name in ("node_ids", "coords", "elem_ids", "conn", "elem_pid",
                 "elem_mat", "disp", "strain", "stress"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.elem_type == b.elem_type
    assert {k: vars(v) for k, v in a.materials.items()} == {
        k: vars(v) for k, v in b.materials.items()}
    assert a.bcs.keys() == b.bcs.keys()
    for k in a.bcs:
        x, y = a.bcs[k], b.bcs[k]
        assert (x.id, x.type, x.name, x.color_id) == (y.id, y.type, y.name,
                                                      y.color_id)
        assert x.nodal_values.keys() == y.nodal_values.keys()
        for nid in x.nodal_values:
            np.testing.assert_array_equal(x.nodal_values[nid],
                                          y.nodal_values[nid])
    assert dataclasses.asdict(a.analysis) == dataclasses.asdict(b.analysis)
    assert {k: vars(v) for k, v in a.part_info.items()} == {
        k: vars(v) for k, v in b.part_info.items()}


@pytest.mark.parametrize("results", [False, True], ids=["model", "results"])
def test_deserialize_fast_matches_from_proto_and_reference(tmp_path,
                                                           results):
    m = _stdb_model(results)
    data = stdb.serialize(m)
    fast = stdb.deserialize_fast(data)
    assert fast is not None, "the fast decode declined a file it models"
    _same_model(fast, stdb.from_proto(stdb.pb.Database.FromString(data)))
    _same_model(fast, jstdb.deserialize_fast(data))
    assert (fast.disp is not None) == results
    path = tmp_path / "m.STdb"
    stdb.write(m, str(path))
    _same_model(stdb.read(str(path)), fast)


def test_deserialize_fast_defers_a_packed_node_list(tmp_path):
    """Element.nlist written packed is outside the fast decode's model: it
    returns None, as the reference's does, and read() parses the file with
    from_proto (tests/test_io.py:406-451, on the port's wire helpers)."""
    m = _stdb_model(results=False)
    data = stdb.serialize(m)
    buf = np.frombuffer(data, np.uint8)
    _, field, wt, a, b = native.pb_scan_many(buf, np.array([0]),
                                             np.array([len(data)]))
    first = int(np.nonzero((field == 2) & (wt == 2))[0][0])
    start, length = int(a[first]), int(b[first])
    head = start - 1 - len(wire.varint(length))  # tag byte + length varint
    nodes = np.asarray(m.node_ids)[np.asarray(m.conn)[0]]
    packed = b"".join(wire.varint(int(v)) for v in nodes)
    el = (wire.scalar_varint_field(1, int(m.elem_ids[0]))
          + wire.string_field(2, m.elem_type[0])
          + wire.scalar_varint_field(3, int(m.elem_pid[0]))
          + wire.scalar_varint_field(4, int(m.elem_mat[0]))
          + wire.length_delimited(5, packed))
    entry = wire.length_delimited(2, wire.scalar_varint_field(
        1, int(m.elem_ids[0])) + wire.length_delimited(2, el))
    spliced = data[:head] + entry + data[start + length:]
    assert stdb.deserialize_fast(spliced) is None
    assert jstdb.deserialize_fast(spliced) is None
    path = tmp_path / "packed.STdb"
    path.write_bytes(spliced)
    got = stdb.read(str(path))
    _same_model(got, stdb.from_proto(stdb.pb.Database.FromString(spliced)))
    np.testing.assert_array_equal(got.conn, m.conn)


@pytest.mark.parametrize("results", [False, True], ids=["model", "results"])
def test_pb_scan_many_matches_reference_and_refuses_malformed(results):
    data = stdb.serialize(_stdb_model(results))
    buf = np.frombuffer(data, np.uint8)
    ends = (np.array([0]), np.array([len(data)]))
    for g, w in zip(native.pb_scan_many(buf, *ends),
                    jnative.pb_scan_many(buf, *ends)):
        np.testing.assert_array_equal(g, w)
    assert native.pb_scan_many(buf, np.array([0]),
                               np.array([len(data) + 1])) is None
    assert native.pb_scan_many(buf[:-1], *ends) is None


# -- the float64 interior sweep ----------------------------------------------

@pytest.mark.parametrize("n,kw", [((6, 5, 4), {}),
                                  ((5, 4, 3), {"lx": 6.0, "ly": 1.5,
                                               "lz": 3.0})])
def test_apply_numpy_native_matches_numpy_and_reference(n, kw):
    t, d = stencil.exact_tables(meshgen.hex_beam(*n, **kw))
    jt, jd = jstencil.exact_tables(jmeshgen.hex_beam(*n, **kw))
    shape = tuple(k + 1 for k in n)
    u = np.random.default_rng(4).standard_normal((3, *shape))
    got = stencil.apply_numpy(t, d, u)
    for want in (stencil.apply_numpy_reference(t, d, u),
                 jstencil.apply_numpy(jt, jd, u)):
        assert got.shape == want.shape == (3, *shape)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= SWEEP_RTOL * scale


@pytest.mark.parametrize("n,kw", [((4, 3, 3), {}),
                                  ((5, 4, 3), {"lx": 6.0, "ly": 1.5,
                                               "lz": 3.0})])
def test_stencil_interior_matches_reference(n, kw):
    t, _ = stencil.exact_tables(meshgen.hex_beam(*n, **kw))
    tab = np.zeros((27, 3, 3))
    for (ox, oy, oz), m in t[("F", "F", "F")].items():
        tab[(ox + 1) * 9 + (oy + 1) * 3 + (oz + 1)] = m
    up = np.random.default_rng(5).standard_normal((3, *(k + 3 for k in n)))
    np.testing.assert_array_equal(native.stencil_interior_f64(up, tab),
                                  jnative.stencil_interior_f64(up, tab))


# -- the host build ----------------------------------------------------------

@pytest.fixture
def host_build(tmp_path, monkeypatch):
    """A copy of csrc/stanfem.cpp and a build folder of its own; the
    compiler calls are counted and nvcc may not be asked for."""
    src = pathlib.Path(shutil.copy(_build.CSRC / "stanfem.cpp",
                                   tmp_path / "stanfem.cpp"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")

    def no_nvcc():
        raise AssertionError("the host build asked for nvcc")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    calls = []
    run = subprocess.run

    def counted(cmd, **kw):
        calls.append(cmd)
        return run(cmd, **kw)

    monkeypatch.setattr(_build.subprocess, "run", counted)
    return src, calls


def test_host_build_compiles_once(host_build):
    src, calls = host_build
    lib = _build.build_host(src)
    assert lib.exists() and lib.parent == _build.BUILD_DIR
    assert lib.with_suffix(".log").exists()
    assert len(calls) == 1 and calls[0][0].endswith("c++")
    assert list(_build.HOST_FLAGS) == calls[0][1:6]
    assert _build.build_host(src) == lib and len(calls) == 1
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])  # no temporary left
    loaded = ctypes.CDLL(str(lib))
    for name in ENTRIES:
        assert hasattr(loaded, name), name


def test_host_build_key_follows_source_and_flags(host_build, monkeypatch):
    src = host_build[0]
    key = _build.host_library_path(src).name
    assert key == _build.host_library_path(_build.CSRC / "stanfem.cpp").name
    assert key.startswith("stanfem-")
    src.write_text(src.read_text() + "\n// edited\n")
    edited = _build.host_library_path(src).name
    assert edited != key
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ("-g",))
    assert _build.host_library_path(src).name not in (key, edited)


def test_host_build_failure_raises_with_the_log(host_build, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        _build.build_host(bad)
    assert not _build.host_library_path(bad).exists()
    assert [p.suffix for p in _build.BUILD_DIR.iterdir()] == [".log"]


def test_host_build_without_a_compiler_raises(host_build, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        _build.build_host(host_build[0])
    assert host_build[1] == []
