"""The port stands alone: it imports nothing of stan_tpu, jax or optax, and
its copies of the reference's host modules (meshgen, model, validation,
STdb IO with its protobuf writer, checkpoints, the .vtu writer, the .bdf
reader and writer, run records, the float64 host operators, the banded
solver and its BFS order) agree with the originals.

The import scan reads the source, so it also sees imports inside functions
that no test calls. The subprocess check that nothing of stan_tpu, jax or
jaxlib is loaded after a solve and a CLI run is
tests/test_torch_linear.py::test_port_never_imports_jax.
"""

import ast
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.io import nastran as jnastran
from stan_tpu.io import stdb as jstdb
from stan_tpu.io import vtu as jvtu
from stan_tpu.utils import checkpoint as jckpt
from stan_tpu.utils import runlog as jrunlog
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.io import nastran, stdb, vtu
from stan_tpu_torch.utils import checkpoint as ckpt
from stan_tpu_torch.utils import runlog

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in
                    (REPO / "stan_tpu_torch").rglob("*.py")) + [
                        "chip_smoke.py", "chip_tune.py",
                        "tests/torch_multiprocess_worker.py"]


def _imported_modules(tree):
    """Every module an import statement of the tree names, at any depth."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                raise AssertionError(f"relative import at line {node.lineno}")
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_nothing_of_stan_tpu(rel):
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in ("stan_tpu", "jax", "jaxlib", "optax")]
    assert not bad, f"{rel} imports {bad}"


def test_scan_covers_every_port_module():
    """The scan reads every module of the port, parallel/ included."""
    for name in ("distributed", "partition", "sharded", "sharded_stencil"):
        assert f"stan_tpu_torch/parallel/{name}.py" in PORT_FILES
    assert len(PORT_FILES) == len(set(PORT_FILES)) > 40


# The port's copies of host modules of the reference, each headed by the
# name of its source.
HOST_COPIES = ["core/model.py", "core/meshgen.py", "core/validate.py",
               "fem/elements.py", "fem/hostops.py", "io/wire.py",
               "io/stdb_pb2.py", "io/stdb.py", "io/vtu.py", "io/nastran.py",
               "utils/config.py", "utils/checkpoint.py", "utils/runlog.py",
               "solvers/banded.py", "parallel/partition.py", "native.py"]


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copy_names_its_source(rel):
    head = (REPO / "stan_tpu_torch" / rel).read_text().splitlines()[:2]
    assert any(re.match(rf"# Copied (unchanged )?from stan_tpu/{rel}\b", line)
               for line in head), head
    assert (REPO / "stan_tpu" / rel).exists()


# Functions of the host copies whose code is the reference's, statement for
# statement (the others differ in their imports or in how they read a
# tensor).
SAME_CODE = [("core/validate.py", "ValidationError"),
             ("core/validate.py", "check_model"),
             ("core/validate.py", "validate"),
             ("fem/hostops.py", "_b_matrix_np"),
             ("fem/hostops.py", "element_stiffness_np"),
             ("fem/hostops.py", "d_np"),
             ("fem/hostops.py", "general_apply_np"),
             ("io/stdb.py", "to_proto"),
             ("io/stdb.py", "_matrix"),
             ("io/stdb.py", "from_proto")]


# Statements a function of a host copy adds to the reference's code, each
# left out before the comparison: check_model also names the elements whose
# Jacobian determinant is not positive.
ADDED = {("core/validate.py", "check_model"):
         ["problems.extend(_inverted_elements(model))"]}


def _top_level(rel, root, added=()):
    tree = ast.parse((REPO / root / rel).read_text())
    out = {}
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            n.body = [b for b in n.body if ast.unparse(b) not in added]
            out[n.name] = ast.dump(n)
    return out


@pytest.mark.parametrize("rel,name", SAME_CODE,
                         ids=[f"{r}:{n}" for r, n in SAME_CODE])
def test_host_copy_keeps_the_reference_code(rel, name):
    added = ADDED.get((rel, name), ())
    port = (REPO / "stan_tpu_torch" / rel).read_text()
    assert all(a in port for a in added)
    assert _top_level(rel, "stan_tpu_torch", added)[name] == _top_level(
        rel, "stan_tpu")[name]


# Reference functions a host copy leaves out, each because no path of the
# port would call it: native.available (every path calls the library and
# raises if it cannot be built) and native.node_incidence (the incidence
# tables are fem/operator.node_incidence's, in numpy, as in the reference).
LEFT_OUT = {"native.py": {"available", "node_incidence"}}


@pytest.mark.parametrize("rel", ["fem/hostops.py", "core/validate.py",
                                 "io/stdb.py", "io/nastran.py",
                                 "parallel/partition.py", "native.py"])
def test_host_copy_has_every_reference_function(rel):
    missing = set(_top_level(rel, "stan_tpu")) - set(
        _top_level(rel, "stan_tpu_torch"))
    assert missing == LEFT_OUT.get(rel, set())


HOST_SOURCES = sorted(str(p.relative_to(REPO)) for p in
                      (REPO / "stan_tpu_torch" / "csrc").iterdir())


@pytest.mark.parametrize("rel", PORT_FILES + HOST_SOURCES)
def test_port_file_names_no_reference_library(rel):
    """The port builds its own host runtime from csrc/stanfem.cpp: no file
    of it names the reference's native/ folder or its library, apart from
    the header that names the copy's source."""
    lines = (REPO / rel).read_text().splitlines()
    bad = [n for n, line in enumerate(lines, 1)
           if re.search(r"(?<![\w.])native/|libstanfem", line)
           and not (n == 1 and line.startswith("// Copied from native/"))]
    assert not bad, f"{rel} names native/ or libstanfem at lines {bad}"


def test_host_runtime_names_its_source():
    head = (REPO / "stan_tpu_torch/csrc/stanfem.cpp").read_text()
    assert head.startswith("// Copied from native/stanfem.cpp")
    assert (REPO / "native/stanfem.cpp").exists()


def test_import_scan_sees_lazy_imports():
    tree = ast.parse("def f():\n    from stan_tpu.io import stdb\n"
                     "    import stan_tpu.core.model\n"
                     "    importlib.import_module('stan_tpu')\n")
    assert list(_imported_modules(tree)) == ["stan_tpu.io",
                                             "stan_tpu.core.model",
                                             "stan_tpu"]


BEAMS = [((3, 2, 2), {}), ((5, 4, 3), {"lx": 6.0, "ly": 1.5, "lz": 3.0}),
         ((4, 3, 3), {"load": (5.0, -2.0, -10.0)})]


@pytest.mark.parametrize("n,kw", BEAMS)
def test_hex_beam_equals_reference(n, kw):
    m, j = meshgen.hex_beam(*n, **kw), jmeshgen.hex_beam(*n, **kw)
    for name in ("node_ids", "coords", "elem_ids", "conn", "elem_pid",
                 "elem_mat"):
        np.testing.assert_array_equal(getattr(m, name), getattr(j, name))
    assert m.elem_type == j.elem_type
    np.testing.assert_array_equal(m.fix_mask(), j.fix_mask())
    np.testing.assert_array_equal(m.load_vector(), j.load_vector())
    np.testing.assert_array_equal(m.elem_d_matrices(), j.elem_d_matrices())
    assert sorted(m.materials) == sorted(j.materials)
    for k in m.materials:
        assert vars(m.materials[k]) == vars(j.materials[k])


@pytest.mark.parametrize("n,kw", BEAMS)
def test_stdb_bytes_equal_reference(n, kw):
    assert (stdb.serialize(meshgen.hex_beam(*n, **kw))
            == jstdb.serialize(jmeshgen.hex_beam(*n, **kw)))


def test_both_generated_bindings_share_one_message_type():
    from stan_tpu.io import stdb_pb2 as jpb
    from stan_tpu_torch.io import stdb_pb2 as pb

    assert pb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert pb.Database.DESCRIPTOR.full_name == jpb.Database.DESCRIPTOR.full_name


def _same_model(a, b):
    for name in ("node_ids", "coords", "elem_ids", "conn", "elem_pid",
                 "elem_mat"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.elem_type == b.elem_type
    assert vars(a.analysis) == vars(b.analysis)
    for name in ("disp", "strain", "stress"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.fix_mask(), b.fix_mask())
    np.testing.assert_array_equal(a.load_vector(), b.load_vector())


@pytest.mark.parametrize("with_results", [False, True])
def test_stdb_files_read_both_ways(tmp_path, with_results):
    m = meshgen.hex_beam(4, 3, 2)
    if with_results:
        rng = np.random.default_rng(0)
        m.disp = rng.standard_normal((2, m.nnode, 3))
        m.strain = rng.standard_normal((2, m.nelem, 8, 6))
        m.stress = rng.standard_normal((2, m.nelem, 8, 6))
        m.analysis.result_step_no = 1
    mine, theirs = str(tmp_path / "port.STdb"), str(tmp_path / "ref.STdb")
    stdb.write(m, mine)
    jstdb.write(m, theirs)
    _same_model(jstdb.read(mine), m)
    _same_model(stdb.read(theirs), m)
    _same_model(stdb.read(mine), jstdb.read(theirs))


def test_reference_checkpoint_loads_through_the_port(tmp_path):
    """A checkpoint as run_chains writes it (state tree plus draw chunks),
    written by the reference's module, read by the port's, and back."""
    rng = np.random.default_rng(1)
    tree = {"kernel": "torch-hmc:leapfrog8", "n_warmup": 10, "n_done": 4,
            "theta": rng.standard_normal((16, 3)),
            "dual": {"log_eps": rng.standard_normal(16), "t": 3.0},
            "steps": [np.float64(0.02), np.int64(7)], "done": True}
    path = str(tmp_path / "hmc.ckpt")
    jckpt.save(path, tree)
    jckpt.save_chunk(path, 0, rng.standard_normal((16, 2, 3)))
    jckpt.save_chunk(path, 1, rng.standard_normal((16, 2, 3)))
    got = ckpt.load(path)
    assert got.keys() == tree.keys()
    np.testing.assert_array_equal(got["theta"], tree["theta"])
    np.testing.assert_array_equal(got["dual"]["log_eps"],
                                  tree["dual"]["log_eps"])
    assert (got["kernel"], got["n_warmup"], got["n_done"], got["done"]) == (
        "torch-hmc:leapfrog8", 10, 4, True)
    assert float(got["dual"]["t"]) == 3.0
    assert [float(s) for s in got["steps"]] == [0.02, 7.0]
    for a, b in zip(ckpt.load_chunks(path, 2), jckpt.load_chunks(path, 2)):
        np.testing.assert_array_equal(a, b)
    ckpt.save(path, got)
    back = jckpt.load(path)
    np.testing.assert_array_equal(back["theta"], tree["theta"])
    assert ckpt.clean_chunks(path) == 2


@pytest.mark.parametrize("binary", [True, False])
def test_vtu_file_equals_reference(tmp_path, binary):
    """The copied writer writes the reference's bytes."""
    m = jmeshgen.hex_beam(3, 2, 1)
    rng = np.random.default_rng(2)
    kw = dict(point_data={"p": rng.normal(size=(m.nnode, 3))},
              cell_data={"c": rng.normal(size=m.nelem)}, binary=binary)
    vtu.write_vtu(str(tmp_path / "a.vtu"), m.coords, m.conn, **kw)
    jvtu.write_vtu(str(tmp_path / "b.vtu"), m.coords, m.conn, **kw)
    assert (tmp_path / "a.vtu").read_bytes() == (tmp_path / "b.vtu"
                                                 ).read_bytes()


def test_write_bdf_equals_reference(tmp_path):
    m = meshgen.hex_beam(4, 3, 2, lx=6.0, ly=1.5, lz=3.0)
    nastran.write_bdf(m, str(tmp_path / "a.bdf"), comment="x")
    jnastran.write_bdf(m, str(tmp_path / "b.bdf"), comment="x")
    assert (tmp_path / "a.bdf").read_text() == (tmp_path / "b.bdf"
                                                ).read_text()
    # and each reads the other's file into the same mesh
    a = nastran.read_bdf(str(tmp_path / "b.bdf"))
    b = jnastran.read_bdf(str(tmp_path / "a.bdf"), use_native=False)
    for name in ("node_ids", "coords", "elem_ids", "conn", "elem_pid"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_runlog_record_equals_reference():
    """The same record as the reference's, but for the clock and the pid,
    for the fields both can write."""
    m = meshgen.hex_beam(2, 2, 2)
    kw = dict(model=m, iters=np.int64(17), residual=np.float32(1e-7),
              converged=True, per_chain=np.array([1.5, 2.5]))
    ref = jrunlog.make_record("solve", **kw)
    mine = runlog.make_record("solve", **kw)
    for r in (ref, mine):
        del r["unix_time"], r["pid"]
    assert mine.keys() == ref.keys()
    dumped = [json.dumps(r, default=c) for r, c in
              ((mine, runlog._coerce), (ref, jrunlog._coerce))]
    assert dumped[0] == dumped[1]


def test_infer_package_exports_the_reference_names():
    """stan_tpu_torch.infer re-exports, from the port's own modules, every
    name stan_tpu/infer/__init__.py does; importing it (in a fresh
    process) loads no torch._dynamo, whose cost stays at the first use of
    a torch.optim optimiser."""
    tree = ast.parse((REPO / "stan_tpu" / "infer" / "__init__.py").read_text())
    names = sorted(a.asname or a.name for node in ast.walk(tree)
                   if isinstance(node, ast.ImportFrom) for a in node.names)
    assert "run_hmc" in names and "CalibrationProblem" in names
    code = ("import json, sys\nimport stan_tpu_torch.infer as inf\n"
            f"names = {names!r}\n"
            "print(json.dumps([[n, getattr(inf, n).__module__] for n in "
            "names] + ['torch._dynamo' in sys.modules]))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    *found, dynamo = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [n for n, _ in found] == names
    assert all(mod.startswith("stan_tpu_torch.infer.") for _, mod in found)
    assert dynamo is False
