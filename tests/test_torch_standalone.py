"""The port stands alone: it imports nothing of stan_tpu, and its copies of
the reference's host modules (meshgen, model, STdb IO, checkpoints) agree
with the originals.

The import scan reads the source, so it also sees imports inside functions
that no test calls. The subprocess check that nothing of stan_tpu, jax or
jaxlib is loaded after a solve and a CLI run is
tests/test_torch_linear.py::test_port_never_imports_jax.
"""

import ast
import pathlib

import numpy as np
import pytest

from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.io import stdb as jstdb
from stan_tpu.utils import checkpoint as jckpt
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.io import stdb
from stan_tpu_torch.utils import checkpoint as ckpt

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in
                    (REPO / "stan_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


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
           if m.split(".")[0] in ("stan_tpu", "jax", "jaxlib")]
    assert not bad, f"{rel} imports {bad}"


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
