"""Port parity: post-processing fields and the .vtu export of stan_tpu_torch
against stan_tpu.post.fields and stan_tpu.io.vtu, in float64 on the CPU.

Every case of tests/test_post.py and the vtu cases of tests/test_io.py run
through the port; the 96 field arrays of a solve and the decoded arrays of
an ascii export agree with the reference's on the same numpy inputs to
1e-12 of each array's largest magnitude.
"""

import base64
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from stan_tpu.io import vtu as jvtu
from stan_tpu.post import fields as jfields
from stan_tpu_torch.analysis.linear import solve_linear_statics
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.io import vtu
from stan_tpu_torch.post import fields

F64 = torch.float64
CPU = dict(device="cpu")


def _solved(*n, **kw):
    m = meshgen.hex_beam(*n, **kw)
    solve_linear_statics(m, device="cpu", dtype=F64)
    return m


def _voigt(S):
    return np.stack([S[:, 0, 0], S[:, 1, 1], S[:, 2, 2], S[:, 0, 1],
                     S[:, 1, 2], S[:, 0, 2]], axis=-1)


def test_principal_values_match_eigvalsh_and_reference():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(100, 3, 3))
    S = A + np.swapaxes(A, 1, 2)
    voigt = _voigt(S)
    got = fields.principal_values_sym3(torch.as_tensor(voigt)).numpy()
    want = np.linalg.eigvalsh(S)[:, ::-1]  # descending
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)
    ref = np.asarray(jfields.principal_values_sym3(voigt))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_principal_values_degenerate():
    # Hydrostatic state: all eigenvalues equal, p == 0 branch
    voigt = torch.tensor([[5.0, 5.0, 5.0, 0.0, 0.0, 0.0]], dtype=F64)
    got = fields.principal_values_sym3(voigt).numpy()
    np.testing.assert_allclose(got, [[5.0, 5.0, 5.0]], atol=1e-12)


def test_von_mises_uniaxial():
    # Uniaxial sigma_xx = s: von Mises = |s|
    f = fields._tensor_fields(torch.tensor([[100.0, 0, 0, 0, 0, 0]],
                                           dtype=F64)).numpy()
    assert f[0, 9] == pytest.approx(100.0, rel=1e-8)
    # Repeated-eigenvalue case: the trigonometric closed form carries
    # O(sqrt(eps)*scale) error at degenerate roots — atol scaled to |s|.
    np.testing.assert_allclose(f[0, 6:9], [100.0, 0.0, 0.0], atol=1e-4)


def test_compute_all_names_and_uniaxial_stress():
    m = meshgen.uniaxial_bar(4, E=1000.0, force=100.0)
    solve_linear_statics(m, device="cpu", dtype=F64)
    out = fields.compute_all(m, 1, **CPU)
    # 24 fields x (Max/Average/Min cell + point) = 96 arrays
    assert len(out) == 96
    assert "Max Stress XX INC 1" in out
    assert "von Mises Stress INC 1" in out
    # Uniaxial bar: stress_xx = F/A = 100 everywhere
    np.testing.assert_allclose(out["Stress XX INC 1"], 100.0, rtol=1e-5)
    np.testing.assert_allclose(
        out["Average von Mises Stress INC 1"], 100.0, rtol=1e-5)
    # Point and cell variants agree for a uniform field
    np.testing.assert_allclose(
        out["Max Stress XX INC 1"], out["Min Stress XX INC 1"], rtol=1e-6)
    # Effective strain = (2/3) * vm(strain): uniaxial nu=0 -> gamma=0,
    # principals (e, 0, 0) -> eff = (2/3)*e
    np.testing.assert_allclose(
        out["Effective Strain INC 1"], (2.0 / 3.0) * 100.0 / 1000.0,
        rtol=1e-5)


@pytest.mark.parametrize("inc", [0, 1])
def test_compute_all_matches_reference(inc):
    """hex_beam(3,2,2) solved by the port, the same numpy disp / stress /
    strain through both compute_all: the same 96 names in the same order,
    every array within 1e-12 of its largest magnitude."""
    m = _solved(3, 2, 2)
    got = fields.compute_all(m, inc, **CPU)
    ref = jfields.compute_all(m, inc)
    assert list(got) == list(ref) and len(got) == 96
    for name, want in ref.items():
        want = np.asarray(want)
        assert got[name].dtype == np.float64 and got[name].shape == want.shape
        np.testing.assert_allclose(
            got[name], want, rtol=0,
            atol=1e-12 * max(np.abs(want).max(), 1e-300), err_msg=name)


def test_point_fields_average_over_adjacent_elements():
    """index_add_ segment mean: a node's value is the mean over the
    element-nodes that share it; a node no element touches stays 0."""
    en = torch.arange(2 * 2 * 3, dtype=F64).reshape(2, 2, 3)
    conn = torch.tensor([[0, 1], [1, 2]])
    got = fields.point_fields(en, conn, 4).numpy()
    np.testing.assert_array_equal(got, [[0, 1, 2], [4.5, 5.5, 6.5],
                                        [9, 10, 11], [0, 0, 0]])


def test_compute_all_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the refusal is for machines "
                    "without one")
    m = _solved(2, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fields.compute_all(m, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fields.export_vtu(m, "unused")


def test_export_vtu_files(tmp_path):
    m = _solved(2, 2, 2)
    paths = fields.export_vtu(m, str(tmp_path / "res"), binary=False, **CPU)
    assert len(paths) == 2  # increments 0 and 1
    arrays = vtu.read_vtu_ascii(paths[1])
    assert "Displacement Z INC 1" in arrays
    # Deformed export: point coords = coords + disp
    assert np.abs(m.disp[1]).max() > 0
    got = arrays["_anon0"].reshape(-1, 3)  # Points array has no Name
    np.testing.assert_allclose(got, m.coords + m.disp[1], atol=1e-6)
    # Cell variants ship as CellData with one value per element.
    assert "Max von Mises Stress INC 1" in arrays
    assert "Average Strain P1 INC 1" in arrays
    assert arrays["Min Stress XX INC 1"].size == m.nelem
    vm_max = arrays["Max von Mises Stress INC 1"]
    vm_min = arrays["Min von Mises Stress INC 1"]
    assert (vm_max >= vm_min - 1e-6).all()


def test_export_vtu_field_filter_and_no_cells(tmp_path):
    m = _solved(2, 2, 2)
    paths = fields.export_vtu(
        m, str(tmp_path / "res"), binary=False,
        fields=["Total Displacement"], cell_variants=False, **CPU)
    arrays = vtu.read_vtu_ascii(paths[1])
    assert "Total Displacement INC 1" in arrays
    assert "Max Total Displacement INC 1" not in arrays
    assert "Stress XX INC 1" not in arrays


def _array_names(path):
    return [el.attrib.get("Name") for el in
            ET.parse(path).getroot().iter("DataArray")]


@pytest.mark.parametrize("deformed", [True, False])
def test_export_vtu_matches_reference(tmp_path, deformed):
    """The port's and the reference's ascii export of one model: the same
    arrays, names and order, values within 1e-12 of each array's scale."""
    m = _solved(3, 2, 2)
    mine = fields.export_vtu(m, str(tmp_path / "port"), binary=False,
                             deformed=deformed, increments=[1], **CPU)
    theirs = jfields.export_vtu(m, str(tmp_path / "ref"), binary=False,
                                deformed=deformed, increments=[1])
    assert [p.rsplit("_", 1)[1] for p in mine] == ["001.vtu"]
    assert _array_names(mine[0]) == _array_names(theirs[0])
    got, want = vtu.read_vtu_ascii(mine[0]), jvtu.read_vtu_ascii(theirs[0])
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(
            got[name], want[name], rtol=0,
            atol=1e-12 * max(np.abs(want[name]).max(), 1e-300),
            err_msg=name)


def test_vtu_ascii_roundtrip(tmp_path):
    m = meshgen.hex_beam(2, 1, 1)
    path = str(tmp_path / "out.vtu")
    pd = {"field": np.arange(m.nnode, dtype=np.float64)}
    cd = {"cfield": np.arange(m.nelem, dtype=np.float64)}
    vtu.write_vtu(path, m.coords, m.conn, point_data=pd, cell_data=cd,
                  binary=False)
    arrays = vtu.read_vtu_ascii(path)
    np.testing.assert_allclose(arrays["field"], pd["field"])
    np.testing.assert_allclose(arrays["cfield"], cd["cfield"])
    np.testing.assert_allclose(arrays["connectivity"], m.conn.ravel())
    np.testing.assert_allclose(arrays["offsets"],
                               np.arange(1, m.nelem + 1) * 8)
    assert (arrays["types"] == vtu.VTK_HEXAHEDRON).all()


def test_vtu_binary_decodes(tmp_path):
    m = meshgen.hex_beam(2, 1, 1)
    path = str(tmp_path / "out.vtu")
    vtu.write_vtu(path, m.coords, m.conn,
                  point_data={"f": np.arange(m.nnode, dtype=np.float64)})
    root = ET.parse(path).getroot()
    assert root.attrib["type"] == "UnstructuredGrid"
    (arr,) = [el for el in root.iter("DataArray")
              if el.attrib.get("Name") == "f"]
    raw = base64.b64decode(arr.text.strip())
    n = np.frombuffer(raw[:4], dtype=np.uint32)[0]
    vals = np.frombuffer(raw[4:4 + n], dtype=np.float32)
    np.testing.assert_allclose(vals, np.arange(m.nnode, dtype=np.float32))
