# Copied from stan_tpu/io/vtu.py; the port keeps its own copy.
"""VTK XML UnstructuredGrid (.vtu) writer — no VTK dependency.

Replaces the reference's Activiz/VTK export pipeline
(src/STAN_PrePost/ExportWindow.xaml.cs:43-108: one
vtkXMLUnstructuredGridWriter file per increment, binary or ascii) with a
small self-contained writer. ParaView reads the output; array names match
the reference's result naming (src/STAN_Database/Part.cs:395-428) when
driven through post/fields.py.

Binary mode is the standard inline-base64 VTU encoding (appended-data-free):
each DataArray payload is base64(uint32 byte count || raw little-endian
bytes), ``header_type="UInt32"``, no compression.
"""

from __future__ import annotations

import base64
from typing import Dict, Mapping, Optional

import numpy as np

# VTK cell type ids (VTK source: vtkCellType.h — public constants)
VTK_TETRA = 10
VTK_HEXAHEDRON = 12

_CELL_TYPE_BY_NN = {4: VTK_TETRA, 8: VTK_HEXAHEDRON}

_VTK_DTYPE = {
    np.dtype(np.float32): "Float32",
    np.dtype(np.float64): "Float64",
    np.dtype(np.int32): "Int32",
    np.dtype(np.int64): "Int64",
    np.dtype(np.uint8): "UInt8",
}


def _data_array(
    name: Optional[str], arr: np.ndarray, binary: bool, indent: str
) -> str:
    arr = np.ascontiguousarray(arr)
    ncomp = arr.shape[1] if arr.ndim == 2 else 1
    vtk_type = _VTK_DTYPE[arr.dtype]
    name_attr = f' Name="{name}"' if name else ""
    comp_attr = f' NumberOfComponents="{ncomp}"' if ncomp > 1 else ""
    if binary:
        raw = arr.tobytes()
        payload = base64.b64encode(
            np.uint32(len(raw)).tobytes() + raw
        ).decode("ascii")
        return (
            f'{indent}<DataArray type="{vtk_type}"{name_attr}{comp_attr} '
            f'format="binary">\n{indent}  {payload}\n{indent}</DataArray>\n'
        )
    flat = arr.ravel()
    if arr.dtype.kind == "f":
        body = " ".join(repr(float(v)) for v in flat)
    else:
        body = " ".join(str(int(v)) for v in flat)
    return (
        f'{indent}<DataArray type="{vtk_type}"{name_attr}{comp_attr} '
        f'format="ascii">\n{indent}  {body}\n{indent}</DataArray>\n'
    )


def write_vtu(
    path: str,
    points: np.ndarray,
    cells: np.ndarray,
    *,
    point_data: Optional[Mapping[str, np.ndarray]] = None,
    cell_data: Optional[Mapping[str, np.ndarray]] = None,
    binary: bool = True,
) -> None:
    """Write one unstructured grid.

    Args:
      points: f[nnode, 3] coordinates (deformed or undeformed).
      cells: i[ncell, nn] connectivity (dense 0-based); nn selects the VTK
        cell type (8 -> hexahedron, 4 -> tetra).
      point_data: name -> f[nnode] or f[nnode, k] arrays.
      cell_data: name -> f[ncell] or f[ncell, k] arrays.
      binary: inline-base64 binary (default) or ascii.
    """
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    cells = np.asarray(cells, dtype=np.int64)
    ncell, nn = cells.shape
    try:
        cell_type = _CELL_TYPE_BY_NN[nn]
    except KeyError:
        raise ValueError(f"Unsupported cell size {nn}") from None

    parts = [
        '<?xml version="1.0"?>\n'
        '<VTKFile type="UnstructuredGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt32">\n'
        "  <UnstructuredGrid>\n"
        f'    <Piece NumberOfPoints="{len(points)}" NumberOfCells="{ncell}">\n'
    ]
    parts.append("      <Points>\n")
    parts.append(_data_array(None, points, binary, "        "))
    parts.append("      </Points>\n")

    parts.append("      <Cells>\n")
    parts.append(
        _data_array("connectivity", cells.ravel(), binary, "        ")
    )
    offsets = (np.arange(1, ncell + 1, dtype=np.int64) * nn)
    parts.append(_data_array("offsets", offsets, binary, "        "))
    types = np.full(ncell, cell_type, dtype=np.uint8)
    parts.append(_data_array("types", types, binary, "        "))
    parts.append("      </Cells>\n")

    for tag, data in (("PointData", point_data), ("CellData", cell_data)):
        if not data:
            continue
        parts.append(f"      <{tag}>\n")
        for name, arr in data.items():
            parts.append(
                _data_array(name, np.asarray(arr, dtype=np.float32),
                            binary, "        ")
            )
        parts.append(f"      </{tag}>\n")

    parts.append("    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n")
    with open(path, "w") as f:
        f.write("".join(parts))


def read_vtu_ascii(path: str) -> Dict[str, np.ndarray]:
    """Minimal ascii .vtu reader for round-trip tests (not a general parser)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    out: Dict[str, np.ndarray] = {}
    for el in root.iter("DataArray"):
        if el.attrib.get("format") != "ascii":
            continue
        vals = np.array([float(v) for v in (el.text or "").split()])
        out[el.attrib.get("Name") or f"_anon{len(out)}"] = vals
    return out
