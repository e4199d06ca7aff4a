# Copied from stan_tpu/io/nastran.py (use_native=False is read_bdf_python).
"""Nastran bulk-data (.bdf) mesh import.

Host-side parser reproducing the reference's reader so its meshes load
unmodified (reference: src/STAN_Database/Database.cs:39-111 ReadNastranMesh,
src/STAN_Database/Node.cs:25-80 GRID parsing,
src/STAN_Database/Element.cs:35-73 CHEXA parsing). Behavioral parity points:

  * lines starting with ``$`` are comments (Database.cs:55);
  * element cards are detected by substring match against the allowed type
    list and continuation lines starting with ``+`` or a space are appended
    (Database.cs:60-71); the released reference whitelists CHEXA only
    (Database.cs:44-48) — here CTETRA is also accepted (the TET4 formulation
    exists in both codebases) unless ``strict=True``;
  * GRID cards are split into fixed 8-char fields, blank fields dropped, and
    the .bdf numeric quirks repaired: embedded exponent without ``e``
    (``1.23-4`` -> ``1.23e-4``), leading ``.`` (Node.cs:40-63). The reference's
    handling of embedded ``+`` exponents is a no-op bug (the Replace result is
    discarded, Node.cs:52-55, so such nodes land in Import_Error); here
    ``1.23+4`` parses correctly as ``1.23e+4``;
  * element fields are whitespace-split with ``+`` separators stripped and
    non-integer tokens skipped (Element.cs:41-56);
  * default formulations by card: CHEXA -> HEX8_G2, CTETRA -> TET4_G2,
    CPENTA -> PENTA6_G2 (Element.cs:58-61); PENTA6 has no implementation in
    either codebase and is rejected here at read time rather than at solve;
  * parts are created from the distinct PIDs, sorted (Database.cs:101-110).

Parse failures are collected per-card into ``import_errors`` (the analogue of
``Database.Import_Error``, Database.cs:18) instead of aborting the read.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from stan_tpu_torch.core.model import FEModel, PartInfo

# Card name -> (default formulation, node count)
_CARD_TYPES = {
    "CHEXA": ("HEX8_G2", 8),
    "CTETRA": ("TET4_G2", 4),
}
_DEFAULT_ALLOWED = ("CHEXA", "CTETRA")
_STRICT_ALLOWED = ("CHEXA",)  # the reference's release whitelist


def _parse_bdf_number(text: str) -> float:
    """Parse one .bdf numeric field with format quirks (Node.cs:40-63)."""
    text = text.strip()
    if "e" not in text and "E" not in text:
        # Exponent written as bare sign: 1.23-4 / 1.23+4 (sign not at char 0).
        body = text[1:]
        for sign in ("-", "+"):
            if sign in body:
                text = text[0] + body.replace(sign, "e" + sign)
                break
    if text.startswith("."):
        text = "0" + text
    elif text.startswith("-."):
        text = "-0" + text[1:]
    return float(text)


def _grid_fields(line: str) -> List[str]:
    """Split a small-field card into its non-blank 8-char columns.

    The line is right-padded to a full column first — the reference's
    ``input.Length / 8`` loop (Node.cs:30) silently drops a trailing partial
    column, which matters for hand-edited files with unpadded last fields.
    """
    ncol = -(-len(line) // 8)
    line = line.ljust(ncol * 8)
    out = []
    for i in range(ncol):
        field = line[i * 8 : (i + 1) * 8].replace(" ", "")
        if field:
            out.append(field)
    return out


@dataclasses.dataclass
class _RawElement:
    eid: int
    pid: int
    nodes: List[int]
    etype: str


def read_bdf(path: str, *, strict: bool = False) -> FEModel:
    """Read a Nastran .bdf mesh into an FEModel.

    ``strict=True`` restricts element import to the reference's whitelist
    (CHEXA only, Database.cs:44-48). The native C++ parser
    (csrc/stanfem.cpp) reads the file; a file with parse errors, or with
    mixed element families, is read again by the Python parser
    (read_bdf_python), so the offending card text is collected into
    ``import_errors`` (the reference keeps the raw lines, Database.cs:72-94).
    """
    from stan_tpu_torch import native

    parsed = native.bdf_parse(path, strict=strict)
    if parsed is not None and parsed[5] == 0:
        node_ids, coords, elem_ids, elem_pids, conn, _ = parsed
        npe = conn.shape[1] if conn.size else 8
        etype = "HEX8_G2" if npe == 8 else "TET4_G2"
        model = FEModel(
            node_ids=node_ids,
            coords=coords,
            elem_ids=elem_ids,
            conn=conn,
            elem_pid=elem_pids,
            elem_type=[etype] * len(elem_ids),
            elem_mat=np.zeros(len(elem_ids), dtype=np.int64),
        )
        for pid in sorted(set(int(p) for p in elem_pids)):
            model.part_info[pid] = PartInfo(name=f"Part_{pid}")
        return model
    return read_bdf_python(path, strict=strict)


def read_bdf_python(path: str, *, strict: bool = False) -> FEModel:
    """The Python parser alone: read_bdf's semantic spec, and its path for
    a file that the native parser declines or finds errors in."""
    with open(path, "r", errors="replace") as f:
        data = f.read().splitlines()
    return _parse_lines(data, strict=strict)


def _parse_lines(data: List[str], *, strict: bool = False) -> FEModel:
    allowed = _STRICT_ALLOWED if strict else _DEFAULT_ALLOWED
    nodes: dict[int, tuple[float, float, float]] = {}
    elements: List[_RawElement] = []
    errors: List[str] = []

    i = 0
    while i < len(data):
        line = data[i]
        if line.startswith("$"):
            i += 1
            continue
        if any(card in line for card in allowed):
            # Collect continuation lines (start with '+' or ' ',
            # Database.cs:60-71).
            text = line
            j = i + 1
            while j < len(data) and (
                data[j].startswith("+") or data[j].startswith(" ")
            ):
                text += data[j]
                j += 1
            i = j
            try:
                elements.append(_parse_element(text))
            except Exception:
                errors.append(text)
            continue
        if line.startswith("GRID"):
            try:
                fields = _grid_fields(line)
                # fields: [GRID, ID, X, Y, Z, ...] after blank (CP) removal —
                # same positional convention as Node.cs:66-70.
                nid = int(fields[1])
                nodes[nid] = (
                    _parse_bdf_number(fields[2]),
                    _parse_bdf_number(fields[3]),
                    _parse_bdf_number(fields[4]),
                )
            except Exception:
                errors.append(line)
        i += 1

    node_ids = np.array(sorted(nodes), dtype=np.int64)
    coords = np.array([nodes[int(n)] for n in node_ids], dtype=np.float64)
    if coords.size == 0:
        coords = coords.reshape(0, 3)

    # Uniform node count required by the batched kernels: group by card type.
    kinds = {e.etype for e in elements}
    if len(kinds) > 1:
        raise ValueError(
            f"Mixed element families in one mesh not yet supported: {sorted(kinds)}"
        )
    nn = _CARD_TYPES[next(iter(kinds))][1] if elements else 8

    conn_ext = np.array(
        [e.nodes[:nn] for e in elements], dtype=np.int64
    ).reshape(len(elements), nn)
    conn = np.searchsorted(node_ids, conn_ext)
    bad = ~np.all(
        node_ids[np.clip(conn, 0, max(len(node_ids) - 1, 0))] == conn_ext, axis=1
    ) if len(elements) else np.zeros(0, dtype=bool)
    if np.any(bad):
        for k in np.nonzero(bad)[0]:
            errors.append(f"element {elements[k].eid}: unknown node reference")
        keep = ~bad
        elements = [e for e, k in zip(elements, keep) if k]
        conn_ext, conn = conn_ext[keep], conn[keep]

    model = FEModel(
        node_ids=node_ids,
        coords=coords,
        elem_ids=np.array([e.eid for e in elements], dtype=np.int64),
        conn=conn,
        elem_pid=np.array([e.pid for e in elements], dtype=np.int64),
        elem_type=[_CARD_TYPES[e.etype][0] for e in elements],
        elem_mat=np.zeros(len(elements), dtype=np.int64),
    )
    model.import_errors = errors  # analogue of Database.Import_Error

    # Parts from distinct PIDs, sorted (Database.cs:101-110).
    for pid in sorted(set(int(p) for p in model.elem_pid)):
        model.part_info[pid] = PartInfo(name=f"Part_{pid}")
    return model


def _parse_element(text: str) -> _RawElement:
    """Parse a concatenated element card (Element.cs:35-73)."""
    tokens = text.split()
    card = tokens[0]
    if card not in _CARD_TYPES:
        raise ValueError(f"Unsupported card {card}")
    eid = int(tokens[1])
    pid = int(tokens[2])
    node_ids = []
    for tok in tokens[3:]:
        tok = tok.replace("+", "")  # '+' continuation markers (Element.cs:50)
        try:
            node_ids.append(int(tok))
        except ValueError:
            continue
    etype, nn = _CARD_TYPES[card]
    if len(node_ids) < nn:
        raise ValueError(f"{card} {eid}: expected {nn} nodes, got {len(node_ids)}")
    return _RawElement(eid=eid, pid=pid, nodes=node_ids, etype=card)


# ---------------------------------------------------------------------------
# Writer (tests + interop: lets our meshes load in the reference GUI)
# ---------------------------------------------------------------------------

_CARD_BY_TYPE = {"HEX8": "CHEXA", "TET4": "CTETRA"}


def write_bdf(model: FEModel, path: str, *, comment: Optional[str] = None) -> None:
    """Write the mesh as small-field .bdf (GRID + element cards)."""
    with open(path, "w") as f:
        f.write(f"$ stan_tpu mesh export: {comment or ''}\n")
        for i, nid in enumerate(model.node_ids):
            x, y, z = model.coords[i]
            f.write(
                f"GRID    {int(nid):<8d}        "
                f"{_field(x)}{_field(y)}{_field(z)}\n"
            )
        for e in range(model.nelem):
            card = _CARD_BY_TYPE.get(model.elem_type[e][:4], "CHEXA")
            nids = [int(model.node_ids[n]) for n in model.conn[e]]
            line = f"{card:<8s}{int(model.elem_ids[e]):<8d}{int(model.elem_pid[e]):<8d}"
            for k, nid in enumerate(nids):
                if k == 5:  # small-field cards hold 6 values after EID/PID
                    f.write(line + "+\n")
                    line = "+       "
                line += f"{nid:<8d}"
            f.write(line + "\n")
        f.write("ENDDATA\n")


def _field(v: float) -> str:
    """Format a float into an 8-char small-field column."""
    s = f"{v:<8.6g}"
    if len(s) > 8:
        s = f"{v:<8.2e}"
    return s[:8]
