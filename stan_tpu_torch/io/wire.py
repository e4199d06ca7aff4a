# Copied from stan_tpu/io/wire.py; the port keeps its own copy.
"""Vectorized protobuf wire encoding for the STdb writer.

The reference's STdb file is protobuf-net output (implicit schema from the
[ProtoMember] attributes, src/STAN_Database/Database.cs:9-21); at the 1M-DOF
scale the generated-bindings writer in io/stdb.py spends minutes in Python
per-double loops. This module hand-rolls the wire format with numpy so the
whole node/element payload is encoded array-at-a-time.

Canonical encoding produced here (and asserted byte-for-byte in
tests/test_io.py against both a hand-written fixture and
``Message.SerializeToString(deterministic=True)``):

  * fields emitted in field-number order,
  * map entries (C# ``Dictionary<int,T>`` -> repeated entry {key=1, value=2})
    in ascending key order,
  * repeated scalars UNPACKED (one tag per value), matching protobuf-net's
    proto2-style default for ``double[]``/``List<int>``.

Only the wire types STdb uses are implemented: varint (0), fixed64 (1) and
length-delimited (2).
"""

from __future__ import annotations

import numpy as np


def tag(field: int, wire_type: int) -> int:
    return (field << 3) | wire_type


def varint(value: int) -> bytes:
    """Scalar varint (host framing of small messages)."""
    value = int(value)
    if value < 0:
        value += 1 << 64  # two's-complement, 10 bytes (protobuf int32/int64)
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varint_groups(values: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Padded varint encoding: (groups uint8[n, maxlen], keep bool[n, maxlen],
    lengths int64[n]). flat bytes = groups[keep]."""
    v = np.asarray(values, dtype=np.uint64).reshape(-1)
    lengths = np.ones(v.shape, dtype=np.int64)
    for cut in (7, 14, 21, 28, 35, 42, 49, 56, 63):
        lengths += v >= np.uint64(1 << cut)
    maxlen = int(lengths.max(initial=1))
    groups = np.empty(v.shape + (maxlen,), dtype=np.uint8)
    tmp = v.copy()
    for i in range(maxlen):
        groups[..., i] = (tmp & np.uint64(0x7F)).astype(np.uint8)
        tmp >>= np.uint64(7)
    idx = np.arange(maxlen)
    cont = idx[None, :] < (lengths[:, None] - 1)
    groups[cont] |= 0x80
    keep = idx[None, :] < lengths[:, None]
    return groups, keep, lengths


def varints(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized varint encoding of non-negative int64 values.

    Returns (flat uint8 bytes, byte length per value).
    """
    groups, keep, lengths = _varint_groups(values)
    return groups[keep], lengths


def uniform_stream(chunk: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """A per-row stream where every row has the same bytes layout.

    chunk: uint8[n, k] (k may be 0). Returns (flat, lengths).
    """
    chunk = np.ascontiguousarray(chunk, dtype=np.uint8)
    k = 0 if chunk.size == 0 else chunk.shape[-1]
    return chunk.reshape(-1), np.full(n, k, dtype=np.int64)


def const_stream(data: bytes, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Same literal bytes on every row."""
    arr = np.frombuffer(data, dtype=np.uint8)
    return np.tile(arr, n), np.full(n, len(arr), dtype=np.int64)


def fixed64_stream(field: int, values: np.ndarray, per_row: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """UNPACKED repeated double/fixed64: per value a 1-byte tag + 8 LE bytes.

    values: float64[n * per_row] row-major. Field number must be < 16
    (1-byte tag) — true for every STdb field.
    """
    assert field < 16
    values = np.ascontiguousarray(values, dtype="<f8").reshape(-1)
    total = values.size
    rec = np.empty((total, 9), dtype=np.uint8)
    rec[:, 0] = tag(field, 1)
    rec[:, 1:] = values.view(np.uint8).reshape(total, 8)
    n = total // per_row if per_row else 0
    return rec.reshape(-1), np.full(n, 9 * per_row, dtype=np.int64)


def tagged_varint_stream(field: int, values: np.ndarray, per_row: int
                         ) -> tuple[np.ndarray, np.ndarray]:
    """UNPACKED repeated int (or one scalar per row when per_row=1):
    per value a 1-byte tag + varint. values: int[n * per_row] row-major."""
    assert field < 16
    groups, keep, blen = _varint_groups(np.asarray(values).reshape(-1))
    total = len(blen)
    # Prepend the tag column, then compress with the validity mask — one
    # boolean extraction instead of per-byte repeat/arange scatters.
    rec = np.empty((total, groups.shape[1] + 1), dtype=np.uint8)
    rec[:, 0] = tag(field, 0)
    rec[:, 1:] = groups
    mask = np.empty((total, groups.shape[1] + 1), dtype=bool)
    mask[:, 0] = True
    mask[:, 1:] = keep
    flat = rec[mask]
    out_len = blen + 1
    n = total // per_row if per_row else 0
    row_len = out_len.reshape(n, per_row).sum(axis=1) if per_row else \
        np.zeros(0, np.int64)
    return flat, row_len


def ragged_tagged_varints(field: int, values: np.ndarray,
                          counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """UNPACKED repeated varints with a per-row count (e.g. Node.elist)."""
    flat, per_val = tagged_varint_stream(field, values, per_row=1)
    counts = np.asarray(counts, dtype=np.int64)
    row_len = np.zeros(len(counts), dtype=np.int64)
    if len(per_val):
        # Sum value byte-lengths per row. reduceat misbehaves on empty rows
        # (repeated offsets), so scatter-add instead.
        np.add.at(row_len, np.repeat(np.arange(len(counts)), counts), per_val)
    return flat, row_len


def _within(lengths: np.ndarray) -> np.ndarray:
    """arange within each run of the given lengths: [0..l0-1, 0..l1-1, ...]"""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)


def concat_rows(streams: list[tuple[np.ndarray, np.ndarray]]
                ) -> tuple[np.ndarray, np.ndarray]:
    """Row-wise concatenation of byte streams.

    Each stream is (flat uint8, per-row byte length); all streams must have
    the same row count n. Returns one (flat, per-row length) where row i is
    stream0[i] + stream1[i] + ... — the vectorized equivalent of
    ``b"".join(parts_of_row_i)`` over all rows at once.

    Index arrays are int32 whenever the output fits (STdb files < 2 GB),
    and uniform streams (constant row length — the bulk of the payload:
    coordinates, displacement histories, strain/stress records) scatter via
    a broadcasted [n, k] position block instead of per-byte repeat+arange.
    """
    n = len(streams[0][1])
    row_len = np.zeros(n, dtype=np.int64)
    for _, lens in streams:
        row_len += lens
    total = int(row_len.sum())
    idx_t = np.int32 if total < 2**31 else np.int64
    out = np.empty(total, dtype=np.uint8)
    row_starts = np.concatenate(
        ([0], np.cumsum(row_len[:-1]))).astype(idx_t, copy=False)
    intra = np.zeros(n, dtype=idx_t)
    BLOCK = 1 << 24  # cap scratch index arrays at ~16M entries
    for flat, lens in streams:
        if len(flat):
            base = row_starts + intra
            k = int(lens[0]) if n and (lens == lens[0]).all() else -1
            if k > 0:
                rows = max(1, BLOCK // k)
                fk = flat.reshape(n, k)
                ar = np.arange(k, dtype=idx_t)
                for i in range(0, n, rows):
                    pos = base[i:i + rows, None] + ar
                    out[pos] = fk[i:i + rows]
            elif k < 0:
                # Output positions of ragged bytes in ONE cumsum pass:
                # position steps are 1 within a row; at each row start add
                # the jump from the previous row's end to this row's base.
                stream_starts = np.concatenate(
                    ([0], np.cumsum(lens[:-1])))
                jumps = np.empty(n, dtype=np.int64)
                jumps[0] = int(base[0]) + 1
                jumps[1:] = (base[1:].astype(np.int64)
                             - base[:-1].astype(np.int64)
                             - lens[:-1] + 1)
                step = np.ones(len(flat), dtype=np.int64)
                valid = stream_starts < len(flat)
                np.add.at(step, stream_starts[valid], jumps[valid] - 1)
                out[np.cumsum(step).astype(idx_t, copy=False) - 1] = flat
        intra += lens.astype(idx_t, copy=False)
    return out, row_len


def length_headers(field: int, body_len: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Per-row length-delimited header ``tag + varint(len)`` as a stream."""
    assert field < 16  # single-byte tag (same guard as the other streams)
    groups, keep, ll = _varint_groups(body_len)
    n = len(ll)
    rec = np.empty((n, groups.shape[1] + 1), dtype=np.uint8)
    rec[:, 0] = tag(field, 2)
    rec[:, 1:] = groups
    mask = np.empty((n, groups.shape[1] + 1), dtype=bool)
    mask[:, 0] = True
    mask[:, 1:] = keep
    return rec[mask], ll + 1


def frame_map_entries(entry_field: int, keys: np.ndarray,
                      value_body: tuple[np.ndarray, np.ndarray],
                      value_field: int = 2) -> bytes:
    """Frame per-row bodies as protobuf map entries (C# Dictionary<int,T>):

      entry_tag LEN( key_tag varint(key)  value_tag LEN(body) )

    keys must already be in the canonical (ascending) order; value_body is
    the per-row submessage payload (flat bytes + per-row lengths).
    """
    body = value_body
    vhdr = length_headers(value_field, body[1])
    key_stream = tagged_varint_stream(1, np.asarray(keys), per_row=1)
    entry_body_len = key_stream[1] + vhdr[1] + body[1]
    ehdr = length_headers(entry_field, entry_body_len)
    out, _ = concat_rows([ehdr, key_stream, vhdr, body])
    return out.tobytes()


def length_delimited(field: int, body: bytes) -> bytes:
    return bytes([tag(field, 2)]) + varint(len(body)) + body


def scalar_varint_field(field: int, value: int) -> bytes:
    return bytes([tag(field, 0)]) + varint(value)


def scalar_double_field(field: int, value: float) -> bytes:
    return bytes([tag(field, 1)]) + np.float64(value).tobytes()


def string_field(field: int, value: str) -> bytes:
    return length_delimited(field, value.encode("utf-8"))
