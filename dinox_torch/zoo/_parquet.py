"""A Parquet reader and writer for the slice manifest (numpy + stdlib).

The reader takes what pyarrow writes by default for the manifest's schema:
optional top-level INT64, DOUBLE and BYTE_ARRAY (UTF-8) columns and
3-level lists of strings (``optional group (List) { repeated group list {
optional binary element } }``); data page v1, uncompressed or snappy
(decoded here in Python), dictionary pages with RLE_DICTIONARY indices and
the PLAIN pages pyarrow falls back to once a dictionary grows past its
limit, definition and repetition levels in the RLE/bit-packed hybrid, any
number of pages and row groups. Data page v2, other codecs and other
encodings raise ``ValueError``.

The writer writes such a schema with PLAIN values, uncompressed, in one row
group of one data page per column; pyarrow reads it back.

Both speak the Thrift compact protocol for the footer and page headers.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Iterable

import numpy as np

MAGIC = b"PAR1"

# parquet.thrift enums
INT64, DOUBLE, BYTE_ARRAY = 2, 5, 6
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
UTF8, LIST = 0, 3  # ConvertedType
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
UNCOMPRESSED, SNAPPY = 0, 1
DATA_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 2, 3
_CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI", 5: "LZ4", 6: "ZSTD",
           7: "LZ4_RAW"}

# Thrift compact protocol element types
_T_TRUE, _T_FALSE, _T_BYTE, _T_I16, _T_I32, _T_I64, _T_DOUBLE, _T_BINARY = 1, 2, 3, 4, 5, 6, 7, 8
_T_LIST, _T_SET, _T_MAP, _T_STRUCT = 9, 10, 11, 12


# -- Thrift compact protocol --------------------------------------------------


class _ThriftReader:
    """Decodes compact-protocol structs into {field id: value} dicts (lists
    as lists, binaries as bytes)."""

    def __init__(self, buf: bytes, pos: int = 0) -> None:
        self.buf, self.pos = buf, pos

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def value(self, t: int) -> Any:
        if t in (_T_TRUE, _T_FALSE):  # a bool as a list element: one byte
            b = self.buf[self.pos]
            self.pos += 1
            return b == _T_TRUE
        if t == _T_BYTE:
            b = self.buf[self.pos]
            self.pos += 1
            return b - 256 if b > 127 else b
        if t in (_T_I16, _T_I32, _T_I64):
            return self.zigzag()
        if t == _T_DOUBLE:
            (v,) = struct.unpack_from("<d", self.buf, self.pos)
            self.pos += 8
            return v
        if t == _T_BINARY:
            n = self.varint()
            v = bytes(self.buf[self.pos:self.pos + n])
            self.pos += n
            return v
        if t in (_T_LIST, _T_SET):
            head = self.buf[self.pos]
            self.pos += 1
            size, et = head >> 4, head & 0x0F
            if size == 15:
                size = self.varint()
            return [self.value(et) for _ in range(size)]
        if t == _T_MAP:
            size = self.varint()
            if not size:
                return {}
            kv = self.buf[self.pos]
            self.pos += 1
            return {self.value(kv >> 4): self.value(kv & 0x0F) for _ in range(size)}
        if t == _T_STRUCT:
            return self.struct()
        raise ValueError(f"Parquet footer: unknown Thrift type {t}")

    def struct(self) -> dict[int, Any]:
        out: dict[int, Any] = {}
        fid = 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == 0:
                return out
            t, delta = head & 0x0F, head >> 4
            fid = fid + delta if delta else self.zigzag()
            out[fid] = (t == _T_TRUE) if t in (_T_TRUE, _T_FALSE) else self.value(t)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(n: int) -> bytes:
    return _varint((n << 1) ^ (n >> 63))


class _I64(int):
    pass


def _type_of(v: Any) -> int:
    if isinstance(v, bool):
        return _T_TRUE if v else _T_FALSE
    if isinstance(v, _I64):
        return _T_I64
    if isinstance(v, int):
        return _T_I32
    if isinstance(v, (bytes, str)):
        return _T_BINARY
    if isinstance(v, list):
        return _T_LIST
    if isinstance(v, dict):
        return _T_STRUCT
    raise TypeError(f"no Thrift type for {v!r}")


def _encode_value(v: Any) -> bytes:
    if isinstance(v, int) and not isinstance(v, bool):
        return _zigzag(v)
    if isinstance(v, (bytes, str)):
        b = v.encode() if isinstance(v, str) else v
        return _varint(len(b)) + b
    if isinstance(v, list):
        et = _type_of(v[0]) if v else _T_STRUCT
        head = bytes([(len(v) << 4) | et]) if len(v) < 15 else bytes([0xF0 | et]) + _varint(len(v))
        return head + b"".join(_encode_value(x) for x in v)
    if isinstance(v, dict):
        return _encode_struct(v)
    raise TypeError(f"cannot encode {v!r}")


def _encode_struct(fields: dict[int, Any]) -> bytes:
    """{field id: value} -> compact-protocol bytes; ints are i32 unless
    wrapped in _I64, None fields are left out."""
    out = bytearray()
    last = 0
    for fid in sorted(fields):
        v = fields[fid]
        if v is None:
            continue
        t = _type_of(v)
        delta = fid - last
        out += bytes([(delta << 4) | t]) if 0 < delta <= 15 else bytes([t]) + _zigzag(fid)
        if t not in (_T_TRUE, _T_FALSE):
            out += _encode_value(v)
        last = fid
    out.append(0)
    return bytes(out)


# -- snappy (raw block format) --------------------------------------------------


def snappy_decompress(buf: bytes) -> bytes:
    """Decode one raw snappy block; copies may overlap their own output."""
    r = _ThriftReader(buf)
    n = r.varint()
    pos, end = r.pos, len(buf)
    out = bytearray()
    while pos < end:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                length = int.from_bytes(buf[pos:pos + extra], "little")
                pos += extra
            length += 1
            out += buf[pos:pos + length]
            pos += length
            continue
        if kind == 1:
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:
            length = 1 + (tag >> 2)
            offset = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:
            length = 1 + (tag >> 2)
            offset = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("snappy: copy offset outside the output")
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:  # the copy overlaps what it writes: repeat the last `offset` bytes
            chunk = bytes(out[start:])
            out += (chunk * (length // offset + 1))[:length]
    if len(out) != n:
        raise ValueError(f"snappy: decoded {len(out)} bytes, the header says {n}")
    return bytes(out)


# -- the RLE / bit-packed hybrid --------------------------------------------------


def _unpack_bits(data: bytes, width: int, count: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")[:count * width]
    return (bits.reshape(count, width).astype(np.int64) << np.arange(width)).sum(axis=1)


def decode_hybrid(buf: bytes, pos: int, end: int, width: int, count: int) -> np.ndarray:
    """*count* values of *width* bits from the hybrid runs in buf[pos:end]."""
    out = np.zeros(count, np.int64)
    got = 0
    r = _ThriftReader(buf, pos)
    nbytes = (width + 7) // 8
    while got < count:
        if r.pos >= end:
            raise ValueError("Parquet: RLE/bit-packed data ended early")
        head = r.varint()
        if head & 1:  # bit-packed: (head >> 1) groups of 8 values
            n = (head >> 1) * 8
            size = (head >> 1) * width
            vals = _unpack_bits(buf[r.pos:r.pos + size], width, n) if width else np.zeros(n, np.int64)
            r.pos += size
        else:  # a run of one value
            n = head >> 1
            v = int.from_bytes(buf[r.pos:r.pos + nbytes], "little")
            r.pos += nbytes
            vals = np.full(n, v, np.int64)
        take = min(n, count - got)
        out[got:got + take] = vals[:take]
        got += take
    return out


def encode_hybrid(values: np.ndarray, width: int) -> bytes:
    """*values* as one bit-packed run (zero-padded to a multiple of 8)."""
    groups = -(-len(values) // 8)
    padded = np.zeros(groups * 8, np.int64)
    padded[:len(values)] = values
    bits = ((padded[:, None] >> np.arange(width)) & 1).astype(np.uint8).reshape(-1)
    return _varint((groups << 1) | 1) + np.packbits(bits, bitorder="little").tobytes()


# -- PLAIN values ---------------------------------------------------------------------


def _plain_decode(buf: bytes, pos: int, ptype: int, count: int) -> list:
    if ptype == INT64:
        return np.frombuffer(buf, "<i8", count, pos).tolist()
    if ptype == DOUBLE:
        return np.frombuffer(buf, "<f8", count, pos).tolist()
    if ptype == BYTE_ARRAY:
        out = []
        for _ in range(count):
            (n,) = struct.unpack_from("<I", buf, pos)
            out.append(buf[pos + 4:pos + 4 + n].decode())
            pos += 4 + n
        return out
    raise ValueError(f"Parquet: physical type {ptype} is not supported")


def _plain_encode(values: list, ptype: int) -> bytes:
    if ptype == INT64:
        return np.asarray(values, "<i8").tobytes()
    if ptype == DOUBLE:
        return np.asarray(values, "<f8").tobytes()
    parts = []
    for v in values:
        b = v.encode()
        parts.append(struct.pack("<I", len(b)))
        parts.append(b)
    return b"".join(parts)


# -- reading ---------------------------------------------------------------------------


def _column_values(buf: bytes, meta: dict, max_def: int, max_rep: int, ptype: int
                   ) -> tuple[np.ndarray, np.ndarray, list]:
    """(definition levels, repetition levels, the non-null values) of one
    column chunk, page by page."""
    codec = meta[4]
    if codec not in (UNCOMPRESSED, SNAPPY):
        raise ValueError(f"Parquet: codec {_CODECS.get(codec, codec)} is not supported "
                         f"(only UNCOMPRESSED and SNAPPY)")
    total = meta[5]
    pos = meta.get(11) or meta[9]  # the dictionary page's offset, else the first data page's
    dictionary: list | None = None
    defs, reps, values = [], [], []
    seen = 0
    while seen < total:
        r = _ThriftReader(buf, pos)
        head, pos = r.struct(), r.pos
        ptype_page, size = head[1], head[3]
        raw = buf[pos:pos + size]
        pos += size
        if ptype_page == DATA_PAGE_V2:
            raise ValueError("Parquet: data page v2 is not supported (write with data_page_version='1.0')")
        page = snappy_decompress(raw) if codec == SNAPPY else raw
        if len(page) != head[2]:
            raise ValueError("Parquet: page size does not match its header")
        if ptype_page == DICTIONARY_PAGE:
            dh = head[7]
            if dh[2] not in (PLAIN, PLAIN_DICTIONARY):
                raise ValueError(f"Parquet: dictionary encoding {dh[2]} is not supported")
            dictionary = _plain_decode(page, 0, ptype, dh[1])
            continue
        if ptype_page != DATA_PAGE:
            raise ValueError(f"Parquet: page type {ptype_page} is not supported")
        dh = head[5]
        n, enc = dh[1], dh[2]
        p = 0
        rep = np.zeros(n, np.int64)
        if max_rep:
            (ln,) = struct.unpack_from("<I", page, p)
            rep = decode_hybrid(page, p + 4, p + 4 + ln, max_rep.bit_length(), n)
            p += 4 + ln
        dfn = np.full(n, max_def, np.int64)
        if max_def:
            if dh[3] != RLE:
                raise ValueError(f"Parquet: definition level encoding {dh[3]} is not supported")
            (ln,) = struct.unpack_from("<I", page, p)
            dfn = decode_hybrid(page, p + 4, p + 4 + ln, max_def.bit_length(), n)
            p += 4 + ln
        present = int((dfn == max_def).sum())
        if enc == PLAIN:
            values += _plain_decode(page, p, ptype, present)
        elif enc in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            if dictionary is None:
                raise ValueError("Parquet: dictionary-encoded page without a dictionary page")
            width = page[p]
            idx = decode_hybrid(page, p + 1, len(page), width, present) if present else []
            values += [dictionary[i] for i in idx]
        else:
            raise ValueError(f"Parquet: value encoding {enc} is not supported")
        defs.append(dfn)
        reps.append(rep)
        seen += n
    return (np.concatenate(defs) if defs else np.zeros(0, np.int64),
            np.concatenate(reps) if reps else np.zeros(0, np.int64), values)


def _schema_columns(schema: list[dict]) -> list[tuple[str, int | None, int, int, int]]:
    """(top-level name, the definition level of an empty list (None for a
    flat column), max def level, max rep level, physical type) of each leaf
    column, for flat columns and 3-level lists."""
    out = []
    i = 1
    while i < len(schema):
        el = schema[i]
        name = el[4].decode()
        rep = el.get(3, REQUIRED)
        d = 1 if rep == OPTIONAL else 0
        if not el.get(5):  # a primitive column
            if rep == REPEATED:
                raise ValueError(f"Parquet: repeated column {name} is not supported")
            out.append((name, None, d, 0, el[1]))
            i += 1
            continue
        mid = schema[i + 1] if i + 1 < len(schema) else {}
        leaf = schema[i + 2] if i + 2 < len(schema) else {}
        if (el.get(5) != 1 or mid.get(3) != REPEATED or mid.get(5) != 1 or leaf.get(5)
                or leaf.get(3) == REPEATED):
            raise ValueError(f"Parquet: column {name} is not a 3-level list of primitives")
        out.append((name, d, d + 1 + (1 if leaf.get(3) == OPTIONAL else 0), 1, leaf[1]))
        i += 3
    return out


def _assemble(list_def: int | None, max_def: int, dfn: np.ndarray, rep: np.ndarray, values: list
              ) -> list:
    """Rebuild one column's rows from its levels."""
    if list_def is None:
        if max_def == 0:
            return values
        it = iter(values)
        return [next(it) if d == max_def else None for d in dfn.tolist()]
    rows: list = []
    it = iter(values)
    for d, r in zip(dfn.tolist(), rep.tolist()):
        if r == 0:
            if d < list_def:
                rows.append(None)
                continue
            rows.append([])
            if d == list_def:
                continue
        rows[-1].append(next(it) if d == max_def else None)
    return rows


def read_table(path: str | Path) -> tuple[list[str], list[dict[str, Any]]]:
    """(column names, rows as dicts) of a Parquet file."""
    buf = Path(path).read_bytes()
    if len(buf) < 12 or buf[:4] != MAGIC or buf[-4:] != MAGIC:
        raise ValueError(f"{path}: not a Parquet file")
    (footer_len,) = struct.unpack_from("<I", buf, len(buf) - 8)
    meta = _ThriftReader(buf, len(buf) - 8 - footer_len).struct()
    cols = _schema_columns(meta[2])
    names = [c[0] for c in cols]
    data: dict[str, list] = {n: [] for n in names}
    for rg in meta.get(4, []):
        chunks = rg[1]
        if len(chunks) != len(cols):
            raise ValueError(f"{path}: a row group has {len(chunks)} columns, the schema {len(cols)}")
        for (name, list_def, max_def, max_rep, ptype), chunk in zip(cols, chunks):
            if chunk.get(1):
                raise ValueError(f"{path}: column chunks in other files are not supported")
            dfn, rep, values = _column_values(buf, chunk[3], max_def, max_rep, ptype)
            data[name] += _assemble(list_def, max_def, dfn, rep, values)
    n = meta[3]
    if any(len(v) != n for v in data.values()):
        raise ValueError(f"{path}: column lengths disagree with num_rows {n}")
    return names, [dict(zip(names, row)) for row in zip(*(data[k] for k in names))]


# -- writing ---------------------------------------------------------------------------


def _schema_elements(schema: list[tuple[str, str]]) -> list[dict]:
    els: list[dict] = [{4: "schema", 5: len(schema)}]
    for name, kind in schema:
        if kind == "list<string>":
            els += [{3: OPTIONAL, 4: name, 5: 1, 6: LIST, 10: {3: {}}},
                    {3: REPEATED, 4: "list", 5: 1},
                    {1: BYTE_ARRAY, 3: OPTIONAL, 4: "element", 6: UTF8, 10: {1: {}}}]
        elif kind == "string":
            els.append({1: BYTE_ARRAY, 3: OPTIONAL, 4: name, 6: UTF8, 10: {1: {}}})
        elif kind == "int64":
            els.append({1: INT64, 3: OPTIONAL, 4: name})
        elif kind == "double":
            els.append({1: DOUBLE, 3: OPTIONAL, 4: name})
        else:
            raise ValueError(f"Parquet writer: column type {kind} is not supported")
    return els


def _column_page(kind: str, column: list) -> tuple[bytes, int, int]:
    """(page bytes, num level entries, physical type) of one column: levels
    in one bit-packed run each, values PLAIN."""
    if kind == "list<string>":
        defs, reps, values = [], [], []
        for row in column:
            if row is None:
                defs.append(0)
                reps.append(0)
                continue
            if not row:
                defs.append(1)
                reps.append(0)
                continue
            for j, v in enumerate(row):
                defs.append(3 if v is not None else 2)
                reps.append(1 if j else 0)
                if v is not None:
                    values.append(v)
        rep_b = encode_hybrid(np.asarray(reps, np.int64), 1)
        def_b = encode_hybrid(np.asarray(defs, np.int64), 2)
        body = (struct.pack("<I", len(rep_b)) + rep_b + struct.pack("<I", len(def_b)) + def_b
                + _plain_encode(values, BYTE_ARRAY))
        return body, len(defs), BYTE_ARRAY
    ptype = {"string": BYTE_ARRAY, "int64": INT64, "double": DOUBLE}[kind]
    defs = np.asarray([v is not None for v in column], np.int64)
    def_b = encode_hybrid(defs, 1)
    body = struct.pack("<I", len(def_b)) + def_b + _plain_encode([v for v in column if v is not None],
                                                                   ptype)
    return body, len(column), ptype


def write_table(path: str | Path, schema: list[tuple[str, str]], rows: Iterable[dict[str, Any]],
                created_by: str = "dinox_torch") -> None:
    """Write *rows* (dicts keyed by the column names of *schema*, a list of
    (name, "string" | "int64" | "double" | "list<string>")) as one
    uncompressed row group of PLAIN pages."""
    rows = list(rows)
    out = bytearray(MAGIC)
    chunks = []
    for name, kind in schema if rows else []:
        body, n, ptype = _column_page(kind, [r[name] for r in rows])
        header = _encode_struct({1: DATA_PAGE, 2: len(body), 3: len(body),
                                 5: {1: n, 2: PLAIN, 3: RLE, 4: RLE}})
        offset = len(out)
        out += header + body
        size = len(header) + len(body)
        path_in_schema = [name, "list", "element"] if kind == "list<string>" else [name]
        chunks.append({2: _I64(offset), 3: {
            1: ptype, 2: [PLAIN, RLE], 3: path_in_schema, 4: UNCOMPRESSED, 5: _I64(n),
            6: _I64(size), 7: _I64(size), 9: _I64(offset)}})
    row_groups = []
    if rows:
        total = sum(c[3][6] for c in chunks)
        row_groups.append({1: chunks, 2: _I64(total), 3: _I64(len(rows)), 5: _I64(4),
                           6: _I64(total)})
    footer = _encode_struct({1: 1, 2: _schema_elements(schema), 3: _I64(len(rows)), 4: row_groups,
                             6: created_by})
    out += footer + struct.pack("<I", len(footer)) + MAGIC
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(bytes(out))
