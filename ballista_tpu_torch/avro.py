"""Avro object-container-file reader/writer (pure Python + pyarrow out).

The reference scans Avro via DataFusion's ListingTable AvroFormat
(ballista.proto:60-92 serializes AvroScanExecNode alongside CSV/Parquet;
client context.rs exposes ``read_avro``/``register_avro``). No Avro
library ships in this environment, so the container format (spec 1.11.1)
is implemented here directly for the subset SQL tables use:

- records of primitives: null, boolean, int, long, float, double, string,
  bytes (int/long are zigzag varints);
- nullable fields as the idiomatic 2-branch union ``["null", T]`` (either
  order);
- logical types date (int), timestamp-millis / timestamp-micros (long);
- codecs ``null`` and ``deflate`` (raw zlib, the two the spec requires).

Reading returns a ``pyarrow.Table`` so Avro sources flow through the same
scan path as CSV (read once, slice per partition, device-narrow by whole
table). The writer exists for tests and for symmetric tooling parity
(``tpch convert`` writes files in the reference harness).
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib

import pyarrow as pa

from ballista_tpu_torch.errors import SchemaError

MAGIC = b"Obj\x01"


# -- varint / zigzag ---------------------------------------------------------


def _read_long(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise SchemaError("truncated Avro varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)  # zigzag decode


def _write_long(out: io.BytesIO, v: int) -> None:
    v = (v << 1) ^ (v >> 63)  # zigzag encode (Python ints: arithmetic shift)
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            break


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise SchemaError("truncated Avro bytes")
    return data


def _read_exact(buf: io.BytesIO, n: int, what: str) -> bytes:
    data = buf.read(n)
    if len(data) != n:
        raise SchemaError(f"truncated Avro {what}")
    return data


# -- schema ------------------------------------------------------------------


class _FieldDec:
    """One record field: a decode plan (type tag + nullability)."""

    def __init__(self, name: str, typ, logical: str | None):
        self.name = name
        self.nullable = False
        self.null_first = True
        if isinstance(typ, list):
            branches = [t for t in typ if t != "null"]
            if len(branches) != 1 or "null" not in typ:
                raise SchemaError(
                    f"unsupported Avro union for field {name!r}: {typ}"
                )
            self.nullable = True
            self.null_first = typ[0] == "null"
            typ = branches[0]
        if isinstance(typ, dict):
            logical = typ.get("logicalType", logical)
            typ = typ["type"]
        if typ not in (
            "boolean", "int", "long", "float", "double", "string", "bytes"
        ):
            raise SchemaError(f"unsupported Avro type for field {name!r}: {typ}")
        self.typ = typ
        self.logical = logical

    def arrow_type(self) -> pa.DataType:
        if self.logical == "date" and self.typ == "int":
            return pa.date32()
        if self.logical == "timestamp-millis" and self.typ == "long":
            return pa.timestamp("ms")
        if self.logical == "timestamp-micros" and self.typ == "long":
            return pa.timestamp("us")
        return {
            "boolean": pa.bool_(),
            "int": pa.int32(),
            "long": pa.int64(),
            "float": pa.float32(),
            "double": pa.float64(),
            "string": pa.string(),
            "bytes": pa.binary(),
        }[self.typ]

    def decode(self, buf: io.BytesIO):
        if self.nullable:
            branch = _read_long(buf)
            is_null = (branch == 0) == self.null_first
            if is_null:
                return None
        t = self.typ
        if t in ("int", "long"):
            return _read_long(buf)
        if t == "boolean":
            return _read_exact(buf, 1, "boolean") == b"\x01"
        if t == "float":
            return struct.unpack("<f", _read_exact(buf, 4, "float"))[0]
        if t == "double":
            return struct.unpack("<d", _read_exact(buf, 8, "double"))[0]
        if t == "string":
            return _read_bytes(buf).decode("utf-8")
        return _read_bytes(buf)  # bytes


def _parse_schema(schema_json: str) -> list[_FieldDec]:
    schema = json.loads(schema_json)
    if schema.get("type") != "record":
        raise SchemaError(
            f"Avro root schema must be a record, got {schema.get('type')!r}"
        )
    return [
        _FieldDec(f["name"], f["type"], None) for f in schema["fields"]
    ]


# -- reading -----------------------------------------------------------------


def _read_header(buf: io.BytesIO, path: str) -> dict[str, bytes]:
    if buf.read(4) != MAGIC:
        raise SchemaError(f"{path}: not an Avro object container file")
    meta: dict[str, bytes] = {}
    while True:
        n = _read_long(buf)
        if n == 0:
            break
        if n < 0:  # negative block count form: abs count then byte size
            n = -n
            _read_long(buf)
        for _ in range(n):
            key = _read_bytes(buf).decode("utf-8")
            meta[key] = _read_bytes(buf)
    return meta


def read_avro_schema(path: str) -> pa.Schema:
    """Arrow schema of an Avro file from the header alone — no data blocks
    are decoded (registration parity with papq.read_schema)."""
    size = 64 * 1024  # header = magic + metadata map, usually small
    while True:
        with open(path, "rb") as f:
            head = f.read(size)
        try:
            meta = _read_header(io.BytesIO(head), path)
            break
        except SchemaError:
            # a very wide schema / extra metadata can exceed the buffer;
            # retry doubled until the whole file has been read once
            if len(head) < size:
                raise
            size *= 2
    fields = _parse_schema(meta["avro.schema"].decode("utf-8"))
    return pa.schema(
        [pa.field(fd.name, fd.arrow_type(), fd.nullable) for fd in fields]
    )


def read_avro(path: str) -> pa.Table:
    """Read an Avro object container file into a pyarrow Table."""
    with open(path, "rb") as f:
        raw = f.read()
    buf = io.BytesIO(raw)
    meta = _read_header(buf, path)
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise SchemaError(f"unsupported Avro codec {codec!r}")
    fields = _parse_schema(meta["avro.schema"].decode("utf-8"))
    sync = buf.read(16)

    columns: list[list] = [[] for _ in fields]
    while True:
        head = buf.read(1)
        if not head:
            break
        buf.seek(-1, os.SEEK_CUR)
        count = _read_long(buf)
        size = _read_long(buf)
        block = buf.read(size)
        if len(block) != size:
            raise SchemaError(f"{path}: truncated Avro block")
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        bb = io.BytesIO(block)
        for _ in range(count):
            for fd, col in zip(fields, columns):
                col.append(fd.decode(bb))
        if buf.read(16) != sync:
            raise SchemaError(f"{path}: Avro sync marker mismatch")

    arrays = []
    for fd, col in zip(fields, columns):
        t = fd.arrow_type()
        if pa.types.is_date32(t):
            arrays.append(pa.array(col, type=pa.int32()).cast(t))
        elif pa.types.is_timestamp(t):
            arrays.append(pa.array(col, type=pa.int64()).cast(t))
        else:
            arrays.append(pa.array(col, type=t))
    return pa.Table.from_arrays(
        arrays,
        schema=pa.schema(
            [
                pa.field(fd.name, arr.type, fd.nullable)
                for fd, arr in zip(fields, arrays)
            ]
        ),
    )


# -- writing (tests / convert tooling) ---------------------------------------

_AVRO_OF_ARROW = [
    (pa.types.is_boolean, "boolean", None),
    (pa.types.is_date32, "int", "date"),
    # Avro int/long are SIGNED: unsigned widths map to the next signed
    # type that holds their full range (uint32 -> long); uint64 has no
    # lossless Avro integer type and is rejected below.
    (lambda t: pa.types.is_signed_integer(t) and t.bit_width <= 32,
     "int", None),
    (lambda t: pa.types.is_unsigned_integer(t) and t.bit_width <= 16,
     "int", None),
    (lambda t: pa.types.is_timestamp(t) and t.unit == "us",
     "long", "timestamp-micros"),
    (lambda t: pa.types.is_timestamp(t) and t.unit == "ms",
     "long", "timestamp-millis"),
    (pa.types.is_signed_integer, "long", None),
    (lambda t: pa.types.is_unsigned_integer(t) and t.bit_width <= 32,
     "long", None),
    (pa.types.is_float32, "float", None),
    (pa.types.is_floating, "double", None),
    (pa.types.is_string, "string", None),
    (pa.types.is_binary, "bytes", None),
]


def _avro_field_schema(field: pa.Field) -> dict:
    for pred, typ, logical in _AVRO_OF_ARROW:
        if pred(field.type):
            t: object = (
                {"type": typ, "logicalType": logical} if logical else typ
            )
            if field.nullable:
                t = ["null", t]
            return {"name": field.name, "type": t}
    raise SchemaError(f"cannot write Arrow type {field.type} as Avro")


def _encode_value(out: io.BytesIO, typ: str, v) -> None:
    if typ in ("int", "long"):
        _write_long(out, int(v))
    elif typ == "boolean":
        out.write(b"\x01" if v else b"\x00")
    elif typ == "float":
        out.write(struct.pack("<f", v))
    elif typ == "double":
        out.write(struct.pack("<d", float(v)))
    elif typ == "string":
        enc = v.encode("utf-8")
        _write_long(out, len(enc))
        out.write(enc)
    else:  # bytes
        _write_long(out, len(v))
        out.write(v)


def write_avro(
    path: str, table: pa.Table, codec: str = "deflate",
    block_rows: int = 64 * 1024,
) -> None:
    """Write a pyarrow Table as an Avro object container file."""
    if codec not in ("null", "deflate"):
        raise SchemaError(f"unsupported Avro codec {codec!r}")
    schemas = [_avro_field_schema(f) for f in table.schema]
    root = {"type": "record", "name": "row", "fields": schemas}
    plain = []
    for f, s in zip(table.schema, schemas):
        t = s["type"]
        if isinstance(t, list):
            t = t[1]
        if isinstance(t, dict):
            t = t["type"]
        plain.append((t, f.nullable, f.type))
    sync = os.urandom(16)
    with open(path, "wb") as f:
        f.write(MAGIC)
        out = io.BytesIO()
        _write_long(out, 2)
        for k, v in (
            ("avro.schema", json.dumps(root).encode()),
            ("avro.codec", codec.encode()),
        ):
            ke = k.encode()
            _write_long(out, len(ke))
            out.write(ke)
            _write_long(out, len(v))
            out.write(v)
        _write_long(out, 0)
        f.write(out.getvalue())
        f.write(sync)
        for start in range(0, table.num_rows, block_rows):
            chunk = table.slice(start, block_rows)
            cols = []
            for (typ, nullable, at), name in zip(
                plain, table.schema.names
            ):
                col = chunk.column(name)
                if pa.types.is_date32(at):
                    col = col.cast(pa.int32())
                elif pa.types.is_timestamp(at):
                    col = col.cast(pa.int64())
                cols.append(col.to_pylist())
            body = io.BytesIO()
            for row in zip(*cols) if cols else []:
                for (typ, nullable, _), v in zip(plain, row):
                    if nullable:
                        _write_long(body, 0 if v is None else 1)
                        if v is None:
                            continue
                    _encode_value(body, typ, v)
            data = body.getvalue()
            if codec == "deflate":
                co = zlib.compressobj(wbits=-15)
                data = co.compress(data) + co.flush()
            blk = io.BytesIO()
            _write_long(blk, chunk.num_rows)
            _write_long(blk, len(data))
            f.write(blk.getvalue())
            f.write(data)
            f.write(sync)
