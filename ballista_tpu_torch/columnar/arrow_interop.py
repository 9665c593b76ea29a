"""Arrow <-> DeviceBatch conversion.

The port of ``ballista_tpu/columnar/arrow_interop.py`` with the same
encoding: strings are dictionary-encoded per conversion call over the whole
incoming table, into a lexicographically sorted dictionary, so every batch
cut from one scan shares one dictionary and int32 codes compare and sort
like the strings they encode. INT64 columns whose values fit int32 are
stored narrowed, decided once per table (``narrowable_int64_cols``).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch, Dictionary
from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.errors import SchemaError


def dtype_from_arrow(t: pa.DataType) -> DataType:
    if pa.types.is_boolean(t):
        return DataType.BOOL
    if pa.types.is_integer(t):
        return DataType.INT32 if t.bit_width <= 32 else DataType.INT64
    if pa.types.is_float32(t):
        return DataType.FLOAT32
    if pa.types.is_floating(t):
        return DataType.FLOAT64
    if pa.types.is_date32(t):
        return DataType.DATE32
    if pa.types.is_timestamp(t):
        # tz-aware timestamps are normalized to UTC instants (documented
        # deviation: the tz annotation itself is not preserved round-trip).
        return DataType.TIMESTAMP_US
    if pa.types.is_decimal(t):
        return DataType.FLOAT64  # documented deviation: decimals compute as f64
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return DataType.STRING
    if pa.types.is_dictionary(t):
        return dtype_from_arrow(t.value_type)
    if pa.types.is_null(t):
        return DataType.NULL
    raise SchemaError(f"unsupported Arrow type: {t}")


def dtype_to_arrow(t: DataType) -> pa.DataType:
    return {
        DataType.BOOL: pa.bool_(),
        DataType.INT32: pa.int32(),
        DataType.INT64: pa.int64(),
        DataType.FLOAT32: pa.float32(),
        DataType.FLOAT64: pa.float64(),
        DataType.DATE32: pa.date32(),
        DataType.TIMESTAMP_US: pa.timestamp("us"),
        DataType.STRING: pa.string(),
        DataType.NULL: pa.null(),
    }[t]


def schema_from_arrow(s: pa.Schema) -> Schema:
    return Schema(
        [Field(f.name, dtype_from_arrow(f.type), f.nullable) for f in s]
    )


def schema_to_arrow(s: Schema) -> pa.Schema:
    return pa.schema(
        [pa.field(f.name, dtype_to_arrow(f.dtype), f.nullable) for f in s]
    )


def fits_int32(mn, mx) -> bool:
    """The shared int32-narrowing range predicate (deliberately strict:
    INT32_MIN is excluded so identity sentinels stay representable)."""
    return mn is not None and -(2**31) < mn and mx < 2**31


def _column_to_np(
    col: pa.ChunkedArray | pa.Array,
    dtype: DataType,
    narrow: bool | None = None,
    fixed_dict: Dictionary | None = None,
) -> tuple[np.ndarray, np.ndarray | None, Dictionary | None]:
    """One Arrow column -> (device-repr np array, null mask or None, dict or None).

    ``fixed_dict``: encode a STRING column against this dictionary instead
    of one derived from the data, so that every chunk encoded against it
    shares codes. A value missing from it raises."""
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    null_mask = None
    if col.null_count > 0:
        null_mask = np.asarray(col.is_null())

    if dtype == DataType.NULL:
        return (
            np.zeros(len(col), dtype=bool),
            np.ones(len(col), dtype=bool),
            None,
        )

    if dtype == DataType.STRING:
        import pyarrow.compute as pc

        # Order-preserving dictionary: values sorted lexicographically, so
        # int32 codes compare/sort/min/max exactly like the strings do on
        # device (ORDER BY and range predicates need no host round-trip).
        if pa.types.is_dictionary(col.type):
            col = col.cast(col.type.value_type)
        if fixed_dict is not None:
            codes_arr = pc.index_in(col, pa.array(fixed_dict.values, type=pa.string()))
            if codes_arr.null_count > (0 if null_mask is None else int(null_mask.sum())):
                raise SchemaError(
                    "fixed dictionary is missing values present in the column"
                )
            codes = np.asarray(codes_arr.fill_null(0)).astype(np.int32)
            return codes, null_mask, fixed_dict
        uniq = pc.unique(col).drop_null()
        sorted_uniq = uniq.take(pc.array_sort_indices(uniq))
        values = tuple(sorted_uniq.to_pylist())
        codes_arr = pc.index_in(col, sorted_uniq)
        codes = np.asarray(codes_arr.fill_null(0)).astype(np.int32)
        return codes, null_mask, Dictionary(values)

    if pa.types.is_decimal(col.type) or pa.types.is_floating(col.type):
        arr = np.asarray(col.cast(pa.float64() if dtype == DataType.FLOAT64 else pa.float32()).fill_null(0))
    elif dtype == DataType.DATE32:
        arr = np.asarray(col.fill_null(0)).astype("datetime64[D]").astype(np.int32)
    elif dtype == DataType.TIMESTAMP_US:
        if getattr(col.type, "tz", None):
            col = col.cast(pa.timestamp("us", tz=col.type.tz)).cast(
                pa.timestamp("us")
            )
        arr = np.asarray(col.cast(pa.timestamp("us")).fill_null(0)).astype(np.int64)
    elif dtype == DataType.BOOL:
        arr = np.asarray(col.fill_null(False))
    else:
        try:
            arr = np.asarray(col.cast(dtype_to_arrow(dtype)).fill_null(0))
        except pa.ArrowInvalid as e:
            raise SchemaError(
                f"cannot represent column of type {col.type} as {dtype}: {e}"
            ) from e
    arr = arr.astype(dtype.to_np(), copy=False)
    if narrow is not False and dtype == DataType.INT64 and arr.size:
        # Physical narrowing: INT64 identifiers whose values fit int32
        # (all TPC-H keys up to ~SF300) sort/gather/scatter at half the
        # bytes and skip the TPU x64 u32-pair emulation. The logical type
        # stays INT64: arithmetic widens to the logical dtype before the
        # op (expr/physical._compile_binary), join packing widens to the
        # packed int64 key, and host exits cast back by schema
        # (batch_to_arrow / IPC writes). The range recheck guards a caller
        # whose table-level decision (e.g. parquet statistics) understated
        # the data; that must fail LOUDLY — a silent per-chunk fallback
        # would flip physical layouts between partitions.
        mn, mx = arr.min(), arr.max()
        if fits_int32(mn, mx):
            arr = arr.astype(np.int32)
        elif narrow is True:
            raise SchemaError(
                "column marked int32-narrowable contains values outside "
                f"int32 range [{mn}, {mx}] — table-level statistics "
                "disagree with the data"
            )
    return arr, null_mask, None


def batch_from_arrow(
    rb: pa.RecordBatch | pa.Table,
    capacity: int | None = None,
    device: torch.device | str = "cuda",
) -> DeviceBatch:
    """One Arrow batch/table -> one DeviceBatch."""
    schema = schema_from_arrow(rb.schema)
    arrays, nulls, dicts = [], [], {}
    for field, name in zip(schema, rb.schema.names):
        arr, nm, d = _column_to_np(rb.column(name), field.dtype)
        arrays.append(arr)
        nulls.append(nm)
        if d is not None:
            dicts[field.name] = d
    return DeviceBatch.from_host(
        schema, arrays, num_rows=rb.num_rows, dictionaries=dicts, nulls=nulls,
        capacity=capacity, device=device,
    )


def narrowable_int64_cols(table: pa.Table) -> frozenset:
    """Names of INT64 columns of ``table`` whose full value range fits
    int32, decided once per table so every batch cut from it makes the
    same physical-narrowing decision."""
    import pyarrow.compute as pc

    out = set()
    for field in table.schema:
        if not pa.types.is_integer(field.type) or field.type.bit_width <= 32:
            continue
        if table.num_rows == 0:
            continue
        mm = pc.min_max(table.column(field.name))
        if fits_int32(mm["min"].as_py(), mm["max"].as_py()):
            out.add(field.name)
    return frozenset(out)


def table_from_arrow(
    table: pa.Table,
    batch_rows: int,
    narrow_cols: frozenset | None = None,
    device: torch.device | str = "cuda",
    fixed_dicts: dict | None = None,
) -> list[DeviceBatch]:
    """Slice an Arrow table into DeviceBatches of <= batch_rows rows each,
    sharing one dictionary per STRING column (encoded table-wide first).
    ``narrow_cols``: INT64 columns to store as int32 (None = decide from
    this table; an empty set disables narrowing). ``fixed_dicts``: {column
    name: Dictionary} to encode STRING columns against, so that chunks of
    several tables share codes (the grace join's probe passes)."""
    schema = schema_from_arrow(table.schema)
    if narrow_cols is None:
        narrow_cols = narrowable_int64_cols(table)
    cols_np, nulls_np, dicts = [], [], {}
    for field, name in zip(schema, table.schema.names):
        arr, nm, d = _column_to_np(
            table.column(name), field.dtype, narrow=name in narrow_cols,
            fixed_dict=(fixed_dicts or {}).get(name),
        )
        cols_np.append(arr)
        nulls_np.append(nm)
        if d is not None:
            dicts[field.name] = d
    n = table.num_rows
    if n == 0:
        return [DeviceBatch.empty(schema, device=device)]
    out = []
    for start in range(0, n, batch_rows):
        stop = min(start + batch_rows, n)
        out.append(
            DeviceBatch.from_host(
                schema,
                [c[start:stop] for c in cols_np],
                num_rows=stop - start,
                dictionaries=dicts,
                nulls=[None if m is None else m[start:stop] for m in nulls_np],
                device=device,
            )
        )
    return out


def batch_to_arrow(batch: DeviceBatch) -> pa.RecordBatch:
    """Gather live rows to host and decode dictionaries back to strings."""
    schema, cols, nulls = batch.to_host()
    return arrow_from_host(schema, cols, nulls, batch.dictionaries)


def arrow_from_host(
    schema: Schema,
    cols: list[np.ndarray],
    nulls: list[np.ndarray | None],
    dictionaries: dict,
) -> pa.RecordBatch:
    """One Arrow batch from host arrays of a batch's rows (its device
    representation: dictionary codes, int32 days, int64 microseconds),
    decoding dictionaries back to strings and applying the null masks."""
    import pyarrow.compute as pc

    arrays = []
    for field, col, nm in zip(schema, cols, nulls):
        if field.dtype == DataType.NULL:
            arr = pa.nulls(len(col), type=pa.null())
        elif field.dtype == DataType.STRING:
            d = dictionaries.get(field.name)
            if d is None and len(col) == 0:
                arrays.append(pa.array([], type=pa.string()))
                continue
            if d is None:
                raise SchemaError(f"no dictionary for string column {field.name!r}")
            if len(d) == 0:
                # all rows of this column were null at encode time
                arr = pa.nulls(len(col), type=pa.string())
            else:
                values = pa.array(d.values, type=pa.string())
                codes = np.clip(col, 0, len(d) - 1).astype(np.int32)
                arr = pa.DictionaryArray.from_arrays(
                    pa.array(codes, type=pa.int32()), values
                ).cast(pa.string())
        elif field.dtype == DataType.DATE32:
            arr = pa.array(col.astype("int32"), type=pa.int32()).cast(pa.date32())
        elif field.dtype == DataType.TIMESTAMP_US:
            arr = pa.array(col.astype("int64"), type=pa.int64()).cast(
                pa.timestamp("us")
            )
        else:
            arr = pa.array(col, type=dtype_to_arrow(field.dtype))
        if nm is not None and nm.any() and field.dtype != DataType.NULL:
            arr = pc.if_else(pa.array(nm), pa.scalar(None, type=arr.type), arr)
        arrays.append(arr)
    return pa.RecordBatch.from_arrays(arrays, schema=schema_to_arrow(schema))
