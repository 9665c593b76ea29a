"""Scans: an in-memory Arrow table and files (port of
``ballista_tpu/exec/scan.py``).

A memory table is split into N partitions and each partition into batches
of at most ``ballista.tpu.batch_rows`` rows. Strings are dictionary-encoded
over the partition and INT64 narrowing is decided over the whole table, as
in the reference.

File scans decode on the host with pyarrow and upload columns to the
task's device. CSV and Avro parse the file once per operator and slice it
like a memory table; Parquet reads row-group ranges per partition, prunes
row groups whose min/max statistics prove a pushed-down filter false
(``ballista.parquet.pruning``; the exact filter still runs on the device,
so pruning never changes a result) and narrows INT64 columns from the
file's statistics. A Parquet scan larger than ``ballista.tpu.scan_stream_mb``
streams in slices of row groups, each encoded with the file's whole string
dictionaries, read and uploaded on a prefetch thread
(``ballista.tpu.prefetch_depth``). A registered file table's
``scan_cache`` keeps parsed host tables and uploaded device batches (per
device) until the file's mtime changes; the streamed path caches no
device batches.
"""

from __future__ import annotations

import os
from typing import Iterator

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as papq

from ballista_tpu_torch.columnar.arrow_interop import (
    fits_int32,
    narrowable_int64_cols,
    schema_to_arrow,
    table_from_arrow,
)
from ballista_tpu_torch.columnar.batch import DeviceBatch, Dictionary
from ballista_tpu_torch.datatypes import DataType, Schema
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, UnknownPartitioning
from ballista_tpu_torch.expr import logical as L


class MemoryScanExec(ExecutionPlan):
    def __init__(
        self,
        table: pa.Table,
        out_schema: Schema,
        projection: list[str] | None = None,
        partitions: int = 1,
        batch_rows: int | None = None,
        device_cache: dict | None = None,
    ) -> None:
        """``device_cache``: a table-lifetime dict the scan parks its
        uploaded batches in, so warm queries re-serve resident device
        tensors instead of re-encoding and re-uploading the table. Batches
        are never mutated by operators, so sharing them is safe."""
        super().__init__()
        self.table = table
        self.projection = projection
        self._schema = out_schema.select(projection) if projection else out_schema
        self.partitions = max(1, partitions)
        self.batch_rows = batch_rows
        self.device_cache = device_cache
        self.narrow_cols: frozenset | None = None

    def schema(self) -> Schema:
        return self._schema

    def output_partitioning(self):
        return UnknownPartitioning(self.partitions)

    def describe(self) -> str:
        cols = self.projection if self.projection else "*"
        return f"MemoryScanExec: cols={cols}, partitions={self.partitions}"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        batch_rows = self.batch_rows or ctx.config.tpu_batch_rows()
        key = (
            tuple(self.projection or ()), self.partitions, batch_rows,
            partition, str(ctx.device),
        )
        out = None if self.device_cache is None else self.device_cache.get(key)
        if out is None:
            t = self.table
            if self.projection:
                t = t.select(self.projection)
            n = t.num_rows
            per = -(-n // self.partitions)  # ceil
            start = partition * per
            stop = min(n, start + per)
            if start >= stop:
                out = [DeviceBatch.empty(self._schema, device=ctx.device)]
            else:
                # narrowing decided over the WHOLE table so every partition
                # shares one physical layout
                if self.narrow_cols is None:
                    self.narrow_cols = narrowable_int64_cols(t)
                out = table_from_arrow(
                    t.slice(start, stop - start), batch_rows, self.narrow_cols,
                    device=ctx.device,
                )
            if self.device_cache is not None:
                self.device_cache[key] = out
        for b in out:
            # device scalar, resolved at metrics report time (no sync here)
            self.metrics.add("output_rows", b.count_valid())
            yield b


def file_mtime(path: str) -> float:
    """The file's mtime, -1 when it cannot be read: the version of a file
    table's data."""
    try:
        return os.stat(path).st_mtime
    except OSError:
        return -1.0


class _StagedFileScanExec(ExecutionPlan):
    """File scans that parse on the host and then stage like a memory
    table (CSV, Avro): read once per operator, slice per partition, one
    narrowing decision over the whole parsed table."""

    def __init__(
        self,
        path: str,
        table_schema: Schema,
        projection: list[str] | None = None,
        partitions: int = 1,
        batch_rows: int | None = None,
        scan_cache: dict | None = None,
    ) -> None:
        """``scan_cache``: a registration-lifetime dict (the context's, per
        table) holding the parsed host table and the uploaded device
        batches across queries, keyed by the file's mtime so that a
        rewritten file drops both tiers."""
        super().__init__()
        self.path = path
        self.table_schema = table_schema
        self.projection = projection
        self._schema = table_schema.select(projection) if projection else table_schema
        self.partitions = max(1, partitions)
        self.batch_rows = batch_rows
        self.scan_cache = scan_cache
        self._table: pa.Table | None = None
        self._narrow_cols: frozenset | None = None

    def schema(self) -> Schema:
        return self._schema

    def output_partitioning(self):
        return UnknownPartitioning(self.partitions)

    def _read(self) -> pa.Table:  # pragma: no cover - subclasses implement
        raise NotImplementedError

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        dev_cache = None
        if self.scan_cache is not None:
            mt = file_mtime(self.path)
            hkey = ("host", mt)
            if self._table is None:
                self._table = self.scan_cache.get(hkey)
            if self._table is None:
                # a rewritten file drops both tiers of the old mtime
                self.scan_cache.clear()
            dev_cache = self.scan_cache.setdefault(("dev", mt), {})
        with self.metrics.time("read_time"):
            t = self._read()
        if self.scan_cache is not None:
            self.scan_cache[hkey] = t
        if self._narrow_cols is None:
            # once per operator, over the whole parsed table
            self._narrow_cols = narrowable_int64_cols(t)
        mem = MemoryScanExec(
            t, self.table_schema, self.projection, self.partitions,
            self.batch_rows, device_cache=dev_cache,
        )
        mem.narrow_cols = self._narrow_cols
        yield from mem.execute(partition, ctx)


class CsvScanExec(_StagedFileScanExec):
    """CSV file scan (ref: CsvScanExecNode)."""

    def __init__(
        self,
        path: str,
        table_schema: Schema,
        has_header: bool = True,
        delimiter: str = ",",
        projection: list[str] | None = None,
        partitions: int = 1,
        batch_rows: int | None = None,
        scan_cache: dict | None = None,
    ) -> None:
        super().__init__(path, table_schema, projection, partitions, batch_rows, scan_cache)
        self.has_header = has_header
        self.delimiter = delimiter

    def describe(self) -> str:
        return f"CsvScanExec: {self.path}, partitions={self.partitions}"

    def _read(self) -> pa.Table:
        # parsed once per operator: every partition slices the same table
        if self._table is None:
            arrow_schema = schema_to_arrow(self.table_schema)
            convert = pacsv.ConvertOptions(
                column_types={f.name: f.type for f in arrow_schema}
            )
            read = pacsv.ReadOptions(
                column_names=None if self.has_header else arrow_schema.names,
            )
            parse = pacsv.ParseOptions(delimiter=self.delimiter)
            self._table = pacsv.read_csv(
                self.path, read_options=read, parse_options=parse,
                convert_options=convert,
            )
        return self._table


class AvroScanExec(_StagedFileScanExec):
    """Avro file scan, decoded on the host by ``ballista_tpu_torch.avro``."""

    def describe(self) -> str:
        return f"AvroScanExec: {self.path}, partitions={self.partitions}"

    def _read(self) -> pa.Table:
        if self._table is None:
            from ballista_tpu_torch.avro import read_avro

            self._table = read_avro(self.path)
        return self._table


def _stat_value(v, dtype: DataType):
    """A Parquet statistics min or max in the engine's literal domain
    (DATE32 as epoch days, TIMESTAMP as microseconds, strings as str)."""
    import datetime

    if v is None:
        return None
    if dtype == DataType.DATE32 and isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    if dtype == DataType.TIMESTAMP_US and isinstance(v, datetime.datetime):
        epoch = datetime.datetime(1970, 1, 1, tzinfo=v.tzinfo)
        return int((v - epoch).total_seconds() * 1_000_000)
    if isinstance(v, bytes):
        try:
            return v.decode()
        except UnicodeDecodeError:
            return None
    return v


def _cmp_may_match(op: L.Operator, mn, mx, lit) -> bool:
    """Could a value in [mn, mx] satisfy ``value <op> lit``? True when in
    doubt."""
    try:
        if op == L.Operator.EQ:
            return mn <= lit <= mx
        if op == L.Operator.NEQ:
            return not (mn == mx == lit)
        if op == L.Operator.LT:
            return mn < lit
        if op == L.Operator.LTEQ:
            return mn <= lit
        if op == L.Operator.GT:
            return mx > lit
        if op == L.Operator.GTEQ:
            return mx >= lit
    except TypeError:
        return True
    return True


_FLIPPED = {
    L.Operator.LT: L.Operator.GT,
    L.Operator.LTEQ: L.Operator.GTEQ,
    L.Operator.GT: L.Operator.LT,
    L.Operator.GTEQ: L.Operator.LTEQ,
}


def _predicate_may_match(expr, schema: Schema, col_stats: dict) -> bool:
    """Row-group pruning over min/max statistics, ``col_stats[name] =
    (mn, mx)``. False only when the predicate is false for every row of
    the group."""
    if isinstance(expr, L.BinaryExpr):
        if expr.op == L.Operator.AND:
            return _predicate_may_match(expr.left, schema, col_stats) and _predicate_may_match(
                expr.right, schema, col_stats
            )
        if expr.op == L.Operator.OR:
            return _predicate_may_match(expr.left, schema, col_stats) or _predicate_may_match(
                expr.right, schema, col_stats
            )
        if expr.op.is_comparison:
            col, lit, flip = None, None, False
            if isinstance(expr.left, L.Column) and isinstance(expr.right, L.Literal):
                col, lit = expr.left, expr.right
            elif isinstance(expr.right, L.Column) and isinstance(expr.left, L.Literal):
                col, lit, flip = expr.right, expr.left, True
            if col is None or lit.value is None:
                return True
            stats = col_stats.get(col.cname)
            if stats is None:
                return True
            mn, mx = stats
            if mn is None or mx is None:
                return True
            # lit <op> col  ==  col <flipped op> lit
            op = _FLIPPED.get(expr.op, expr.op) if flip else expr.op
            return _cmp_may_match(op, mn, mx, lit.value)
    if isinstance(expr, L.Between):
        lo_ok = _predicate_may_match(
            L.BinaryExpr(expr.expr, L.Operator.GTEQ, expr.low), schema, col_stats
        )
        hi_ok = _predicate_may_match(
            L.BinaryExpr(expr.expr, L.Operator.LTEQ, expr.high), schema, col_stats
        )
        keep = lo_ok and hi_ok
        return not keep if expr.negated else keep
    if isinstance(expr, L.InList) and not expr.negated:
        return any(
            _predicate_may_match(
                L.BinaryExpr(expr.expr, L.Operator.EQ, item), schema, col_stats
            )
            for item in expr.values
            if isinstance(item, L.Literal)
        ) or any(not isinstance(item, L.Literal) for item in expr.values)
    return True


class ParquetScanExec(ExecutionPlan):
    """Parquet scan with row-group min/max pruning (ref:
    ParquetScanExecNode). ``predicates`` are the scan's pushed-down
    filters. Partitions are ranges of the kept row groups, so they read
    disjoint byte ranges of the file."""

    # host bytes a streamed slice reads and converts at a time
    STREAM_SLICE_BYTES = 1 << 30

    def __init__(
        self,
        path: str,
        table_schema: Schema,
        projection: list[str] | None = None,
        partitions: int = 1,
        batch_rows: int | None = None,
        predicates: list | None = None,
        scan_cache: dict | None = None,
    ) -> None:
        super().__init__()
        self.path = path
        self.table_schema = table_schema
        self.projection = projection
        self._schema = table_schema.select(projection) if projection else table_schema
        self.partitions = max(1, partitions)
        self.batch_rows = batch_rows
        self.predicates = list(predicates or [])
        self.scan_cache = scan_cache
        self._kept_groups: list[int] | None = None
        self._narrow_cols: frozenset | None = None

    def schema(self) -> Schema:
        return self._schema

    def output_partitioning(self):
        return UnknownPartitioning(self.partitions)

    def describe(self) -> str:
        p = (
            f", prune_on=[{', '.join(e.name() for e in self.predicates)}]"
            if self.predicates
            else ""
        )
        return f"ParquetScanExec: {self.path}, partitions={self.partitions}{p}"

    def _pruned_groups(self, f: papq.ParquetFile, pruning: bool) -> list[int]:
        """The row groups that may hold a matching row; decided once per
        operator, at execute time (a scheduler that plans the scan reads
        nothing)."""
        if self._kept_groups is not None:
            return self._kept_groups
        ngroups = f.num_row_groups
        if not pruning or not self.predicates:
            self._kept_groups = list(range(ngroups))
            return self._kept_groups
        md = f.metadata
        name_to_idx = {md.schema.column(i).name: i for i in range(md.num_columns)}
        dtypes = {fl.name: fl.dtype for fl in self.table_schema}
        kept = []
        for g in range(ngroups):
            rg = md.row_group(g)
            col_stats = {}
            for name, ci in name_to_idx.items():
                st = rg.column(ci).statistics
                if st is None or not st.has_min_max:
                    continue
                dt = dtypes.get(name)
                if dt is None:
                    continue
                col_stats[name] = (_stat_value(st.min, dt), _stat_value(st.max, dt))
            if all(_predicate_may_match(p, self.table_schema, col_stats) for p in self.predicates):
                kept.append(g)
        self.metrics.add("row_groups_pruned", ngroups - len(kept))
        self._kept_groups = kept
        return kept

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        f = papq.ParquetFile(self.path)
        kept = self._pruned_groups(f, ctx.config.parquet_pruning())
        per = -(-len(kept) // self.partitions) if kept else 0
        groups = kept[partition * per : (partition + 1) * per]
        cols = self.projection if self.projection else None
        if self.scan_cache is not None:
            mt = file_mtime(self.path)
            if self.scan_cache.get("mtime") != mt:
                self.scan_cache.clear()  # a rewritten file: drop both tiers
                self.scan_cache["mtime"] = mt
        if not groups:
            # cached like any batch: its (empty) dictionaries keep their
            # identity across runs, so dictionary merges stay memoized
            key = ("empty", tuple(cols or ()), str(ctx.device))
            empty = None if self.scan_cache is None else self.scan_cache.get(key)
            if empty is None:
                empty = DeviceBatch.empty(self._schema, device=ctx.device)
                if self.scan_cache is not None:
                    self.scan_cache[key] = empty
            yield empty
            return
        stream_mb = ctx.config.scan_stream_mb()
        if stream_mb:
            gbytes = self._projected_group_bytes(f, groups)
            if sum(gbytes) > stream_mb << 20:
                yield from self._execute_streaming(f, groups, gbytes, ctx)
                return
        dev_cache = None
        t = None
        hkey = None
        if self.scan_cache is not None:
            sub = (tuple(groups), tuple(cols or ()))
            hkey = ("host",) + sub
            t = self.scan_cache.get(hkey)
            dev_cache = self.scan_cache.setdefault(("dev",) + sub, {})
        if t is None:
            with self.metrics.time("read_time"):
                t = f.read_row_groups(groups, columns=cols)
            # column order of the projected schema
            t = t.select([fld.name for fld in self._schema])
            if self.scan_cache is not None:
                self.scan_cache[hkey] = t
        mem = MemoryScanExec(t, self._schema, None, 1, self.batch_rows, device_cache=dev_cache)
        # narrowed by the file's statistics (every row group), not this
        # partition's: partitions share one physical layout
        mem.narrow_cols = self._narrowable_from_stats(f)
        yield from mem.execute(0, ctx)

    # -- the streamed path ---------------------------------------------------

    def _projected_group_bytes(self, f: papq.ParquetFile, groups: list[int]) -> list[int]:
        """Uncompressed bytes of each row group's projected columns: what
        the materialised path would hold."""
        md = f.metadata
        want = {fld.name for fld in self._schema}
        out = []
        for g in groups:
            rg = md.row_group(g)
            out.append(
                sum(
                    rg.column(ci).total_uncompressed_size
                    for ci in range(rg.num_columns)
                    if rg.column(ci).path_in_schema in want
                )
            )
        return out

    def _stream_dicts(self, f: papq.ParquetFile) -> dict:
        """The file's whole sorted dictionary per projected STRING column,
        so that every streamed slice encodes the same codes (cached per
        registration)."""
        import pyarrow.compute as pc

        out = {}
        for fld in self._schema:
            if fld.dtype != DataType.STRING:
                continue
            key = ("sdict", fld.name)
            d = self.scan_cache.get(key) if self.scan_cache is not None else None
            if d is None:
                vals: set = set()
                with self.metrics.time("dict_scan_time"):
                    for rb in f.iter_batches(columns=[fld.name], batch_size=1 << 20):
                        uniq = pc.unique(rb.column(0))
                        if pa.types.is_dictionary(uniq.type):
                            uniq = uniq.cast(uniq.type.value_type)
                        vals.update(v for v in uniq.to_pylist() if v is not None)
                d = Dictionary(tuple(sorted(vals)))
                if self.scan_cache is not None:
                    self.scan_cache[key] = d
            out[fld.name] = d
        return out

    def _execute_streaming(
        self, f: papq.ParquetFile, groups: list[int], gbytes: list[int], ctx: TaskContext
    ) -> Iterator[DeviceBatch]:
        from ballista_tpu_torch.exec.pipeline import prefetch_slices

        batch_rows = self.batch_rows or ctx.config.tpu_batch_rows()
        narrow = self._narrowable_from_stats(f)
        dicts = self._stream_dicts(f)
        self.metrics.add("stream_slices", 0)
        names = [fld.name for fld in self._schema]
        slices: list[list[int]] = []
        cur: list[int] = []
        cur_b = 0
        for g, gb in zip(groups, gbytes):
            cur.append(g)
            cur_b += gb
            if cur_b >= self.STREAM_SLICE_BYTES:
                slices.append(cur)
                cur, cur_b = [], 0
        if cur:
            slices.append(cur)

        def load(gs: list[int]) -> list[DeviceBatch]:
            return self._load_slice(f, gs, names, batch_rows, narrow, dicts, ctx.device)

        # the next slice is read, converted and uploaded on a host thread
        # while this one's batches compute; depth 0 reads in turn
        for batches in prefetch_slices(load, slices, ctx.config.prefetch_depth(), self.metrics):
            self.metrics.add("stream_slices")
            for b in batches:
                self.metrics.add("output_rows", b.count_valid())
                yield b

    def _load_slice(self, f, groups, names, batch_rows, narrow, dicts, device) -> list[DeviceBatch]:
        """Read, convert and upload one slice of row groups (on the
        prefetch thread when there is one)."""
        with self.metrics.time("read_time"):
            t = f.read_row_groups(groups, columns=self.projection or None)
        t = t.select(names)
        return table_from_arrow(t, batch_rows, narrow, device=device, fixed_dicts=dicts)

    def _narrowable_from_stats(self, f: papq.ParquetFile) -> frozenset:
        """INT64 columns whose min and max over every row group (from the
        column statistics) fit int32; a column without statistics stays
        wide. Decided once per operator."""
        if self._narrow_cols is None:
            self._narrow_cols = self._stats_narrowing(f)
        return self._narrow_cols

    def _stats_narrowing(self, f: papq.ParquetFile) -> frozenset:
        md = f.metadata
        name_to_dtype = {fl.name: fl.dtype for fl in self._schema}
        lo: dict[str, int] = {}
        hi: dict[str, int] = {}
        skip: set[str] = set()
        for g in range(md.num_row_groups):
            rg = md.row_group(g)
            for ci in range(rg.num_columns):
                col = rg.column(ci)
                name = col.path_in_schema
                if name_to_dtype.get(name) != DataType.INT64:
                    continue
                st = col.statistics
                if st is None or not st.has_min_max or not isinstance(st.min, int):
                    skip.add(name)
                    continue
                lo[name] = min(lo.get(name, st.min), st.min)
                hi[name] = max(hi.get(name, st.max), st.max)
        return frozenset(
            name for name in lo if name not in skip and fits_int32(lo[name], hi[name])
        )
