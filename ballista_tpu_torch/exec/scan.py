"""Scan of an in-memory Arrow table (port of ``MemoryScanExec`` in
``ballista_tpu/exec/scan.py``).

The table is split into N partitions and each partition into batches of at
most ``ballista.tpu.batch_rows`` rows. Strings are dictionary-encoded over
the partition and INT64 narrowing is decided over the whole table, as in
the reference. File scans (Parquet, CSV, Avro) are ROADMAP queue 1, item 3.
"""

from __future__ import annotations

from typing import Iterator

import pyarrow as pa

from ballista_tpu_torch.columnar.arrow_interop import (
    narrowable_int64_cols,
    table_from_arrow,
)
from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.datatypes import Schema
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, UnknownPartitioning


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
