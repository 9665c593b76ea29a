"""ShuffleWriterExec: the stage-root operator that writes a stage's output
as shuffle files (port of ``ballista_tpu/executor/shuffle.py``).

For each input partition it runs the child fragment, routes each batch's
rows to output partitions, and appends them to one Arrow IPC file per
output partition, the reference's layout:

    <work_dir>/<job_id>/<stage_id>/<output_partition>/data-<input_partition>.arrow

With no partition keys (or one output partition) a batch's live rows go
to partition 0 as they are. A hash-partitioned batch is grouped by output
partition on its device: the partition-hash kernel's grouped mode
(``ops/partition.batch_partition_groups``) for K <= 1024, else its ids
mode and a stable ``torch.argsort`` (``group_by_id``); ``group_rows``
picks the route from K before any launch. The grouped rows come to the
host with one copy and one wait, one Arrow batch is built from them, and
each output partition's file gets a zero-copy slice
(``exec/spill.grouped_arrow``, which the grace-hash spill shares). The
files hold the reference's rows in the reference's order (its numpy stable
argsort and Arrow ``take``) and its Arrow schema.

As in the reference, slices are coalesced up to
``ballista.tpu.shuffle_target_batch_mb`` before they are written, and the
file codec is ``ballista.tpu.shuffle_compression`` ("auto" writes
uncompressed files).

Push shuffle (``ballista.tpu.push_shuffle``, with eager shuffle, on a
scheduler-connected executor): each output partition is committed into the
process's push registry (``executor/push.py``) instead of a file, and
consumers stream it from there or over Flight ``do_exchange``. A batch
enters the registry in memory of its own: the slices of a grouped batch
alias that batch's pinned host buffer, which a stream would otherwise keep
whole until its consumer came, past what the window
(``ballista.tpu.push_shuffle_window_mb``) counts.

A failed attempt leaves no file: the task's deferred device checks are
raised before its files are sealed, and on any failure every file of the
attempt is deleted (the reference closes them and leaves them to its TTL
sweep). A retried attempt writes the same paths.
"""

from __future__ import annotations

import os
import time
from typing import Iterator

import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc

from ballista_tpu_torch.columnar.arrow_interop import batch_to_arrow
from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.columnar.coalesce import BatchCoalescer
from ballista_tpu_torch.datatypes import Schema
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.exec.base import (
    ExecutionPlan,
    HashPartitioning,
    TaskContext,
    UnknownPartitioning,
)
from ballista_tpu_torch.exec.spill import HostStaging, add_stats, grouped_arrow, new_write_stats
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.ops.partition import (
    MAX_GROUPS,
    batch_partition_groups,
    group_by_id,
    partition_ids,
    string_key_tables,
)
from ballista_tpu_torch.scheduler_types import ShuffleWritePartitionMeta

# What the shuffle writes cost, summed over the process (reset with
# ``exec/spill.reset_stats(stats)``, updated with ``exec/spill.add_stats``):
# the fields of
# ``exec/spill.new_write_stats``, for hash-partitioned batches, plus the
# host seconds of the unpartitioned batches' copies and Arrow builds
# (``arrow_s``) and of every IPC write (``ipc_s``).
stats = new_write_stats()


def resolve_file_codec(codec: str) -> str:
    """The codec shuffle FILES are written with. ``auto`` resolves to
    ``none``: the wire codec is negotiated per (producer, consumer) link
    at fetch time, so compressing the bytes at rest would only tax
    colocated readers."""
    return "none" if codec == "auto" else codec


def group_rows(batch: DeviceBatch, key_idxs: list[int], num_partitions: int):
    """``(order, offsets)`` of a batch's rows grouped by output partition
    (the routing of ``ops/partition.partition_ids``): the kernel's grouped
    mode up to ``MAX_GROUPS`` partitions, else the ids mode and a stable
    argsort. The route follows from K alone."""
    tables = string_key_tables(batch, key_idxs)
    if num_partitions <= MAX_GROUPS:
        _, order, offsets = batch_partition_groups(batch, key_idxs, num_partitions, tables)
        return order, offsets
    return group_rows_by_ids(batch, key_idxs, num_partitions, tables)


def group_rows_by_ids(batch: DeviceBatch, key_idxs: list[int], num_partitions: int, tables=None):
    """The route of ``group_rows`` above ``MAX_GROUPS`` partitions, at any
    K: partition ids, then a stable ``torch.argsort`` and a bincount."""
    return group_by_id(partition_ids(batch, key_idxs, num_partitions, tables), num_partitions)


class ShuffleWriterExec(ExecutionPlan):
    def __init__(
        self,
        job_id: str,
        stage_id: int,
        input: ExecutionPlan,
        partition_keys: list[L.Expr],
        output_partitions: int,
    ) -> None:
        super().__init__()
        self.job_id = job_id
        self.stage_id = stage_id
        self.input = input
        self.partition_keys = list(partition_keys)
        self.output_partitions = max(1, output_partitions)

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def output_partitioning(self):
        if self.partition_keys:
            return HashPartitioning(tuple(self.partition_keys), self.output_partitions)
        return UnknownPartitioning(self.output_partitions)

    def describe(self) -> str:
        keys = [k.name() for k in self.partition_keys]
        return (
            f"ShuffleWriterExec: job={self.job_id}, stage={self.stage_id}, "
            f"keys={keys}, out={self.output_partitions}"
        )

    def _push_eligible(self, ctx: TaskContext) -> bool:
        """The reference pushes when the session asks for push and eager
        shuffle, the executor is scheduler-connected and the window is
        positive; anywhere else it writes files."""
        cfg = ctx.config
        return bool(
            cfg.push_shuffle()
            and cfg.eager_shuffle()
            and ctx.work_dir
            and ctx.shuffle_locations is not None
            and cfg.push_shuffle_window_mb() > 0
        )

    # -- the task entry point (ref shuffle_writer.rs:142-292) ----------------
    def execute_shuffle_write(
        self, input_partition: int, ctx: TaskContext
    ) -> list[ShuffleWritePartitionMeta]:
        if not ctx.work_dir:
            raise ExecutionError("shuffle write requires ctx.work_dir")
        schema = self.input.schema()
        key_idxs = [
            L.resolve_field_index(schema, k.cname) if isinstance(k, L.Column) else self._key_error(k)
            for k in self.partition_keys
        ]
        writers: dict[int, _Appender] = {}
        ipc_options = _ipc_write_options(resolve_file_codec(ctx.config.shuffle_compression()))
        target_bytes = ctx.config.shuffle_target_batch_mb() << 20
        push = self._push_eligible(ctx)
        window_bytes = ctx.config.push_shuffle_window_mb() << 20

        def write(out_part: int, rb: pa.RecordBatch) -> None:
            w = writers.get(out_part)
            if w is None:
                d = os.path.join(ctx.work_dir, self.job_id, str(self.stage_id), str(out_part))
                if push:
                    w = _PushAppender(
                        os.path.join(d, f"push-{input_partition}.arrow"),
                        key=(self.job_id, self.stage_id, input_partition, out_part),
                        owner=ctx.work_dir, options=ipc_options, window_bytes=window_bytes,
                        target_bytes=target_bytes, metrics=self.metrics,
                    )
                else:
                    os.makedirs(d, exist_ok=True)
                    w = _IpcAppender(
                        os.path.join(d, f"data-{input_partition}.arrow"),
                        options=ipc_options, target_bytes=target_bytes,
                    )
                writers[out_part] = w
            w.write(rb)

        try:
            with self.metrics.time("write_time"):
                for batch in self.input.execute(input_partition, ctx):
                    if not key_idxs or self.output_partitions == 1:
                        t = time.perf_counter()
                        rb = batch_to_arrow(batch)
                        t1 = time.perf_counter()
                        if rb.num_rows:
                            write(0, rb)
                        add_stats(stats, arrow_s=t1 - t, ipc_s=time.perf_counter() - t1)
                        continue
                    with self.metrics.time("repart_time"):
                        order, offsets = group_rows(batch, key_idxs, self.output_partitions)
                        # a pinned buffer of its own for each batch: the
                        # slices alias it, and the appenders' coalescers
                        # keep them past the next batch (the caching host
                        # allocator takes a buffer back once no slice holds it)
                        rb, starts, lens = grouped_arrow(HostStaging(), batch, order, offsets, stats)
                    if rb is None:
                        continue
                    t = time.perf_counter()
                    for out_part in np.flatnonzero(lens):
                        write(int(out_part), rb.slice(int(starts[out_part]), int(lens[out_part])))
                    add_stats(stats, ipc_s=time.perf_counter() - t)
            # a check that fires fails the attempt before its files are sealed
            ctx.raise_deferred()
            t = time.perf_counter()
            closed = {p: w.close() for p, w in sorted(writers.items())}
            add_stats(stats, ipc_s=time.perf_counter() - t)
        except BaseException:
            for w in writers.values():
                w.discard()
            raise

        out = []
        for out_part, (num_rows, num_batches, num_bytes, pushed) in closed.items():
            self.metrics.add("output_rows", num_rows)
            out.append(
                ShuffleWritePartitionMeta(
                    partition_id=out_part,
                    path=writers[out_part].path,
                    num_batches=num_batches,
                    num_rows=num_rows,
                    num_bytes=num_bytes,
                    push=pushed,
                )
            )
        return out

    @staticmethod
    def _key_error(k):
        raise ExecutionError(f"shuffle partition key {k.name()!r} must be a column")

    # In process (a stage plan run without its shuffle), the child streams
    # through.
    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        yield from self.input.execute(partition, ctx)


def _ipc_write_options(codec: str) -> paipc.IpcWriteOptions | None:
    """Resolved codec -> IpcWriteOptions. Readers detect the codec per file
    (it rides the IPC message headers), so files of several codecs can make
    up one partition."""
    if codec in ("", "none"):
        return None
    try:
        return paipc.IpcWriteOptions(compression=codec)
    except Exception as e:  # noqa: BLE001 — codec missing from this build
        raise ExecutionError(
            f"shuffle compression codec {codec!r} unavailable in this pyarrow build: {e}"
        ) from e


class _Appender:
    """Shared appender surface: ``write`` record batches in order,
    ``close`` -> (rows, batches, bytes, pushed), ``discard`` on attempt
    failure."""

    path: str

    def write(self, rb: pa.RecordBatch) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> tuple[int, int, int, bool]:  # pragma: no cover
        raise NotImplementedError

    def discard(self) -> None:  # pragma: no cover
        raise NotImplementedError


class _IpcAppender(_Appender):
    """One Arrow IPC file appended batch by batch (the reference's
    IPCWriter, shuffle_writer.rs:162-199), coalescing batches below the
    target size before they reach the file. A lifetime with no writes
    closes clean: no file, stats (0, 0, 0). ``close`` returns (rows,
    batches, bytes, pushed); ``discard`` ends a failed attempt and deletes
    the file."""

    def __init__(
        self,
        path: str,
        options: paipc.IpcWriteOptions | None = None,
        target_bytes: int = 0,
    ):
        self.path = path
        self._options = options
        self._writer: paipc.RecordBatchFileWriter | None = None
        self._coalescer = BatchCoalescer(target_bytes)
        self.num_rows = 0
        self.num_batches = 0

    def write(self, rb: pa.RecordBatch) -> None:
        out = self._coalescer.add(rb)
        if out is not None:
            self._write_now(out)

    def _write_now(self, rb: pa.RecordBatch) -> None:
        if self._writer is None:
            if self._options is not None:
                self._writer = paipc.new_file(self.path, rb.schema, options=self._options)
            else:
                self._writer = paipc.new_file(self.path, rb.schema)
        self._writer.write_batch(rb)
        self.num_rows += rb.num_rows
        self.num_batches += 1

    def close(self) -> tuple[int, int, int, bool]:
        tail = self._coalescer.flush()
        if tail is not None:
            self._write_now(tail)
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        num_bytes = os.path.getsize(self.path) if os.path.exists(self.path) else 0
        return self.num_rows, self.num_batches, num_bytes, False

    def discard(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if os.path.exists(self.path):
            os.remove(self.path)


def _own_memory(rb: pa.RecordBatch) -> pa.RecordBatch:
    """``rb`` with every column copied into memory of its own (dictionary
    values are shared, they are never pinned): a slice of a grouped batch
    otherwise keeps the batch's whole pinned host buffer alive."""
    return pa.RecordBatch.from_arrays([pa.concat_arrays([c]) for c in rb.columns], schema=rb.schema)


class _PushAppender(_Appender):
    """One output partition committed into the push registry (the
    reference's ``_PushAppender``): coalesced batches, each in memory of
    its own (``_own_memory``), append to an in-memory stream; the
    registry's window eviction may convert it to disk mid-write, and
    ``close`` seals it, push=True when it committed in memory. Spill bytes
    that this task's appends forced go to its ``push_spill_bytes``
    metric."""

    def __init__(self, path, key, owner, options, window_bytes, target_bytes, metrics):
        from ballista_tpu_torch.executor.push import REGISTRY

        self.path = path
        self._registry = REGISTRY
        # the registry owns the stream from its birth: seal() commits it
        # for consumers, abort() and drop_owner() retire it
        self._stream = REGISTRY.open(key, path, owner, options)  # lifelint: transfer=push-registry
        self._window_bytes = window_bytes
        self._coalescer = BatchCoalescer(target_bytes)
        self._metrics = metrics

    def write(self, rb: pa.RecordBatch) -> None:
        out = self._coalescer.add(rb)
        if out is not None:
            self._append_now(out)

    def _append_now(self, rb: pa.RecordBatch) -> None:
        spilled = self._registry.append(self._stream, _own_memory(rb), self._window_bytes)
        if spilled:
            self._metrics.add("push_spill_bytes", spilled)

    def close(self) -> tuple[int, int, int, bool]:
        tail = self._coalescer.flush()
        if tail is not None:
            self._append_now(tail)
        num_rows, num_batches, num_bytes, pushed = self._registry.seal(self._stream)
        if pushed:
            self._metrics.add("pushed_bytes", num_bytes)
        return num_rows, num_batches, num_bytes, pushed

    def discard(self) -> None:
        self._registry.abort(self._stream)
