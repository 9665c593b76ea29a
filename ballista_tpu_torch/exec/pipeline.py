"""Row-pipeline operators: Filter, Projection, Coalesce, Rename, and the
streamed scan's prefetch (port of ``ballista_tpu/exec/pipeline.py``).

Filter and Projection are per-batch functions. As in the reference, the
outermost operator of a Filter/Projection chain runs the whole chain on
each batch of the chain's source; here that is a plain Python loop over the
operators (eager torch has no program to fuse). Inside :func:`unfused`
(EXPLAIN ANALYZE) every operator runs on its own, so each one meters its
own rows. RenameExec relabels a subquery's columns.

The chain's output goes through the adaptive capacity shrink
(``exec/shrink.maybe_shrink``) once, at the outermost FilterExec's site
(its ``display()``), so the shrink sees the chain's whole selectivity; a
chain without a filter does not shrink. Unfused, each FilterExec shrinks
its own output at its own site, as the reference's unfused path does.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.compilecache.tracecache import expr_key, schema_key, shared_callable
from ballista_tpu_torch.datatypes import Field, Schema
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.expr.physical import compile_expr


def prefetch_slices(load, items, depth: int, metrics=None):
    """Run ``load(item)`` on one background host thread, keeping up to
    ``depth`` results in flight beyond the one being consumed, and yield
    the results in order (``depth`` <= 0: load each in turn, no thread).

    The streamed Parquet scan's overlap of reads with compute: while the
    card works through slice i's batches, the worker reads and decodes
    slice i+1 and uploads it. The upload is a plain copy from pageable
    host memory on the default stream, which orders it before any later
    kernel that reads the batch, whichever thread launches it. One worker
    keeps host memory at ``depth + 1`` slices and the read order.

    ``metrics`` records ``prefetch_hits`` (the result was ready when the
    consumer asked) and ``prefetch_misses`` (the consumer waited; the first
    slice always misses)."""
    items = list(items)
    if depth <= 0 or len(items) <= 1:
        for it in items:
            yield load(it)
        return
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from ballista_tpu_torch.analysis import reswitness

    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="scan-prefetch")
    pool_tok = reswitness.acquire("thread-pool", "scan-prefetch")
    try:
        pending: deque = deque()
        idx = 0
        # fill to depth, not depth+1: the consumer holds one result after
        # the first yield, so depth+1 slices are resident
        while idx < len(items) and len(pending) < depth:
            pending.append(ex.submit(load, items[idx]))
            idx += 1
        while pending:
            fut = pending.popleft()
            if metrics is not None:
                metrics.add("prefetch_hits" if fut.done() else "prefetch_misses")
            out = fut.result()
            if idx < len(items):
                pending.append(ex.submit(load, items[idx]))
                idx += 1
            yield out
    finally:
        # an abandoned consumer (LIMIT) must not leave the worker reading
        # a file the caller is about to close
        ex.shutdown(wait=True, cancel_futures=True)
        reswitness.release(pool_tok)


_FUSION = threading.local()


@contextlib.contextmanager
def unfused():
    """Within this block, on this thread, every Filter and Projection runs
    on its own instead of as a chain (the reference's
    ``BALLISTA_TPU_NO_FUSE``, scoped to the caller's thread)."""
    prev = getattr(_FUSION, "off", False)
    _FUSION.off = True
    try:
        yield
    finally:
        _FUSION.off = prev


def fusable_chain(plan: ExecutionPlan):
    """(source, ops): the maximal Filter/Projection chain hanging off
    ``plan``, ops innermost-first; source is the first other input."""
    if getattr(_FUSION, "off", False):
        return plan.input, [plan]
    ops: list[ExecutionPlan] = []
    p = plan
    while isinstance(p, (FilterExec, ProjectionExec)):
        ops.append(p)
        p = p.input
    ops.reverse()
    return p, ops


class _ChainPipeline:
    """Shared execute() body for the outermost operator of a chain."""

    def _shrink_site(self, ops: list) -> str | None:
        """The chain's shrink site: the outermost FilterExec's
        ``display()``, kept per fusion mode (a display walks the subtree)."""
        off = getattr(_FUSION, "off", False)
        sites = self.__dict__.setdefault("_shrink_sites", {})
        if off not in sites:
            sites[off] = next(
                (o.display() for o in reversed(ops) if isinstance(o, FilterExec)), None
            )
        return sites[off]

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        from ballista_tpu_torch.exec.shrink import maybe_shrink

        source, ops = fusable_chain(self)
        fns = [op.batch_fn(ctx.device) for op in ops]
        shrink_site = self._shrink_site(ops)
        timer = "filter_time" if isinstance(self, FilterExec) else "project_time"
        for b in source.execute(partition, ctx):
            with self.metrics.time(timer):
                for f in fns:
                    b = f(b)
            self.metrics.add("input_batches")
            self.metrics.counters["fused_ops"] = len(ops)
            if shrink_site is not None:
                b = maybe_shrink(b, ctx, shrink_site, partition)
            yield b


class FilterExec(_ChainPipeline, ExecutionPlan):
    """Clears validity bits; no data movement."""

    def __init__(self, input: ExecutionPlan, predicate: L.Expr) -> None:
        super().__init__()
        self.input = input
        self.predicate = predicate

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def output_partitioning(self):
        return self.input.output_partitioning()

    def describe(self) -> str:
        return f"FilterExec: {self.predicate.name()}"

    def _cache_key(self, device) -> tuple:
        return (
            "filter",
            expr_key(self.predicate),
            schema_key(self.input.schema()),
            str(device),
        )

    def batch_fn(self, device) -> Callable[[DeviceBatch], DeviceBatch]:
        """The filter over one batch on ``device``, shared across plan
        instances by its signature (``compilecache.tracecache``)."""

        def build():
            phys = compile_expr(self.predicate, self.input.schema())

            def run(batch: DeviceBatch) -> DeviceBatch:
                cv = phys.evaluate(batch)
                keep = cv.values.to(torch.bool)
                if cv.nulls is not None:
                    keep = keep & ~cv.nulls  # NULL predicate = drop row
                return batch.with_valid(batch.valid & keep)

            return run

        return shared_callable(self._cache_key(device), build)


class ProjectionExec(_ChainPipeline, ExecutionPlan):
    def __init__(self, input: ExecutionPlan, exprs: list[L.Expr]) -> None:
        super().__init__()
        self.input = input
        self.exprs = list(exprs)
        ins = input.schema()
        self._schema = Schema(
            [Field(e.name(), e.data_type(ins), e.nullable(ins)) for e in self.exprs]
        )

    def schema(self) -> Schema:
        return self._schema

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def output_partitioning(self):
        return self.input.output_partitioning()

    def describe(self) -> str:
        return "ProjectionExec: " + ", ".join(e.name() for e in self.exprs)

    def _cache_key(self, device) -> tuple:
        return (
            "project",
            tuple(expr_key(e) for e in self.exprs),
            schema_key(self.input.schema()),
            str(device),
        )

    def batch_fn(self, device) -> Callable[[DeviceBatch], DeviceBatch]:
        """The projection of one batch on ``device``, shared across plan
        instances by its signature (``compilecache.tracecache``)."""
        ins = self.input.schema()
        out_schema = self._schema

        def build():
            phys = [compile_expr(e, ins) for e in self.exprs]

            def run(batch: DeviceBatch) -> DeviceBatch:
                cols, nulls, dicts = [], [], {}
                for field, p in zip(out_schema, phys):
                    cv = p.evaluate(batch)
                    vals = cv.values
                    want = field.dtype.to_torch()
                    if vals.dtype != want and not (
                        want == torch.int64 and vals.dtype == torch.int32
                    ):
                        # int32 is a permitted physical form of a logical
                        # INT64 column (arrow_interop narrowing)
                        vals = vals.to(want)
                    cols.append(vals)
                    nulls.append(cv.nulls)
                    if cv.dictionary is not None:
                        dicts[field.name] = cv.dictionary
                return batch.with_columns(out_schema, cols, nulls, dicts)

            return run

        return shared_callable(self._cache_key(device), build)


class CoalescePartitionsExec(ExecutionPlan):
    """Merge all input partitions into one stream."""

    def __init__(self, input: ExecutionPlan) -> None:
        super().__init__()
        self.input = input

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def describe(self) -> str:
        return "CoalescePartitionsExec"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        assert partition == 0, "coalesce has a single output partition"
        for p in range(self.input.output_partitioning().n):
            yield from self.input.execute(p, ctx)


class RenameExec(ExecutionPlan):
    """Schema rename (SubqueryAlias): the same columns under requalified
    names; string dictionaries follow their columns."""

    def __init__(self, input: ExecutionPlan, new_schema: Schema) -> None:
        super().__init__()
        self.input = input
        self._schema = new_schema

    def schema(self) -> Schema:
        return self._schema

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def output_partitioning(self):
        return self.input.output_partitioning()

    def describe(self) -> str:
        return f"RenameExec: {self._schema.names}"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        for b in self.input.execute(partition, ctx):
            dicts = {}
            for i, nf in enumerate(self._schema):
                d = b.dictionaries.get(b.schema.fields[i].name)
                if d is not None:
                    dicts[nf.name] = d
            yield DeviceBatch(
                schema=self._schema,
                columns=b.columns,
                valid=b.valid,
                nulls=b.nulls,
                dictionaries=dicts,
                shards=b.shards,
            )
