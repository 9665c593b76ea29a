"""Sort and limit operators (port of ``ballista_tpu/exec/sort.py``).

SortExec gathers its input partitions into one batch and sorts it with
stable LSD passes of ``torch.sort(stable=True)`` (``ops/sort.py``). With a
``fetch`` bound it is the reference's TopK: the sorting permutation is cut
to the bound (rounded up to the capacity ladder) before the gather, and
rows past the bound are masked off. Serde carries the bound; the planner
never sets one. GlobalLimitExec applies skip/fetch over the merged input.
"""

from __future__ import annotations

from typing import Iterator

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch, round_capacity
from ballista_tpu_torch.datatypes import Schema
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, UnknownPartitioning
from ballista_tpu_torch.ops.concat import concat_batches
from ballista_tpu_torch.ops.sort import (
    SortKey,
    gather_batch,
    resolve_sort_keys,
    sort_batch,
    sort_perm,
)
from ballista_tpu_torch.plan.logical import SortExpr


class SortExec(ExecutionPlan):
    def __init__(
        self, input: ExecutionPlan, sort_exprs: list[SortExpr], fetch: int | None = None
    ) -> None:
        super().__init__()
        self.input = input
        self.sort_exprs = list(sort_exprs)
        self.fetch = fetch
        self._keys: list[SortKey] = resolve_sort_keys(input.schema(), self.sort_exprs)

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def output_partitioning(self):
        return UnknownPartitioning(1)

    def describe(self) -> str:
        ks = ", ".join(
            f"{s.expr.name()} {'ASC' if s.ascending else 'DESC'}"
            for s in self.sort_exprs
        )
        f = f", fetch={self.fetch}" if self.fetch is not None else ""
        return f"SortExec: [{ks}]{f}"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        assert partition == 0
        batches = []
        for p in range(self.input.output_partitioning().n):
            batches.extend(self.input.execute(p, ctx))
        if not batches:
            return
        merged = concat_batches(batches)
        with self.metrics.time("sort_time"):
            if self.fetch is None:
                out = sort_batch(merged, self._keys)
            else:
                # invalid rows sort last, so the first m rows of the
                # permutation hold the top rows: the gather scales with the
                # bound, not the input
                m = min(round_capacity(max(self.fetch, 8)), merged.capacity)
                out = gather_batch(merged, sort_perm(merged, self._keys)[:m])
                keep = torch.arange(m, device=out.valid.device) < self.fetch
                out = out.with_valid(out.valid & keep)
        yield out


class GlobalLimitExec(ExecutionPlan):
    """skip/fetch over the single merged input partition."""

    def __init__(self, input: ExecutionPlan, skip: int, fetch: int | None) -> None:
        super().__init__()
        self.input = input
        self.skip = skip
        self.fetch = fetch

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def output_partitioning(self):
        return UnknownPartitioning(1)

    def describe(self) -> str:
        return f"GlobalLimitExec: skip={self.skip}, fetch={self.fetch}"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        assert partition == 0
        remaining_skip = self.skip
        remaining = self.fetch
        for p in range(self.input.output_partitioning().n):
            for b in self.input.execute(p, ctx):
                if remaining is not None and remaining <= 0:
                    return
                # rank of live rows within the batch (order-preserving)
                rank = torch.cumsum(b.valid.to(torch.int64), 0) - 1
                keep = b.valid & (rank >= remaining_skip)
                if remaining is not None:
                    keep = keep & (rank < remaining_skip + remaining)
                # skip/fetch carry across batches on the live count: one
                # sync per batch (the common shape, under a sort or a
                # coalesce of one partition, is a single batch)
                n_live = int(b.valid.sum())
                taken = max(0, n_live - remaining_skip)
                if remaining is not None:
                    taken = min(taken, remaining)
                    remaining -= taken
                remaining_skip = max(0, remaining_skip - n_live)
                yield b.with_valid(keep)
