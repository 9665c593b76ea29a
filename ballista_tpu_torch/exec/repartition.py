"""HashRepartitionExec: the hash-exchange boundary (port of
``ballista_tpu/exec/repartition.py``).

The distributed planner (``PhysicalPlanner(distributed=True)``) puts one
between the partial and the final aggregate and under both sides of a
partitioned join. In a distributed run the stage splitter
(``distributed_plan.py``) turns it into a shuffle, written by
``executor/shuffle.py`` and read by ``executor/reader.py``; in process it
executes by masking: the
input is materialized once per task context, its live rows gathered into
one batch of the smallest ladder capacity that holds them, their
partition ids computed once (the partition-hash kernel on the card), and
output partition p is that batch with its validity restricted to
``pid == p``; the K views share the columns. (The reference views each
input batch K times, each at its full capacity: a chain of n
repartitions then multiplies the batches, or their padded rows, by K^n,
which a jitted program absorbs and eager torch does not; the distributed
q5 made over 5,000 eager probes on 4 partitions.)
"""

from __future__ import annotations

import functools
from typing import Iterator

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch, round_capacity
from ballista_tpu_torch.datatypes import Schema
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.exec.base import ExecutionPlan, HashPartitioning, TaskContext
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.ops.concat import unify_dictionaries
from ballista_tpu_torch.ops.partition import partition_ids, string_key_tables


def _live_rows(batches: list[DeviceBatch]) -> DeviceBatch:
    """The live rows of ``batches``, in order, in one batch of the smallest
    ladder capacity that holds them (one host sync for the count)."""
    batches = unify_dictionaries(batches, batches[0].schema)
    idx = [torch.nonzero(b.valid).squeeze(1) for b in batches]
    n = sum(int(i.numel()) for i in idx)
    cap = round_capacity(max(n, 1))

    def gather(parts: list[torch.Tensor]) -> torch.Tensor:
        out = torch.cat([p[i] for p, i in zip(parts, idx)])
        return torch.cat([out, out.new_zeros(cap - n)])

    nulls = []
    for c in range(len(batches[0].schema)):
        masks = [b.nulls[c] for b in batches]
        nulls.append(
            None if all(m is None for m in masks)
            else gather([torch.zeros_like(b.valid) if m is None else m for m, b in zip(masks, batches)])
        )
    return DeviceBatch(
        schema=batches[0].schema,
        columns=tuple(gather([b.columns[c] for b in batches]) for c in range(len(nulls))),
        valid=torch.arange(cap, device=batches[0].device) < n,
        nulls=tuple(nulls),
        dictionaries=dict(batches[0].dictionaries),
    )


@functools.lru_cache(maxsize=None)
def partition_ids_fn(key_idxs: tuple, num_partitions: int):
    """The per-batch partition-id function of one routing (the key columns
    and K): this operator's, and, with the distributed tier, the shuffle
    writer's. The grace-hash spills route by the same rule through the
    grouped mode (``ops/partition.batch_partition_groups``). The string-key
    tables are an argument, as each batch's dictionaries give their own."""
    return lambda batch, tables: partition_ids(batch, list(key_idxs), num_partitions, tables)


class HashRepartitionExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, keys: list[L.Expr], partitions: int) -> None:
        super().__init__()
        if not keys:
            raise ExecutionError("hash repartition requires keys")
        self.input = input
        self.keys = list(keys)
        self.partitions = max(1, partitions)
        # (task context, (batch, partition ids) or None): compared by
        # identity, a strong reference so a freed context's address cannot
        # match a later attempt's
        self._cache: tuple | None = None

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def output_partitioning(self):
        return HashPartitioning(tuple(self.keys), self.partitions)

    def describe(self) -> str:
        ks = ", ".join(k.name() for k in self.keys)
        return f"HashRepartitionExec: keys=[{ks}], partitions={self.partitions}"

    def _key_idxs(self) -> tuple:
        schema = self.input.schema()
        out = []
        for k in self.keys:
            if not isinstance(k, L.Column):
                raise ExecutionError(f"repartition key {k.name()!r} must be a column")
            out.append(L.resolve_field_index(schema, k.cname))
        return tuple(out)

    def _materialize(self, ctx: TaskContext) -> tuple[DeviceBatch, torch.Tensor] | None:
        """The input's live rows as one batch, with their partition ids,
        once per task context (None when the input has no batch): each
        output partition views the same tensors through its own validity
        mask."""
        if self._cache is not None and self._cache[0] is ctx:
            return self._cache[1]
        key_idxs = self._key_idxs()
        batches = [
            b for p in range(self.input.output_partitioning().n) for b in self.input.execute(p, ctx)
        ]
        out = None
        if batches:
            with self.metrics.time("repart_time"):
                b = _live_rows(batches)
                fn = partition_ids_fn(key_idxs, self.partitions)
                out = (b, fn(b, string_key_tables(b, list(key_idxs))))
        self._cache = (ctx, out)
        return out

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        got = self._materialize(ctx)
        if got is not None:
            b, pid = got
            yield b.with_valid(b.valid & (pid == partition))
