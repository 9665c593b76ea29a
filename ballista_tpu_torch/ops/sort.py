"""Multi-key sort of a batch (port of ``ballista_tpu/ops/sort.py``), on the
LSD pass chain of ``ops/perm.py``.

A multi-key sort runs as stable single-key argsort passes, least
significant key first; all columns then ride one gather. Invalid rows
always sort last (a leading ``~valid`` pass), so a sorted batch is also
compact. NULL placement is its own pass per key. Descending keys are
reversed the reference's way (floats negated, integers bit-inverted: ~x is
-x-1, a total order reversal that keeps INT_MIN in range), so NaN sorts
last in both directions, as in the reference. String columns sort by
dictionary code, which is correct because dictionaries are sorted.
"""

from __future__ import annotations

import dataclasses

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.ops.perm import multi_key_perm, take_batch


@dataclasses.dataclass(frozen=True)
class SortKey:
    """One ORDER BY term: column index, direction, null placement."""

    col: int
    ascending: bool = True
    nulls_first: bool = False


def resolve_sort_keys(schema, sort_exprs) -> list[SortKey]:
    """ORDER BY terms -> SortKeys; raises PlanError for non-column keys
    (the planner projects expressions first)."""
    from ballista_tpu_torch.errors import PlanError
    from ballista_tpu_torch.expr import logical as L

    keys = []
    for s in sort_exprs:
        if not isinstance(s.expr, L.Column):
            raise PlanError(
                "sort requires column sort keys (planner projects "
                "expressions first)"
            )
        keys.append(
            SortKey(
                col=L.resolve_field_index(schema, s.expr.cname),
                ascending=s.ascending,
                nulls_first=s.nulls_first,
            )
        )
    return keys


def sort_perm(batch: DeviceBatch, keys: list[SortKey]) -> torch.Tensor:
    """The sorting permutation for ``keys`` (invalid rows last)."""
    passes = [(~batch.valid, False)]
    for k in keys:
        nm = batch.nulls[k.col]
        if nm is not None:
            # 0 sorts before 1: nulls_first -> nulls get 0
            passes.append((nm != k.nulls_first, False))
        passes.append((batch.columns[k.col], not k.ascending))
    return multi_key_perm(passes)


def gather_batch(batch: DeviceBatch, perm: torch.Tensor) -> DeviceBatch:
    """Reorder a whole batch by a permutation."""
    cols, nulls, valid = take_batch(list(batch.columns), list(batch.nulls), batch.valid, perm)
    return DeviceBatch(
        schema=batch.schema,
        columns=tuple(cols),
        valid=valid,
        nulls=tuple(nulls),
        dictionaries=dict(batch.dictionaries),
    )


def sort_batch(batch: DeviceBatch, keys: list[SortKey]) -> DeviceBatch:
    return gather_batch(batch, sort_perm(batch, keys))
