"""Multi-key sort of a batch (port of ``ballista_tpu/ops/sort.py`` and the
LSD pass chain of ``ballista_tpu/ops/perm.py``).

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


def stable_argsort(col: torch.Tensor, descending: bool = False) -> torch.Tensor:
    c = col.to(torch.int32) if col.dtype == torch.bool else col
    if c.dtype.is_floating_point:
        # The card's radix sort orders bit patterns, so it puts a NaN with
        # the sign bit set (as negating a NaN gives) first; the CPU's sort
        # and the reference's put every NaN last and keep +-0.0 in input
        # order. One NaN and one zero make the two agree.
        if descending:
            c = -c
        c = torch.where(torch.isnan(c), torch.full_like(c, float("nan")), c + 0.0)
    elif descending:
        c = ~c
    return torch.sort(c, stable=True).indices


def multi_key_perm(passes: list[tuple[torch.Tensor, bool]]) -> torch.Tensor:
    """Permutation sorting by ``passes`` (column, descending), given most
    significant first and run least significant first."""
    perm = torch.arange(passes[0][0].shape[0], device=passes[0][0].device)
    for col, desc in reversed(passes):
        perm = perm[stable_argsort(col[perm], desc)]
    return perm


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
    return DeviceBatch(
        schema=batch.schema,
        columns=tuple(c[perm] for c in batch.columns),
        valid=batch.valid[perm],
        nulls=tuple(None if m is None else m[perm] for m in batch.nulls),
        dictionaries=dict(batch.dictionaries),
    )


def sort_batch(batch: DeviceBatch, keys: list[SortKey]) -> DeviceBatch:
    return gather_batch(batch, sort_perm(batch, keys))
