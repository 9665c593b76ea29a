"""Percentile operator: exact continuous percentiles by sorting (port of
``ballista_tpu/exec/percentile.py``), for ``median`` and
``approx_percentile_cont``.

All rows are sorted by (group keys, value) with NULL values last in each
group; each group's live non-null values are then a prefix of its segment
[ps, pe], and the percentile q interpolates linearly between the two order
statistics around ``t = q * (cnt - 1)``. The answer is exact (the reference
computes it the same way, in place of DataFusion's t-digest). The operator
gathers every input partition into one batch, as the reference does. Its
output (one live row per group, at the input's capacity) goes through the
adaptive capacity shrink (``exec/shrink.maybe_shrink``) at its
``display()`` site.
"""

from __future__ import annotations

from typing import Iterator

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, UnknownPartitioning
from ballista_tpu_torch.exec.window import _changed_of, _region_edges
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.ops.concat import concat_batches
from ballista_tpu_torch.ops.sort import SortKey, gather_batch, sort_perm


def _percentiles(key_pairs, val, val_nmask, valid_sorted, qs):
    """On rows sorted by (group keys, value) with NULL values last in each
    group: (per-q values, per-q null flags, group-start flags), all in
    sorted row space."""
    cap, dev = val.shape[0], val.device
    changed = _changed_of([c for c, _ in key_pairs], [m for _, m in key_pairs], cap, dev)
    changed[1:] |= valid_sorted[1:] != valid_sorted[:-1]
    ps, pe = _region_edges(changed, cap)
    live = valid_sorted if val_nmask is None else valid_sorted & ~val_nmask
    # a group's live rows are a prefix of its segment, so the live count of
    # each row's group is a cumsum difference
    cnt_cs = torch.cumsum(live.to(torch.int64), 0)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    pre = torch.where(ps > 0, cnt_cs[(ps - 1).clamp(0, cap - 1).long()], zero)
    cnt = cnt_cs[pe.clamp(0, cap - 1).long()] - pre

    vf = val.to(torch.float64)
    outs, nulls = [], []
    for q in qs:
        t = q * (cnt - 1).clamp(min=0).to(torch.float64)
        lo = torch.floor(t).to(torch.int64)
        hi = torch.ceil(t).to(torch.int64)
        frac = t - lo.to(torch.float64)
        vlo = vf[(ps + lo).clamp(0, cap - 1)]
        vhi = vf[(ps + hi).clamp(0, cap - 1)]
        outs.append(vlo * (1.0 - frac) + vhi * frac)
        nulls.append(cnt == 0)
    return outs, nulls, changed & valid_sorted


class PercentileExec(ExecutionPlan):
    """One output row per group: the group keys and the interpolated
    percentiles. Output rows sit at each group's first sorted position; the
    batch keeps its input capacity with validity on those rows."""

    def __init__(self, input: ExecutionPlan, group_exprs, group_names, requests) -> None:
        super().__init__()
        self.input = input
        self.group_exprs = list(group_exprs)
        self.group_names = list(group_names)
        self.requests = list(requests)
        ins = input.schema()
        for e in self.group_exprs:
            if not isinstance(e, L.Column):
                raise PlanError(
                    "percentile group keys must be columns (the optimizer projects first)"
                )
        if len({v.name() for v, _, _ in self.requests}) != 1:
            raise PlanError(
                "one Percentile node serves a single value expression; "
                "the optimizer splits per value"
            )
        v = self.requests[0][0]
        if not isinstance(v, L.Column):
            raise PlanError(
                "percentile value must be a column (the optimizer projects first)"
            )
        self._gk = [L.resolve_field_index(ins, e.cname) for e in self.group_exprs]
        self._vi = L.resolve_field_index(ins, v.cname)
        if ins.fields[self._vi].dtype == DataType.STRING:
            raise PlanError("percentile over STRING is not supported")
        self._schema = Schema(
            [
                Field(n, e.data_type(ins), e.nullable(ins))
                for e, n in zip(self.group_exprs, self.group_names)
            ]
            + [Field(n, DataType.FLOAT64, True) for _, _, n in self.requests]
        )

    def schema(self) -> Schema:
        return self._schema

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def output_partitioning(self):
        return UnknownPartitioning(1)

    def describe(self) -> str:
        g = ", ".join(e.name() for e in self.group_exprs)
        r = ", ".join(f"{n}=p{q:g}({e.name()})" for e, q, n in self.requests)
        return f"PercentileExec: groupBy=[{g}], [{r}]"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        from ballista_tpu_torch.exec.shrink import maybe_shrink

        batches = []
        for p in range(self.input.output_partitioning().n):
            batches.extend(self.input.execute(p, ctx))
        if not batches:
            return
        b = concat_batches(batches) if len(batches) > 1 else batches[0]
        # group keys ascending, then the value ascending with NULLs last
        keys = [SortKey(col=i, ascending=True) for i in self._gk]
        keys.append(SortKey(col=self._vi, ascending=True, nulls_first=False))
        with self.metrics.time("sort_time"):
            sb = gather_batch(b, sort_perm(b, keys))
        key_pairs = [(sb.columns[i], sb.nulls[i]) for i in self._gk]
        with self.metrics.time("pct_time"):
            outs, nulls, starts = _percentiles(
                key_pairs, sb.columns[self._vi], sb.nulls[self._vi], sb.valid,
                [q for _, q, _ in self.requests],
            )
        dicts = (b.dictionaries.get(b.schema.fields[i].name) for i in self._gk)
        self.metrics.add("output_batches")
        out = DeviceBatch(
            schema=self._schema,
            columns=tuple([c for c, _ in key_pairs] + outs),
            valid=starts,
            nulls=tuple([m for _, m in key_pairs] + nulls),
            dictionaries={n: d for n, d in zip(self.group_names, dicts) if d is not None},
        )
        yield maybe_shrink(out, ctx, self.display(), partition)
