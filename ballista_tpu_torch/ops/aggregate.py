"""Grouped and scalar aggregation on torch tensors.

The port of the dense and scalar paths of ``ballista_tpu/ops/aggregate.py``:

- ``dense_group_aggregate``: grouping over dictionary-coded or boolean
  keys, where the group slot is the mixed-radix index over (vocab + 1)
  values per key (the +1 is NULL). No sort; every reduction is one pass over
  the rows. This is TPC-H q1's shape (12 slots).
- ``scalar_aggregate``: ungrouped SUM/COUNT/MIN/MAX (q6).

The sort-based ``group_aggregate`` (for keys that are not dense) waits for
the sort slice (ROADMAP queue 1, item 4).

Routing in ``_stacked_reduce``: with at most ``onehot_agg.MAX_SLOTS`` slots
(2048, the reference's ``_MATMUL_MAX_SLOTS`` gate), the non-null counts and
every f64 SUM go through ``onehot_agg.onehot_sums``, one call per
``onehot_agg.MAX_ROWS`` value rows (on the card: the CUDA kernel; on the
CPU: its plain version).
The reference also gates its TPU kernel on ``_PALLAS_MIN_ROWS`` (1M rows),
because the TPU kernel accumulates in f32 and carries ~1e-8 relative
error; the port's kernel is f64 throughout, so there is no row gate. int64
SUMs and MIN/MAX stay scatters (``index_add_``/``scatter_reduce_``), as the
reference keeps them on scatters. Above the slot gate the f64 sums are a
plain ``index_add_``, which is not deterministic on the card (ROADMAP
queue 3).
"""

from __future__ import annotations

import dataclasses
from enum import Enum

import torch

from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops import onehot_agg


class AggOp(Enum):
    SUM = "sum"
    COUNT = "count"  # COUNT(expr): counts non-null; COUNT(*) passes no nulls
    MIN = "min"
    MAX = "max"

    @property
    def merge_op(self) -> "AggOp":
        """Op used to merge partial states (COUNT merges by SUM)."""
        return AggOp.SUM if self == AggOp.COUNT else self


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """SQL SUM widens to int64 / float64; BOOL sums count TRUEs."""
    if dtype == torch.bool or not (dtype.is_floating_point or dtype.is_complex):
        return torch.int64
    return torch.float64


def _max_ident(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


def _min_ident(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


@dataclasses.dataclass
class GroupAggResult:
    """Aggregation output, every tensor of length ``capacity``."""

    keys: list[torch.Tensor]
    key_nulls: list[torch.Tensor | None]
    values: list[torch.Tensor]
    value_nulls: list[torch.Tensor | None]
    valid: torch.Tensor  # bool[capacity]: which output slots are groups
    n_groups: torch.Tensor  # int32 scalar
    overflow: torch.Tensor  # bool scalar: more groups than capacity


def _scatter_minmax(idx, capacity: int, stacked: torch.Tensor, kind: str):
    """Scatter-min/max of (n, k) ``stacked`` into ``capacity`` slots; rows
    with ``idx == capacity`` land in a spare slot that is cut off."""
    dt = stacked.dtype
    work = stacked.to(torch.uint8) if dt == torch.bool else stacked
    ident = (_max_ident if kind == "amin" else _min_ident)(dt)
    init = torch.full(
        (capacity + 1, stacked.shape[1]), ident, dtype=work.dtype,
        device=stacked.device,
    )
    res = init.scatter_reduce_(
        0, idx.unsqueeze(1).expand_as(work), work, reduce=kind, include_self=True
    )[:capacity]
    return res.to(dt)


def _stacked_reduce(
    rid: torch.Tensor, capacity: int, vals: list, lives: list, ops: tuple
) -> tuple[list, list]:
    """Every value reduction into ``capacity`` slots keyed by ``rid``
    (int32, ``capacity`` = dropped). Per-column NULL masks are folded into
    the contribution (SUM adds 0, MIN/MAX add their identity), so columns
    share one pass; the non-null count matrix doubles as COUNT output and
    the SQL all-NULL flags."""
    m = len(vals)
    out_vals: list = [None] * m
    out_val_nulls: list = [None] * m
    if m == 0:
        return out_vals, out_val_nulls
    use_kernel = capacity <= onehot_agg.MAX_SLOTS
    idx = rid.long()
    f64_sums: list[tuple[int, torch.Tensor]] = []
    groups: dict[tuple[str, torch.dtype], list] = {}
    for i, (vc, live, op) in enumerate(zip(vals, lives, ops)):
        if op == AggOp.COUNT:
            continue
        if op == AggOp.SUM:
            acc_t = _sum_dtype(vc.dtype)
            contrib = torch.where(live, vc, torch.zeros_like(vc)).to(acc_t)
            if acc_t == torch.float64:
                f64_sums.append((i, contrib))
            else:
                groups.setdefault(("add", acc_t), []).append((i, contrib))
        elif op == AggOp.MIN:
            masked = torch.where(live, vc, _max_ident(vc.dtype))
            groups.setdefault(("amin", vc.dtype), []).append((i, masked))
        elif op == AggOp.MAX:
            masked = torch.where(live, vc, _min_ident(vc.dtype))
            groups.setdefault(("amax", vc.dtype), []).append((i, masked))
        else:  # pragma: no cover
            raise ExecutionError(f"unknown agg op {op}")
    if use_kernel:
        # one call (per MAX_ROWS rows) covers the count matrix and every f64
        # sum: live flags as 0/1 rows (exact in f64), then the f64
        # contributions
        rows = [l.to(torch.float64) for l in lives] + [c for _, c in f64_sums]
        step = onehot_agg.MAX_ROWS
        sums = torch.cat(
            [
                onehot_agg.onehot_sums(rid, torch.stack(rows[k : k + step]), capacity)
                for k in range(0, len(rows), step)
            ],
            dim=1,
        )
        nonnull = sums[:, :m].round().to(torch.int64)
        for j, (i, _) in enumerate(f64_sums):
            out_vals[i] = sums[:, m + j]
    else:
        cnt = torch.stack([l.to(torch.int64) for l in lives], dim=1)
        nonnull = torch.zeros(
            capacity + 1, m, dtype=torch.int64, device=rid.device
        ).index_add_(0, idx, cnt)[:capacity]
        if f64_sums:
            groups[("add", torch.float64)] = f64_sums
    for i, op in enumerate(ops):
        if op == AggOp.COUNT:
            out_vals[i] = nonnull[:, i]
        else:
            out_val_nulls[i] = nonnull[:, i] == 0  # agg over no values: NULL
    for (kind, dt), entries in groups.items():
        stacked = torch.stack([c for _, c in entries], dim=1)
        if kind == "add":
            res = torch.zeros(
                capacity + 1, len(entries), dtype=dt, device=rid.device
            ).index_add_(0, idx, stacked)[:capacity]
        else:
            res = _scatter_minmax(idx, capacity, stacked, kind)
        for j, (i, _) in enumerate(entries):
            out_vals[i] = res[:, j]
    return out_vals, out_val_nulls


# Dense slots grow as prod(vocab+1); past this the reference takes its
# sort-based path.
DENSE_AGG_MAX_SLOTS = 1 << 16


def dense_group_aggregate(
    key_codes: list[torch.Tensor],
    key_nulls: list[torch.Tensor | None],
    vocab_sizes: list[int],
    valid: torch.Tensor,
    val_cols: list[torch.Tensor],
    val_nulls: list[torch.Tensor | None],
    ops: list[AggOp],
) -> GroupAggResult:
    """Sort-free grouped aggregation over dictionary codes: the slot is
    the mixed-radix index over (vocab + 1) values per key (the +1 slot is
    NULL: SQL groups NULLs together). Capacity is exactly prod(vocab + 1),
    so overflow is impossible."""
    P = 1
    for v in vocab_sizes:
        P *= v + 1
    seg = None
    for code, nm, v in zip(key_codes, key_nulls, vocab_sizes):
        c = code.to(torch.int32).clamp(0, v - 1)
        if nm is not None:
            c = torch.where(nm, v, c)
        seg = c if seg is None else seg * (v + 1) + c
    rid_all = torch.where(valid, seg, P).to(torch.int32).contiguous()

    # which slots hold at least one live row
    occupied = torch.zeros(P + 1, dtype=torch.bool, device=valid.device)
    occupied = occupied.index_fill_(0, rid_all.long(), True)[:P]

    lives = [valid if vn is None else (valid & ~vn) for vn in val_nulls]
    out_vals, out_val_nulls = _stacked_reduce(
        rid_all, P, list(val_cols), lives, tuple(ops)
    )

    # key codes of each slot from the mixed-radix index
    slot = torch.arange(P, dtype=torch.int32, device=valid.device)
    strides = []
    s = 1
    for v in reversed(vocab_sizes):
        strides.append(s)
        s *= v + 1
    strides.reverse()
    out_keys, out_key_nulls = [], []
    for code, nm, v, stride in zip(key_codes, key_nulls, vocab_sizes, strides):
        digit = torch.div(slot, stride, rounding_mode="floor") % (v + 1)
        out_keys.append(digit.to(code.dtype))
        out_key_nulls.append((digit == v) if nm is not None else None)
    return GroupAggResult(
        keys=out_keys,
        key_nulls=out_key_nulls,
        values=out_vals,
        value_nulls=out_val_nulls,
        valid=occupied,
        n_groups=occupied.sum(dtype=torch.int32),
        overflow=torch.zeros((), dtype=torch.bool, device=valid.device),
    )


def _minmax_all(x: torch.Tensor, kind: str) -> torch.Tensor:
    work = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = work.amin() if kind == "min" else work.amax()
    return out.to(x.dtype)


def scalar_aggregate(
    valid: torch.Tensor,
    val_cols: list[torch.Tensor],
    val_nulls: list[torch.Tensor | None],
    ops: list[AggOp],
) -> tuple[list[torch.Tensor], list[torch.Tensor | None]]:
    """Ungrouped aggregation -> one 0-dim tensor per op (+ null flags)."""
    outs: list[torch.Tensor] = []
    nulls: list[torch.Tensor | None] = []
    for vc, vn, op in zip(val_cols, val_nulls, ops):
        live = valid if vn is None else (valid & ~vn)
        cnt = live.sum(dtype=torch.int64)
        if op == AggOp.COUNT:
            outs.append(cnt)
            nulls.append(None)
            continue
        if op == AggOp.SUM:
            contrib = torch.where(live, vc, torch.zeros_like(vc))
            outs.append(contrib.to(_sum_dtype(vc.dtype)).sum())
        elif op == AggOp.MIN:
            outs.append(_minmax_all(torch.where(live, vc, _max_ident(vc.dtype)), "min"))
        elif op == AggOp.MAX:
            outs.append(_minmax_all(torch.where(live, vc, _min_ident(vc.dtype)), "max"))
        else:  # pragma: no cover
            raise ExecutionError(f"unknown agg op {op}")
        nulls.append(cnt == 0)
    return outs, nulls
