"""Grouped and scalar aggregation on torch tensors (port of
``ballista_tpu/ops/aggregate.py``).

- ``group_aggregate``: sort-based grouping for any keys. The keys sort by
  stable LSD passes (``ops/perm.py``), every column rides one stacked
  gather, and a segment finisher reduces the now-adjacent groups: SUM and
  COUNT by differences of prefix sums at the segment starts, MIN/MAX by a
  scatter, keys gathered at each segment's first row. Output has a fixed
  group capacity; more groups than that set the ``overflow`` flag, which
  the operator defers to the task boundary. With ``presorted=True`` the
  sort and the gather are skipped: the rows are speculated to arrive
  grouped in key order (a clustered input), each row is compared with the
  previous live row, and the ``sorted_ok`` flag validates the guess.
- ``dense_group_aggregate``: grouping over dictionary-coded or boolean
  keys, where the group slot is the mixed-radix index over (vocab + 1)
  values per key (the +1 is NULL). No sort; every reduction is one pass over
  the rows. This is TPC-H q1's shape (12 slots).
- ``scalar_aggregate``: ungrouped SUM/COUNT/MIN/MAX (q6).

SQL grouping semantics are the reference's: NULL is its own group, NaN
equals NaN, -0.0 equals +0.0, and groups come out in the keys' sort order.

Routing in ``_stacked_reduce``: every dense aggregate (up to
``onehot_agg.MAX_SLOTS`` = 65,536 slots, which is also
``DENSE_AGG_MAX_SLOTS``) sends its non-null counts and every f64 SUM through
``onehot_agg.onehot_sums``, one call per ``onehot_agg.MAX_ROWS`` value rows
(on the card: the CUDA kernel; on the CPU: its plain version). The kernel
sums in a fixed order, so these results are bit-identical from run to run.
Columns that share one live-row mask share one count row.
The reference also gates its TPU kernel on ``_PALLAS_MIN_ROWS`` (1M rows)
and ``_MATMUL_MAX_SLOTS`` (2048 slots), because the TPU kernel accumulates
in f32 and contracts a one-hot (P*n*R work); the port's kernel is f64 and
does n*R work, so there is no gate. int64 SUMs and MIN/MAX stay scatters
(``index_add_``/``scatter_reduce_``), as the reference keeps them on
scatters: integer adds and min/max give the same result in any order.
"""

from __future__ import annotations

import dataclasses
from enum import Enum

import torch

from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops import onehot_agg, prefix_sum
from ballista_tpu_torch.ops.perm import multi_key_perm, take_batch, take_many_split


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
    # device bools of the clustered-input speculation (exec/aggregate.py):
    # ``input_was_sorted`` says whether the rows came grouped-adjacent
    # already (a sort-path run reads it off the stable sort's permutation);
    # ``sorted_ok`` validates a presorted run (None on the sort path)
    input_was_sorted: torch.Tensor | None = None
    sorted_ok: torch.Tensor | None = None


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
    rid: torch.Tensor, capacity: int, vals: list, lives: list, live_of: list,
    ops: tuple,
) -> tuple[list, list]:
    """Every value reduction into ``capacity`` slots keyed by ``rid``
    (int32, ``capacity`` = dropped). Column i's live mask is
    ``lives[live_of[i]]``; ``lives`` holds each distinct mask once, and the
    columns that share one share its count row. Per-column NULL masks are
    folded into the contribution (SUM adds 0, MIN/MAX add their identity),
    so columns share one pass; the non-null count matrix doubles as COUNT
    output and the SQL all-NULL flags."""
    m = len(vals)
    out_vals: list = [None] * m
    out_val_nulls: list = [None] * m
    if m == 0:
        return out_vals, out_val_nulls
    idx = rid.long()
    f64_sums: list[tuple[int, torch.Tensor]] = []
    groups: dict[tuple[str, torch.dtype], list] = {}
    for i, (vc, op) in enumerate(zip(vals, ops)):
        if op == AggOp.COUNT:
            continue
        live = lives[live_of[i]]
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
    # one call (per MAX_ROWS rows) covers the count matrix and every f64
    # sum: each distinct live mask once as a 0/1 row (exact in f64), then
    # the f64 contributions
    rows = [l.to(torch.float64) for l in lives] + [c for _, c in f64_sums]
    step = onehot_agg.MAX_ROWS
    sums = torch.cat(
        [
            onehot_agg.onehot_sums(rid, torch.stack(rows[k : k + step]), capacity)
            for k in range(0, len(rows), step)
        ],
        dim=1,
    )
    nonnull = sums[:, list(live_of)].round().to(torch.int64)
    for j, (i, _) in enumerate(f64_sums):
        out_vals[i] = sums[:, len(lives) + j]
    for i, op in enumerate(ops):
        if op == AggOp.COUNT:
            out_vals[i] = nonnull[:, i]
        else:
            out_val_nulls[i] = nonnull[:, i] == 0  # agg over no values: NULL
    for (kind, dt), entries in groups.items():
        stacked = torch.stack([c for _, c in entries], dim=1)
        if kind == "add":
            # integer sums only (``_sum_dtype``: int64): the f64 ones took
            # the one-hot kernel above, as a scatter of floats on the card
            # adds in no fixed order
            res = torch.zeros(
                capacity + 1, len(entries), dtype=torch.int64, device=rid.device
            ).index_add_(0, idx, stacked)[:capacity]
        else:
            res = _scatter_minmax(idx, capacity, stacked, kind)
        for j, (i, _) in enumerate(entries):
            out_vals[i] = res[:, j]
    return out_vals, out_val_nulls


# -- the sort-based path -------------------------------------------------------
#
# After the group sort, rows of one group are adjacent, so no reduction
# needs a hash table:
#
#   sum[g]   = prefix(contrib)[end_g] - prefix(contrib)[start_g - 1]
#   count[g] = the same over the live flag
#   keys[g]  = key columns gathered at start_g
#
# Segment starts come from one scatter-min of the row index. Dead rows
# (all at the tail after the sort) add nothing to any prefix, so the prefix
# just before one segment's start is the prefix at the previous segment's
# end, and no end positions are needed. MIN/MAX keep a scatter. The
# reference builds its f64 prefix on the TPU from blocked triangular
# matmuls (``_mm_prefix``), a compile-time workaround that also fixes the
# order of adds; here it is the fixed-order kernel ``ops/prefix_sum.py``
# (int64 and counts: exact integer cumsums). An f64
# prefix difference rounds like another summation order: its error is
# relative to the running prefix, not to the group's sum, as in the
# reference. Sums that must be exact go through the operator's decimal
# scaling (``exec/aggregate._dec_scaled_sums``), which makes them int64.


def _same_val(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SQL group equality: NaN == NaN is one group; -0.0 == +0.0."""
    same = a == b
    if a.dtype.is_floating_point:
        same = same | (torch.isnan(a) & torch.isnan(b))
    return same


def _gt_val(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sort-order 'greater': NaN sorts after every number."""
    if a.dtype.is_floating_point:
        return (a > b) | (torch.isnan(a) & ~torch.isnan(b))
    return a > b


def _ffill_tuple(vals: tuple, flag: torch.Tensor) -> tuple[tuple, torch.Tensor]:
    """Forward-fill ``vals`` from the last flagged row at or before each
    row: (filled values, filled flag). The reference doubles
    Hillis-Steele style; here the source row is a running max of the
    flagged row indices, which picks the same row."""
    n = flag.shape[0]
    iota = torch.arange(n, device=flag.device)
    src = torch.cummax(torch.where(flag, iota, -1), dim=0).values
    filled = src >= 0
    at = src.clamp(min=0)
    return tuple(torch.where(filled, v[at], v) for v in vals), filled


def _seg_layouts(val_dtypes: tuple, null_sig: tuple, ops: tuple):
    """Which live-count prefix serves each column (columns without nulls
    share one), how SUM columns stack per accumulator dtype, and which
    columns reduce by scatter-min/max."""
    live_keys: list[int] = []
    live_index: dict[int, int] = {}
    for i, has_null in enumerate(null_sig):
        k = i if has_null else -1
        if k not in live_index:
            live_index[k] = len(live_keys)
            live_keys.append(k)
    sum_groups: dict[torch.dtype, list[int]] = {}
    mm_idx: list[int] = []
    for i, (dt, op) in enumerate(zip(val_dtypes, ops)):
        if op == AggOp.SUM:
            sum_groups.setdefault(_sum_dtype(dt), []).append(i)
        elif op in (AggOp.MIN, AggOp.MAX):
            mm_idx.append(i)
    sum_layout = tuple((dt, tuple(idxs)) for dt, idxs in sum_groups.items())
    return sum_layout, tuple(live_keys), tuple(mm_idx)


def _column_cumsums(cols: list) -> torch.Tensor:
    """Prefix sums of equal-length columns, as the columns of one (n, k)
    tensor. Float columns take ``prefix_sum.prefix_sums`` (one launch
    sequence for all k, in an order of adds fixed by n, so an f64 SUM is
    bit-reproducible); integer columns are scanned each on its own by
    ``torch.cumsum``, exact in any order (a cumsum down dim 0 of an
    (n, k>1) tensor was so slow on an H100 that q8 took 1.7 s a warm run
    at SF=1, and 0.035-0.050 s scanning each column alone)."""
    if cols[0].dtype.is_floating_point:
        return prefix_sum.prefix_sums(torch.stack(cols, dim=0)).T
    return torch.stack([torch.cumsum(c, 0, dtype=torch.int64) for c in cols], dim=1)


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """``x`` moved one row down, a zero (False) in the first row."""
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device), x[:-1]])


def _seg_part1(
    valid, key_cols, key_nulls, val_cols, val_nulls, perm, ops, capacity,
    clustered, sum_layout, live_layout, mm_idx,
):
    """Segment starts, running sums and MIN/MAX.

    ``clustered=False``: the operands are SORTED (live rows first, groups
    adjacent); ``perm`` is the stable sort's permutation, read only for
    ``input_was_sorted`` (its live prefix strictly increasing means the
    input was grouped-adjacent already: the learning signal of the
    presorted path).

    ``clustered=True``: the operands are in their original order,
    speculated to be grouped-adjacent among live rows (dead rows
    anywhere). A row's group boundary compares it with the previous LIVE
    row (a forward fill), and ``sorted_ok`` says whether the speculation
    held. The prefixes' inputs are then moved live rows first, in order
    (one scatter a column, no sort): where the speculation holds that is
    the sequence the sort path's prefixes read, so the f64 sums, whose
    fixed order of adds depends on the positions, come out with the sort
    path's bits. (The reference's arm leaves dead rows in place as zeros;
    its sequential CPU cumsum does not see the difference.)

    Returns (n_groups, overflow, input_was_sorted, sorted_ok, segment
    starts in the prefixes' rows, count prefixes, sum prefixes, MIN/MAX
    values, segment starts in the key columns' rows)."""
    n = valid.shape[0]
    dev = valid.device
    iota = torch.arange(n, device=dev)
    # the group identity of a key: (null flag, zeroed value)
    zkeys = [kc if kn is None else torch.where(kn, torch.zeros_like(kc), kc)
             for kc, kn in zip(key_cols, key_nulls)]
    input_was_sorted = sorted_ok = None
    if clustered:
        flags = [kn for kn in key_nulls if kn is not None]
        filled, filled_live = _ffill_tuple(tuple(zkeys) + tuple(flags), valid)
        # shift to the strictly previous live row
        prev_z = [_shift_down(z) for z in filled[: len(zkeys)]]
        prev_f = iter(_shift_down(f) for f in filled[len(zkeys):])
        prev_flags = [None if kn is None else next(prev_f) for kn in key_nulls]
        prev_live = _shift_down(filled_live)
        same = torch.ones(n, dtype=torch.bool, device=dev)
        greater = torch.zeros(n, dtype=torch.bool, device=dev)
        eq_chain = torch.ones(n, dtype=torch.bool, device=dev)
        for z, pz, f, pf in zip(zkeys, prev_z, key_nulls, prev_flags):
            if f is not None:
                # null flags sort nulls last: the previous row is greater
                # when it is null and this one is not
                pair_same = (f == pf) & _same_val(z, pz)
                pair_gt = (pf & ~f) | ((f == pf) & _gt_val(pz, z))
            else:
                pair_same = _same_val(z, pz)
                pair_gt = _gt_val(pz, z)
            same = same & pair_same
            greater = greater | (eq_chain & pair_gt)
            eq_chain = eq_chain & pair_same
        changed = valid & (~prev_live | ~same)
        sorted_ok = ~(valid & prev_live & greater).any()
        rank = torch.cumsum(valid.to(torch.int64), 0) - 1
        dest = torch.where(valid, rank, n)

        def to_front(x: torch.Tensor) -> torch.Tensor:
            return torch.zeros(n + 1, dtype=x.dtype, device=dev).scatter_(0, dest, x)[:n]
    else:
        head = torch.ones(1, dtype=torch.bool, device=dev)
        changed = torch.zeros(n, dtype=torch.bool, device=dev)
        changed[0] = True
        for z, kn in zip(zkeys, key_nulls):
            if kn is not None:
                changed = changed | torch.cat([head, kn[1:] != kn[:-1]])
            changed = changed | torch.cat([head, ~_same_val(z[1:], z[:-1])])
        changed = changed & valid
        if perm is not None:
            n_live = valid.sum()
            input_was_sorted = ((perm[1:] > perm[:-1]) | (iota[1:] >= n_live)).all()
        rank = iota

        def to_front(x: torch.Tensor) -> torch.Tensor:
            return x

    seg = torch.cumsum(changed.to(torch.int32), 0) - 1
    n_groups = changed.sum(dtype=torch.int32)
    overflow = n_groups > capacity
    # dead rows and segments past the capacity land in a spare slot, cut
    sid = torch.where(valid & (seg < capacity), seg, capacity)
    # segment starts: each segment's first row is the one row that changed
    # into it, so a plain scatter of those rows gives the reference's
    # scatter-min without a contended atomic per row
    at = torch.where(changed, sid, capacity)
    key_ps = torch.full((capacity + 1,), n, dtype=torch.int64, device=dev).scatter_(0, at, iota)[:capacity]
    ps = key_ps if rank is iota else (
        torch.full((capacity + 1,), n, dtype=torch.int64, device=dev).scatter_(0, at, rank)[:capacity]
    )

    lives = [valid if vn is None else (valid & ~vn) for vn in val_nulls]
    # one live-count prefix per distinct live mask; a key-only aggregate
    # (DISTINCT, the SEMI-join dedup) has no value column: one dummy row
    cnt_cs = _column_cumsums(
        [to_front((valid if k == -1 else lives[k]).to(torch.int32)) for k in live_layout]
        or [torch.zeros(n, dtype=torch.int32, device=dev)]
    )

    sum_cs = []
    for dt, idxs in sum_layout:
        contribs = [
            to_front(torch.where(lives[i], val_cols[i], torch.zeros_like(val_cols[i])).to(dt))
            for i in idxs
        ]
        sum_cs.append(_column_cumsums(contribs))
    mm_vals = []
    for i in mm_idx:
        vc, live = val_cols[i], lives[i]
        kind = "amin" if ops[i] == AggOp.MIN else "amax"
        ident = (_max_ident if kind == "amin" else _min_ident)(vc.dtype)
        masked = torch.where(live, vc, ident).unsqueeze(1)
        mm_vals.append(_scatter_minmax(sid, capacity, masked, kind)[:, 0])
    return n_groups, overflow, input_was_sorted, sorted_ok, ps, cnt_cs, sum_cs, mm_vals, key_ps


def _seg_part2(
    n_groups, ps, cnt_cs, sum_cs, mm_vals, key_cols, key_nulls, ops, capacity,
    sum_layout, live_layout, mm_idx, key_ps,
) -> GroupAggResult:
    """Per-group totals from one gather of each prefix at the segment
    starts: ``pre[g] = cs[ps_g - 1]`` (0 when ``ps_g == 0``), and since
    dead rows add nothing, ``pre[g + 1]`` is the prefix at segment g's end;
    the last live group closes with the grand total ``cs[n - 1]``. The
    keys are gathered at ``key_ps``, the starts in the key columns' rows."""
    n = cnt_cs.shape[0]
    dev = ps.device
    slot = torch.arange(capacity, dtype=torch.int32, device=dev)
    out_valid = slot < n_groups
    ps_c = ps.clamp(0, n - 1)
    ps_prev = (ps_c - 1).clamp(0, n - 1)
    is_last = (slot == n_groups - 1).unsqueeze(1)
    has_pre = (ps > 0).unsqueeze(1)

    def seg_totals(cs2d):
        pre = torch.where(has_pre, cs2d[ps_prev], torch.zeros_like(cs2d[:1]))
        nxt = torch.cat([pre[1:], pre[-1:]])
        nxt = torch.where(is_last, cs2d[n - 1].unsqueeze(0), nxt)
        return nxt - pre

    cnt_tot = seg_totals(cnt_cs)
    live_slot = {k: j for j, k in enumerate(live_layout)}
    sum_tots = [seg_totals(cs2d) for cs2d in sum_cs]
    sum_slot: dict[int, tuple[int, int]] = {}
    for gi, (_, idxs) in enumerate(sum_layout):
        for j, i in enumerate(idxs):
            sum_slot[i] = (gi, j)
    mm_map = dict(zip(mm_idx, mm_vals))

    m = len(ops)
    out_vals: list = [None] * m
    out_val_nulls: list = [None] * m
    for i, op in enumerate(ops):
        nonnull = cnt_tot[:, live_slot[i if i in live_slot else -1]].to(torch.int64)
        if op == AggOp.COUNT:
            out_vals[i] = torch.where(out_valid, nonnull, 0)
            continue
        out_val_nulls[i] = nonnull == 0
        if op == AggOp.SUM:
            gi, j = sum_slot[i]
            out_vals[i] = sum_tots[gi][:, j]
        else:
            out_vals[i] = mm_map[i]

    # group keys: the first row of each segment is live and carries them
    gathered, gathered_nulls = take_many_split(
        list(key_cols), list(key_nulls), ps_c if key_ps is ps else key_ps.clamp(0, n - 1)
    )
    out_keys = [torch.where(out_valid, k, torch.zeros_like(k)) for k in gathered]
    out_key_nulls = [None if kn is None else kn & out_valid for kn in gathered_nulls]
    return GroupAggResult(
        keys=out_keys,
        key_nulls=out_key_nulls,
        values=out_vals,
        value_nulls=out_val_nulls,
        valid=out_valid,
        n_groups=n_groups,
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )


def _segment_aggregate(
    valid, key_cols, key_nulls, val_cols, val_nulls, perm, ops, capacity, clustered
) -> GroupAggResult:
    """The two-part segment reduction (see ``_seg_part1``)."""
    layouts = _seg_layouts(
        tuple(v.dtype for v in val_cols),
        tuple(vn is not None for vn in val_nulls),
        tuple(ops),
    )
    n_groups, overflow, was_sorted, sorted_ok, ps, cnt_cs, sum_cs, mm_vals, key_ps = _seg_part1(
        valid, key_cols, key_nulls, val_cols, val_nulls, perm, ops, capacity,
        clustered, *layouts,
    )
    res = _seg_part2(
        n_groups, ps, cnt_cs, sum_cs, mm_vals, key_cols, key_nulls, ops,
        capacity, *layouts, key_ps,
    )
    res.overflow = overflow
    res.input_was_sorted = was_sorted
    res.sorted_ok = sorted_ok
    return res


def group_aggregate(
    key_cols: list[torch.Tensor],
    key_nulls: list[torch.Tensor | None],
    valid: torch.Tensor,
    val_cols: list[torch.Tensor],
    val_nulls: list[torch.Tensor | None],
    ops: list[AggOp],
    capacity: int,
    presorted: bool = False,
) -> GroupAggResult:
    """Aggregate ``val_cols[i]`` with ``ops[i]`` grouped by ``key_cols``.

    All inputs share one row axis; ``valid`` masks live rows. Outputs have
    length ``capacity``, live groups first in key order; ``overflow`` is
    set when there are more groups than ``capacity`` (the groups past it
    are dropped, so the caller must not use the result then).

    ``presorted=False``: the keys' stable sort and one stacked gather, then
    the segment finisher; ``input_was_sorted`` says (at no extra cost, off
    the sort's permutation) whether the sort was needed. ``presorted=True``:
    no sort and no gather; the live rows are speculated to be
    grouped-adjacent in key order (TPC-H lineitem grouped by l_orderkey),
    and the caller must validate ``sorted_ok`` (deferred speculation)."""
    if presorted:
        return _segment_aggregate(
            valid, key_cols, key_nulls, val_cols, val_nulls, None, tuple(ops),
            capacity, clustered=True,
        )
    # valid rows first; a null key sorts by its flag, then a zeroed value,
    # so all of a key's nulls compare equal
    passes: list[tuple[torch.Tensor, bool]] = [(~valid, False)]
    for kc, kn in zip(key_cols, key_nulls):
        if kn is not None:
            passes.append((kn, False))
            passes.append((torch.where(kn, torch.zeros_like(kc), kc), False))
        else:
            passes.append((kc, False))
    perm = multi_key_perm(passes)
    s_cols, s_nulls, s_valid = take_batch(
        list(key_cols) + list(val_cols), list(key_nulls) + list(val_nulls), valid, perm
    )
    nk = len(key_cols)
    return _segment_aggregate(
        s_valid, s_cols[:nk], s_nulls[:nk], s_cols[nk:], s_nulls[nk:], perm, tuple(ops),
        capacity, clustered=False,
    )


# Dense slots grow as prod(vocab+1); past this the reference takes its
# sort-based path. The kernel takes every dense slot count.
DENSE_AGG_MAX_SLOTS = onehot_agg.MAX_SLOTS


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

    # one live mask per distinct null mask (None: ``valid`` itself)
    masks: list = []
    lives: list[torch.Tensor] = []
    live_of: list[int] = []
    for vn in val_nulls:
        at = next((k for k, mk in enumerate(masks) if mk is vn), None)
        if at is None:
            at = len(masks)
            masks.append(vn)
            lives.append(valid if vn is None else (valid & ~vn))
        live_of.append(at)
    out_vals, out_val_nulls = _stacked_reduce(
        rid_all, P, list(val_cols), lives, live_of, tuple(ops)
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
