"""Window operator: ranking, aggregates over frames, and LAG/LEAD (port of
``ballista_tpu/exec/window.py``).

The rows are sorted by (partition keys, order keys) with the port's sort
(``ops/sort.py``); each window function's output column is computed on the
sorted rows and scattered back to the original row positions through the
permutation, so the operator appends columns without reordering its input.
Window expressions with identical sort keys share one sort.

Aggregates over frames reduce by prefix sums, not per-row loops: on the
sorted rows the sum over a row window [lo, hi] is cs[hi] - cs[lo - 1].
The prefix sums restart at each window partition (a segmented
Hillis-Steele doubling scan, where the reference takes one prefix over the
whole batch): a difference of two prefixes then loses digits only to its
partition's total, not to the running total of the batch (about 2e11 for
1.5M order prices), and the card and the CPU add in the same order, so
they agree bit for bit. ROWS frames clamp per-row bounds to the partition;
RANGE frames snap to peer-group edges. MIN/MAX over running frames use the
same doubling scan; bounded ROWS frames for MIN/MAX are rejected (no
prefix trick exists), as in the reference. The operator gathers every
input partition into one batch (a partition of the window must be in one
place); on a mesh, ``exec/mesh.MeshWindowExec`` runs
``append_window_columns`` on each shard after an exchange by the
PARTITION BY keys.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, UnknownPartitioning
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.ops.aggregate import _max_ident, _min_ident
from ballista_tpu_torch.ops.concat import concat_batches
from ballista_tpu_torch.ops.sort import SortKey, sort_perm


def _first_true(cap: int, dev) -> torch.Tensor:
    out = torch.zeros(cap, dtype=torch.bool, device=dev)
    out[0] = True
    return out


def _changed_of(cols, nulls, cap: int, dev) -> torch.Tensor:
    """Row i starts a new run of the sorted key tuple (row 0 always):
    values compare with NULLs zeroed, and the null masks compare too."""
    changed = _first_true(cap, dev)
    for col, nm in zip(cols, nulls):
        zc = col if nm is None else torch.where(nm, torch.zeros_like(col), col)
        changed[1:] |= zc[1:] != zc[:-1]
        if nm is not None:
            changed[1:] |= nm[1:] != nm[:-1]
    return changed


def _region_edges(changed: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row start and end (inclusive) of the region the row is in, given
    boundary markers (row 0 always marked): the marked rows, in order, are
    the region starts, and a region ends one row before the next start.
    The reference takes a running max and a reversed running min; on an
    H100 a ``torch.cummax`` over 2^23 rows took about 22 ms."""
    dev = changed.device
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    region = torch.cumsum(changed.to(torch.int32), 0) - 1
    starts = torch.sort(torch.where(changed, idx, cap)).values
    starts = torch.cat([starts, torch.full((1,), cap, dtype=torch.int32, device=dev)])
    return starts[region], starts[region + 1] - 1


def _seg_scan(v: torch.Tensor, ps: torch.Tensor, op) -> torch.Tensor:
    """Segmented inclusive scan of ``op`` by Hillis-Steele doubling: after
    step k a row holds ``op`` over the 2^(k+1) rows ending at it, cut at
    its partition's start ``ps``. A fixed order of operations, the same on
    every device."""
    cap = v.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=v.device)
    for k in range(max(1, (cap - 1).bit_length())):
        off = 1 << k
        v = torch.where(idx - off >= ps, op(v, torch.roll(v, off)), v)
    return v


def _seg_running_minmax(v: torch.Tensor, ps: torch.Tensor, is_min: bool) -> torch.Tensor:
    """Segmented prefix min/max (NaN propagates, as in the reference)."""
    return _seg_scan(v, ps, torch.minimum if is_min else torch.maximum)


def _unsort(vals: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Back to the original row order: out[perm[i]] = vals[i]."""
    out = torch.zeros_like(vals)
    out[perm] = vals
    return out


def _rank(fname: str, part_pairs, order_pairs, perm: torch.Tensor, cap: int) -> torch.Tensor:
    """row_number / rank / dense_rank on the sorted keys, at original row
    positions (int64)."""
    dev = perm.device
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    part_changed = (
        _changed_of([c for c, _ in part_pairs], [m for _, m in part_pairs], cap, dev)
        if part_pairs else _first_true(cap, dev)
    )
    order_changed = (
        _changed_of([c for c, _ in order_pairs], [m for _, m in order_pairs], cap, dev)
        if order_pairs else torch.zeros(cap, dtype=torch.bool, device=dev)
    )
    start, _ = _region_edges(part_changed, cap)
    if fname == "row_number":
        vals = idx - start + 1
    elif fname == "rank":
        peer_start, _ = _region_edges(part_changed | order_changed, cap)
        vals = peer_start.to(torch.int64) - start + 1
    else:  # dense_rank: peer groups counted from the partition's start
        dr = torch.cumsum((part_changed | order_changed).to(torch.int64), 0)
        vals = dr - dr[start.long()] + 1
    return _unsort(vals, perm)


def _agg_window(
    fname: str, frame_key, part_pairs, order_pairs, arg: torch.Tensor,
    arg_nmask: torch.Tensor | None, valid_sorted: torch.Tensor, perm: torch.Tensor,
    offset: int, out_dtype: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Aggregate / lag / lead on the sorted rows: the output column and its
    null mask at original row positions."""
    cap, dev = arg.shape[0], arg.device
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    part_changed = _changed_of(
        [c for c, _ in part_pairs], [m for _, m in part_pairs], cap, dev
    )
    # the dead tail (invalid rows sort last) is a region of its own, so no
    # live frame reaches into it; dead outputs are masked anyway
    part_changed[1:] |= valid_sorted[1:] != valid_sorted[:-1]
    ps, pe = _region_edges(part_changed, cap)
    live = valid_sorted if arg_nmask is None else valid_sorted & ~arg_nmask

    if fname in ("lag", "lead"):
        src = idx - offset if fname == "lag" else idx + offset
        ok = (src >= ps) & (src <= pe) & valid_sorted
        srcc = src.clamp(0, cap - 1).long()
        vals = arg[srcc]
        nulls = ~ok
        if arg_nmask is not None:
            nulls = nulls | arg_nmask[srcc]
        out_vals = torch.where(nulls, torch.zeros_like(vals), vals)
        return _unsort(out_vals, perm), _unsort(nulls, perm)

    def peer_edges():
        peer_changed = part_changed | _changed_of(
            [c for c, _ in order_pairs], [m for _, m in order_pairs], cap, dev
        )
        return _region_edges(peer_changed, cap)

    # frame bounds [lo, hi] in sorted row space
    if frame_key is None:
        if order_pairs:
            # SQL's default: RANGE UNBOUNDED PRECEDING .. CURRENT ROW
            _, peer_end = peer_edges()
            lo, hi = ps, torch.minimum(peer_end, pe)
        else:
            lo, hi = ps, pe
    else:
        units, st, sn, et, en = frame_key
        if units == "rows":
            lo = {
                "up": lambda: ps,
                "p": lambda: torch.maximum(idx - sn, ps),
                "cur": lambda: idx,
                "f": lambda: torch.minimum(idx + sn, pe + 1),
            }[st]()
            hi = {
                "p": lambda: torch.maximum(idx - en, ps - 1),
                "cur": lambda: idx,
                "f": lambda: torch.minimum(idx + en, pe),
                "uf": lambda: pe,
            }[et]()
        else:  # range, at peer-group granularity (offsets rejected at plan time)
            peer_start, peer_end = peer_edges()
            lo = ps if st == "up" else peer_start
            hi = pe if et == "uf" else torch.minimum(peer_end, pe)

    # live rows from the partition's start up to each row
    cnt_cs = _seg_scan(live.to(torch.int64), ps, torch.add)
    hi_c = hi.clamp(0, cap - 1).long()
    nulls: torch.Tensor | None
    if fname in ("sum", "avg", "count"):
        acc_t = torch.float64 if arg.dtype.is_floating_point or fname == "avg" else torch.int64
        contrib = torch.where(live, arg, torch.zeros_like(arg)).to(acc_t)
        # prefixes that restart at each partition: a frame's sum subtracts
        # the prefix before its first row only when that row is in the
        # partition too
        cs = _seg_scan(contrib, ps, torch.add)
        lo_prev = (lo - 1).clamp(0, cap - 1).long()
        nonempty = hi >= lo

        def seg(cs1d: torch.Tensor) -> torch.Tensor:
            zero = torch.zeros((), dtype=cs1d.dtype, device=dev)
            pre = torch.where(lo > ps, cs1d[lo_prev], zero)
            return torch.where(nonempty, cs1d[hi_c] - pre, zero)

        cnt = seg(cnt_cs)
        if fname == "count":
            vals, nulls = cnt, None
        elif fname == "avg":
            vals = seg(cs) / cnt.clamp(min=1).to(torch.float64)
            nulls = cnt == 0
        else:
            vals, nulls = seg(cs), cnt == 0
    else:
        # min / max: frames start at UNBOUNDED PRECEDING (checked at plan
        # time), so the running scan's value at the frame's last row is the
        # frame's reduction
        ident = _max_ident(arg.dtype) if fname == "min" else _min_ident(arg.dtype)
        masked = torch.where(live, arg, torch.full_like(arg, ident))
        run = _seg_running_minmax(masked, ps, fname == "min")
        vals = run[hi_c]
        # an empty frame (an end bound of N PRECEDING before the partition
        # start) or one with no live rows is NULL
        nulls = (hi < ps) | (cnt_cs[hi_c] == 0)
        vals = torch.where(nulls, torch.zeros_like(vals), vals)

    out_vals = _unsort(vals.to(out_dtype), perm)
    return out_vals, None if nulls is None else _unsort(nulls, perm)


class WindowExec(ExecutionPlan):
    """Appends one column per window expression. Gathers every input
    partition (a window partition needs all its rows in one place), so its
    output partitioning is 1."""

    def __init__(self, input: ExecutionPlan, window_exprs, names) -> None:
        super().__init__()
        self.input = input
        self.window_exprs = list(window_exprs)
        self.names = list(names)
        ins = input.schema()
        self._schema = Schema(
            list(ins.fields)
            + [
                Field(n, w.data_type(ins), w.nullable(ins))
                for n, w in zip(self.names, self.window_exprs)
            ]
        )
        # key columns resolve now (the planner guarantees column refs);
        # nulls_first defaults to the engine's sort convention (FIRST for
        # DESC, LAST for ASC)
        self._keys: list[tuple[tuple[int, ...], tuple[SortKey, ...]]] = []
        self._args: list[int | None] = []  # argument column; -1 = literal
        self._arg_lits: list = []
        for w in self.window_exprs:
            for e in list(w.partition_by) + [e for e, _, _ in w.order_by]:
                if not isinstance(e, L.Column):
                    raise PlanError(
                        "window PARTITION BY / ORDER BY must be columns "
                        "(project expressions first)"
                    )
            if w.arg is None:
                self._args.append(None)
                self._arg_lits.append(None)
            elif isinstance(w.arg, L.Column):
                ai = L.resolve_field_index(ins, w.arg.cname)
                if ins.fields[ai].dtype == DataType.STRING:
                    raise PlanError(
                        "window functions over STRING columns are not supported yet"
                    )
                self._args.append(ai)
                self._arg_lits.append(None)
            elif isinstance(w.arg, L.Literal):
                if not isinstance(w.arg.value, (int, float, bool)):
                    raise PlanError("window function literal arguments must be numeric")
                self._args.append(-1)
                self._arg_lits.append(w.arg)
            else:
                raise PlanError(
                    "window function arguments must be columns "
                    "(project expressions first)"
                )
            fr = w.frame
            if fr is not None:
                if fr.units == "range" and (
                    fr.start_type in ("p", "f") or fr.end_type in ("p", "f")
                ):
                    raise PlanError(
                        "RANGE frames with numeric offsets are not supported (use ROWS)"
                    )
                if w.fname in ("min", "max") and fr.start_type != "up":
                    raise PlanError(
                        "MIN/MAX window frames must start at UNBOUNDED "
                        "PRECEDING (no prefix trick for sliding frames)"
                    )
            self._keys.append(
                (
                    tuple(L.resolve_field_index(ins, e.cname) for e in w.partition_by),
                    tuple(
                        SortKey(
                            col=L.resolve_field_index(ins, e.cname),
                            ascending=asc,
                            nulls_first=(nf if nf is not None else not asc),
                        )
                        for e, asc, nf in w.order_by
                    ),
                )
            )

    def schema(self) -> Schema:
        return self._schema

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def output_partitioning(self):
        return UnknownPartitioning(1)

    def describe(self) -> str:
        return "WindowExec: " + ", ".join(
            f"{n} = {w.name()}" for n, w in zip(self.names, self.window_exprs)
        )

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        batches = []
        for p in range(self.input.output_partitioning().n):
            batches.extend(self.input.execute(p, ctx))
        if not batches:
            return
        b = concat_batches(batches) if len(batches) > 1 else batches[0]
        out_cols, out_nulls = self.append_window_columns(b)
        yield DeviceBatch(
            schema=self._schema,
            columns=tuple(out_cols),
            valid=b.valid,
            nulls=tuple(out_nulls),
            dictionaries=dict(b.dictionaries),
        )

    def append_window_columns(self, b: DeviceBatch):
        """Input batch -> (its columns and the window columns, null masks)."""
        out_cols = list(b.columns)
        out_nulls = list(b.nulls)
        perms: dict = {}  # one sort per distinct key set
        for w, (pk, ok), argi, arg_lit, field in zip(
            self.window_exprs, self._keys, self._args, self._arg_lits,
            self._schema.fields[len(b.schema):],
        ):
            sk = tuple(SortKey(col=i, ascending=True) for i in pk) + ok
            perm = perms.get(sk)
            if perm is None:
                with self.metrics.time("sort_time"):
                    perm = sort_perm(b, list(sk))
                perms[sk] = perm

            def gathered(i):
                m = b.nulls[i]
                return b.columns[i][perm], None if m is None else m[perm]

            part_pairs = [gathered(i) for i in pk]
            order_pairs = [gathered(k.col) for k in ok]
            if w.fname in ("row_number", "rank", "dense_rank"):
                with self.metrics.time("rank_time"):
                    out_cols.append(_rank(w.fname, part_pairs, order_pairs, perm, b.capacity))
                out_nulls.append(None)
                continue
            if argi == -1:  # a literal argument (COUNT(*) counts frame rows)
                v = arg_lit.value
                arg_col = torch.full(
                    (b.capacity,), v, dtype=torch.from_numpy(np.asarray(v)).dtype,
                    device=b.device,
                )
                arg_null = None
            else:
                arg_col, arg_null = gathered(argi)
            frame_key = (
                None
                if w.frame is None
                else (
                    w.frame.units, w.frame.start_type, w.frame.start_n,
                    w.frame.end_type, w.frame.end_n,
                )
            )
            with self.metrics.time("rank_time"):
                vals, nulls = _agg_window(
                    w.fname, frame_key, part_pairs, order_pairs, arg_col, arg_null,
                    b.valid[perm], perm, w.offset, field.dtype.to_torch(),
                )
            out_cols.append(vals)
            out_nulls.append(nulls)
        return out_cols, out_nulls
