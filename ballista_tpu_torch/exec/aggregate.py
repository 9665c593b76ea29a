"""Hash-aggregate operator, partial and final (port of
``ballista_tpu/exec/aggregate.py``).

Per input batch the partial aggregate produces a state batch (group keys
then one column per state slot); the final aggregate concatenates the
partial states and merges them with the merge ops (COUNT merges by SUM;
AVG decomposes into SUM + COUNT slots). Three paths, as in the reference:
the dense path for dictionary-coded or boolean group keys (TPC-H q1, q4,
q5; its reductions run the one-hot group-sum kernel), the sort-based path
for every other GROUP BY (q3, q10, q18, DISTINCT and the SEMI-join dedup),
and the scalar path for aggregates with no GROUP BY (q6).

On the sort path, f64 SUM inputs that are decimals (TPC-H money and
quantities) are summed exactly as int64 at a scale learned through the
plan cache (``_dec_scaled_sums``). Groups past the capacity
(``ballista.tpu.agg_capacity``, or the retry's grown one) raise a
CapacityError at the task boundary, and the run is retried.

Not ported yet (ROADMAP queue 1, item 4; none changes a result): the
clustered-input speculation that skips the sort, the disjoint-clustered
partial path and the learned state slicing (``_slice_states``).

Under a device-memory budget (``ballista.tpu.hbm_budget_mb``) the final
aggregate collects its partial states incrementally and, once they cross
the budget, hash-spills them by group key to host Arrow IPC buckets and
merges them bucket range by bucket range (``_grace_merge``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, UnknownPartitioning
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.ops.aggregate import (
    DENSE_AGG_MAX_SLOTS,
    AggOp,
    GroupAggResult,
    dense_group_aggregate,
    group_aggregate,
    scalar_aggregate,
)
from ballista_tpu_torch.ops.concat import concat_batches

_SCALAR_CAP = 2048  # capacity of a one-row scalar state, as in the reference

# -- exact decimal summation (see HashAggregateExec._dec_scaled_sums) --------
# Integrality tolerance: a true decimal's f64 value deviates from integral
# (at its scale) by about |v| * 10^k * 2^-52, ~1e-5 at TPC-H magnitudes;
# arbitrary floats deviate up to 0.5.
_DEC_TOL = 1e-3
# Magnitude bound: scaled |values| must sum below f64's exact-integer range
# (with margin) so that every reduction order gives the same integer.
_DEC_BOUND = float(1 << 52)


def _dec_live(valid: torch.Tensor, null: torch.Tensor | None) -> torch.Tensor:
    return valid if null is None else valid & ~null


def _dec_check(col: torch.Tensor, live: torch.Tensor, k: int):
    """(rounded values at scale 10^k, device bool: every live value is
    integral there and their magnitudes sum below the bound)."""
    s = col * float(10 ** k)
    r = torch.round(s)
    zero = torch.zeros((), dtype=col.dtype, device=col.device)
    dev = torch.where(live, (s - r).abs(), zero).max()
    total = torch.where(live, r.abs(), zero).sum()
    return r, (dev <= _DEC_TOL) & (total < _DEC_BOUND)


def _dec_learn(col: torch.Tensor, valid: torch.Tensor, null: torch.Tensor | None):
    """The smallest scale k in {2, 4, 6} at which every live value is
    integral and the sum stays exact, as a device int32; 99 means not a
    decimal (defer_learn's max over batches then vetoes)."""
    live = _dec_live(valid, null)
    code = torch.full((), 99, dtype=torch.int32, device=col.device)
    for k in (6, 4, 2):  # big to small, so the smallest that holds wins
        _, ok = _dec_check(col, live, k)
        code = torch.where(ok, k, code)
    return code


def _dec_scale(col: torch.Tensor, valid: torch.Tensor, null: torch.Tensor | None, k: int):
    """(the column scaled to an int64 count of 10^-k units, device bool:
    the scale still holds). int64 sums are exact in any order."""
    live = _dec_live(valid, null)
    r, ok = _dec_check(col, live, k)
    return torch.where(live, r, 0.0).to(torch.int64), ok


def _dec_pick(col: torch.Tensor, valid: torch.Tensor, null: torch.Tensor | None):
    """For a run that does not know a slot's scale yet: (its learned code,
    as ``_dec_learn``; the column scaled to int64 at that scale, zero where
    it is not a decimal; the reciprocal that takes the int64 sums back).
    The scale is chosen on the device, so the run sums exactly without
    waiting for the host."""
    live = _dec_live(valid, null)
    code = _dec_learn(col, valid, null)
    scale = torch.full((), 10.0**6, dtype=torch.float64, device=col.device)
    recip = torch.full((), 1.0 / 10**6, dtype=torch.float64, device=col.device)
    for k in (4, 2):
        scale = torch.where(code == k, 10.0**k, scale)
        recip = torch.where(code == k, 1.0 / 10**k, recip)
    r = torch.round(col * scale)
    scaled = torch.where(live & (code != 99), r, 0.0).to(torch.int64)
    return code, scaled, recip


@dataclasses.dataclass(frozen=True)
class StateSlot:
    """One partial-state column: its AggOp and source column index in the
    pre-projected input (or None for COUNT(*))."""

    name: str
    op: AggOp
    src: int | None


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """Decomposition of logical aggregate expressions into partial state
    slots + final expressions over the merged state."""

    group_names: tuple[str, ...]
    slots: tuple[StateSlot, ...]
    # final output: (output name, dtype, state slot indices, kind)
    # kind: "id" -> slot value; "avg" -> s/c; "var_samp"/"var_pop"/
    # "stddev_samp"/"stddev_pop" -> (sum, sumsq, count);
    # "corr" -> (sx, sy, sxy, sx2, sy2, count)
    finals: tuple[tuple[str, DataType, tuple[int, ...], str], ...]
    # ordered distinct pre-projection argument expressions (the slots'
    # src indexes point past the group columns into this list) — the
    # single source of truth for the pre-projection, so decompositions
    # can synthesize exprs (x*x, null-masked pairs) no raw arg carries
    arg_exprs: tuple = ()


def decompose_aggregates(
    group_exprs: list[L.Expr],
    agg_exprs: list[L.Expr],
    input_schema: Schema,
) -> AggSpec:
    slots: list[StateSlot] = []
    finals: list[tuple[str, DataType, tuple[int, ...], str]] = []

    def slot_for(op: AggOp, src: int | None, name: str) -> int:
        for i, s in enumerate(slots):
            if s.op == op and s.src == src:
                return i
        slots.append(StateSlot(name, op, src))
        return len(slots) - 1

    # pre-projection layout: group cols first, then distinct agg args
    arg_index: dict[str, int] = {}
    arg_exprs: list[L.Expr] = []
    n_groups = len(group_exprs)

    def arg_slot(e: L.Expr) -> int:
        key = e.name()
        if key not in arg_index:
            arg_index[key] = n_groups + len(arg_exprs)
            arg_exprs.append(e)
        return arg_index[key]

    def _masked(e: L.Expr, other: L.Expr) -> L.Expr:
        """e where BOTH e and other are non-null, else NULL (CORR's
        pairwise-deletion semantics), via CASE over existing expr nodes."""
        cond = L.BinaryExpr(
            L.IsNotNull(e), L.Operator.AND, L.IsNotNull(other)
        )
        return L.Case(((cond, e),), None)

    for e in agg_exprs:
        aggs = L.find_aggregates(e)
        if len(aggs) != 1 or not aggs[0] is e:
            raise PlanError(
                f"aggregate expression {e.name()!r} must be a bare aggregate "
                "(planner rewrites arithmetic over aggregates)"
            )
        a = e
        out_dtype = a.data_type(input_schema)
        if isinstance(a, L.PercentileExpr):
            raise PlanError(
                "percentile aggregates must be split out by the optimizer "
                "(split_percentiles) before physical planning"
            )
        if isinstance(a, L.UdafExpr):
            # each state is a SUM/COUNT/MIN/MAX slot over the argument or
            # its hidden transform UDF; the final step calls ``finalize``
            from ballista_tpu_torch.plugin import lookup_udaf

            udaf = lookup_udaf(a.uname)
            idxs = []
            for suffix, op_s, has_transform in udaf.states:
                arg = a.arg
                if has_transform:
                    arg = L.ScalarFunction(f"__udaf_{a.uname}_{suffix}", (arg,))
                src = arg_slot(arg)
                idxs.append(slot_for(_UDAF_OPS[op_s], src, f"{a.name()}#{suffix}"))
            finals.append((a.name(), out_dtype, tuple(idxs), f"udaf:{a.uname}"))
            continue
        if a.func == L.AggFunc.AVG:
            src = arg_slot(a.arg)
            i1 = slot_for(AggOp.SUM, src, f"{a.name()}#sum")
            i2 = slot_for(AggOp.COUNT, src, f"{a.name()}#count")
            finals.append((a.name(), out_dtype, (i1, i2), "avg"))
        elif a.func in (
            L.AggFunc.STDDEV, L.AggFunc.STDDEV_POP,
            L.AggFunc.VARIANCE, L.AggFunc.VAR_POP,
        ):
            x = L.Cast(a.arg, DataType.FLOAT64)
            src = arg_slot(x)
            sq = arg_slot(L.BinaryExpr(x, L.Operator.MULTIPLY, x))
            i1 = slot_for(AggOp.SUM, src, f"{a.name()}#sum")
            i2 = slot_for(AggOp.SUM, sq, f"{a.name()}#sumsq")
            i3 = slot_for(AggOp.COUNT, src, f"{a.name()}#count")
            kind = {
                L.AggFunc.STDDEV: "stddev_samp",
                L.AggFunc.STDDEV_POP: "stddev_pop",
                L.AggFunc.VARIANCE: "var_samp",
                L.AggFunc.VAR_POP: "var_pop",
            }[a.func]
            finals.append((a.name(), out_dtype, (i1, i2, i3), kind))
        elif a.func == L.AggFunc.CORR:
            x = L.Cast(_masked(a.arg, a.arg2), DataType.FLOAT64)
            y = L.Cast(_masked(a.arg2, a.arg), DataType.FLOAT64)
            sx = arg_slot(x)
            sy = arg_slot(y)
            sxy = arg_slot(L.BinaryExpr(x, L.Operator.MULTIPLY, y))
            sx2 = arg_slot(L.BinaryExpr(x, L.Operator.MULTIPLY, x))
            sy2 = arg_slot(L.BinaryExpr(y, L.Operator.MULTIPLY, y))
            i = tuple(
                slot_for(AggOp.SUM, src, f"{a.name()}#{k}")
                for k, src in (
                    ("sx", sx), ("sy", sy), ("sxy", sxy),
                    ("sx2", sx2), ("sy2", sy2),
                )
            ) + (slot_for(AggOp.COUNT, sx, f"{a.name()}#count"),)
            finals.append((a.name(), out_dtype, i, "corr"))
        elif a.func == L.AggFunc.COUNT:
            src = None if isinstance(a.arg, L.Wildcard) else arg_slot(a.arg)
            i = slot_for(AggOp.COUNT, src, f"{a.name()}#count")
            finals.append((a.name(), out_dtype, (i,), "id"))
        else:
            op = {
                L.AggFunc.SUM: AggOp.SUM,
                L.AggFunc.MIN: AggOp.MIN,
                L.AggFunc.MAX: AggOp.MAX,
            }[a.func]
            src = arg_slot(a.arg)
            i = slot_for(op, src, f"{a.name()}#{op.value}")
            finals.append((a.name(), out_dtype, (i,), "id"))

    return AggSpec(
        group_names=tuple(g.name() for g in group_exprs),
        slots=tuple(slots),
        finals=tuple(finals),
        arg_exprs=tuple(arg_exprs),
    )


def _state_batch(res: GroupAggResult, state_schema: Schema) -> DeviceBatch:
    """GroupAggResult -> state-shaped DeviceBatch with the schema's dtypes
    (int32 stays a permitted physical form of a logical INT64 column)."""
    cols = list(res.keys) + list(res.values)
    nulls = list(res.key_nulls) + list(res.value_nulls)
    out = []
    for c, f in zip(cols, state_schema):
        want = f.dtype.to_torch()
        if c.dtype != want and not (want == torch.int64 and c.dtype == torch.int32):
            c = c.to(want)
        out.append(c)
    return DeviceBatch(
        schema=state_schema, columns=tuple(out), valid=res.valid,
        nulls=tuple(nulls), dictionaries={},
    )


def _stat_final(outs_at, idxs, kind):
    """var/stddev/corr finalization over state slots (raw-moment formulas,
    as in the reference, with its numerical-domain caveats)."""
    f64 = torch.float64
    if kind in ("var_samp", "var_pop", "stddev_samp", "stddev_pop"):
        s = outs_at(idxs[0]).to(f64)
        s2 = outs_at(idxs[1]).to(f64)
        c = outs_at(idxs[2]).to(f64)
        pop = kind.endswith("_pop")
        denom = torch.clamp(c if pop else c - 1, min=1.0)
        var = torch.clamp((s2 - s * s / torch.clamp(c, min=1.0)) / denom, min=0.0)
        vals = torch.sqrt(var) if kind.startswith("stddev") else var
        nl = (c == 0) if pop else (c < 2)
        return vals, nl
    assert kind == "corr"
    sx, sy, sxy, sx2, sy2, c = (outs_at(i).to(f64) for i in idxs[:6])
    cn = torch.clamp(c, min=1.0)
    cov = sxy - sx * sy / cn
    dd = (sx2 - sx * sx / cn) * (sy2 - sy * sy / cn)
    vals = torch.clamp(cov / torch.sqrt(torch.clamp(dd, min=1e-300)), -1.0, 1.0)
    nl = (c == 0) | (dd <= 0)
    return vals, nl


def _one_row(v: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """A scalar-state column: ``v`` at row 0 of a zeroed capacity-2048
    tensor (no host sync)."""
    arr = torch.zeros(_SCALAR_CAP, dtype=dtype, device=device)
    arr[0] = v.to(dtype)
    return arr


def _scalar_state_program(slots, schema: Schema, b: DeviceBatch) -> DeviceBatch:
    """Per-batch scalar (no GROUP BY) partial state: one live row."""
    val_cols, val_nulls = [], []
    for s in slots:
        if s.src is None:  # COUNT(*)
            val_cols.append(torch.ones(b.capacity, dtype=torch.int64, device=b.device))
            val_nulls.append(None)
        else:
            val_cols.append(b.columns[s.src])
            val_nulls.append(b.nulls[s.src])
    outs, nulls = scalar_aggregate(b.valid, val_cols, val_nulls, [s.op for s in slots])
    valid = torch.zeros(_SCALAR_CAP, dtype=torch.bool, device=b.device)
    valid[0] = True
    return DeviceBatch(
        schema=schema,
        columns=tuple(
            _one_row(v, f.dtype.to_torch(), b.device) for v, f in zip(outs, schema)
        ),
        valid=valid,
        nulls=tuple(
            None if nl is None else _one_row(nl, torch.bool, b.device) for nl in nulls
        ),
        dictionaries={},
    )


_UDAF_OPS = {"sum": AggOp.SUM, "count": AggOp.COUNT, "min": AggOp.MIN, "max": AggOp.MAX}


def _udaf_final(kind: str, col, idxs):
    """A UDAF's final value, ``finalize`` over its merged state slots, and
    its nulls: NULL for the groups whose count state saw no live rows
    (without a count state the finalize result stands as computed)."""
    from ballista_tpu_torch.plugin import lookup_udaf

    udaf = lookup_udaf(kind[5:])
    vals = udaf.finalize(*(col(i) for i in idxs))
    nl = None
    for (_, op_s, _), i in zip(udaf.states, idxs):
        if op_s == "count":
            nl = col(i) == 0
            break
    return vals, nl


def _finalize_scalar_program(finals, schema: Schema, outs, nulls, device) -> DeviceBatch:
    """Scalar-aggregate finalization (AVG division, statistical finals,
    pass-through) to a one-live-row batch."""
    cols, null_masks = [], []
    for name, dtype, idxs, kind in finals:
        if kind == "avg":
            s, c = outs[idxs[0]], outs[idxs[1]]
            v = s.to(torch.float64) / torch.clamp(c, min=1).to(torch.float64)
            nl = c == 0
        elif kind in ("var_samp", "var_pop", "stddev_samp", "stddev_pop", "corr"):
            v, nl = _stat_final(lambda i: outs[i], idxs, kind)
        elif kind.startswith("udaf:"):
            v, nl = _udaf_final(kind, lambda i: outs[i], idxs)
        else:
            v = outs[idxs[0]]
            nl = nulls[idxs[0]]
        cols.append(_one_row(v, dtype.to_torch(), device))
        null_masks.append(None if nl is None else _one_row(nl, torch.bool, device))
    valid = torch.zeros(_SCALAR_CAP, dtype=torch.bool, device=device)
    valid[0] = True
    return DeviceBatch(
        schema=schema, columns=tuple(cols), valid=valid,
        nulls=tuple(null_masks), dictionaries={},
    )


def finalize_state(state: DeviceBatch, spec: AggSpec, out_schema: Schema) -> DeviceBatch:
    """Merged state batch (group keys ++ slot values) -> final output batch:
    AVG divides its SUM/COUNT slots, the statistical aggregates finish from
    their moments, the others pass through with the output dtype."""
    n_groups = len(spec.group_names)
    cols = list(state.columns[:n_groups])
    nulls = list(state.nulls[:n_groups])
    dicts = {
        k: v
        for k, v in state.dictionaries.items()
        if any(f.name == k for f in out_schema.fields[:n_groups])
    }
    for name, dtype, idxs, kind in spec.finals:
        if kind == "avg":
            s = state.columns[n_groups + idxs[0]]
            c = state.columns[n_groups + idxs[1]]
            vals = s.to(torch.float64) / torch.clamp(c, min=1).to(torch.float64)
            nl = c == 0
            base_null = state.nulls[n_groups + idxs[0]]
            if base_null is not None:
                nl = nl | base_null
        elif kind in ("var_samp", "var_pop", "stddev_samp", "stddev_pop", "corr"):
            vals, nl = _stat_final(lambda i: state.columns[n_groups + i], idxs, kind)
        elif kind.startswith("udaf:"):
            vals, nl = _udaf_final(kind, lambda i: state.columns[n_groups + i], idxs)
        else:
            vals = state.columns[n_groups + idxs[0]]
            nl = state.nulls[n_groups + idxs[0]]
            if dtype == DataType.STRING:
                # MIN/MAX over a coded column: re-key the slot's dictionary
                slot_name = state.schema.fields[n_groups + idxs[0]].name
                d = state.dictionaries.get(slot_name)
                if d is not None:
                    dicts[name] = d
        want = dtype.to_torch()
        if vals.dtype != want:
            vals = vals.to(want)
        cols.append(vals)
        nulls.append(nl)
    return DeviceBatch(
        schema=out_schema, columns=tuple(cols), valid=state.valid,
        nulls=tuple(nulls), dictionaries=dicts,
    )


class HashAggregateExec(ExecutionPlan):
    """mode='partial' emits group keys + state columns per input partition;
    mode='final' merges the partial states into final values."""

    # Per-batch partial states held before an incremental fold.
    _FOLD_WIDTH = 4

    def __init__(
        self,
        input: ExecutionPlan,
        group_exprs: list[L.Expr],
        agg_exprs: list[L.Expr],
        mode: str,  # "partial" | "final"
        spec: AggSpec | None = None,
        capacity: int | None = None,
        planned_input_schema: Schema | None = None,
    ) -> None:
        """``capacity``: the group capacity a plan fixes (serde carries
        it; the planner leaves it to the config). ``planned_input_schema``:
        the schema the aggregate expressions were planned against (the
        partial's input), which a final aggregate carries for serde."""
        super().__init__()
        if mode not in ("partial", "final"):
            raise PlanError(f"bad aggregate mode {mode}")
        self.input = input
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        self.mode = mode
        self.capacity = capacity
        ins = input.schema()
        self.planned_input_schema = planned_input_schema if planned_input_schema is not None else ins
        self._pre_plan = None
        if mode == "partial":
            self.spec = (
                spec if spec is not None
                else decompose_aggregates(group_exprs, agg_exprs, ins)
            )
            # partial input pre-projection: groups then args
            self._pre_exprs = list(group_exprs) + list(self.spec.arg_exprs)
            self._pre_schema = Schema(
                [Field(e.name(), e.data_type(ins), e.nullable(ins)) for e in self._pre_exprs]
            )
            self._schema = self._partial_schema(self._pre_schema)
        else:
            if spec is None:
                raise PlanError("final aggregate requires the partial's spec")
            self.spec = spec
            self._schema = self._final_schema(ins)

    # -- schemas -------------------------------------------------------------
    def _partial_schema(self, pre: Schema) -> Schema:
        fields = [pre.fields[i] for i in range(len(self.spec.group_names))]
        for s in self.spec.slots:
            if s.op == AggOp.COUNT:
                dt = DataType.INT64
            else:
                dt = pre.fields[s.src].dtype
                if s.op == AggOp.SUM:
                    dt = (
                        DataType.INT64 if dt.is_integer or dt == DataType.BOOL
                        else DataType.FLOAT64 if dt.is_floating
                        else dt
                    )
            fields.append(Field(s.name, dt, True))
        return Schema(fields)

    def _final_schema(self, partial: Schema) -> Schema:
        ng = len(self.spec.group_names)
        fields = list(partial.fields[:ng])
        for name, dtype, _, _ in self.spec.finals:
            fields.append(Field(name, dtype, True))
        return Schema(fields)

    def schema(self) -> Schema:
        return self._schema

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def output_partitioning(self):
        if self.mode == "partial":
            return self.input.output_partitioning()
        return UnknownPartitioning(self.input.output_partitioning().n)

    def describe(self) -> str:
        g = ", ".join(self.spec.group_names)
        a = ", ".join(s.name for s in self.spec.slots)
        return f"HashAggregateExec(mode={self.mode}): gby=[{g}], aggr=[{a}]"

    # -- execution -----------------------------------------------------------
    def _agg_capacity(self, ctx: TaskContext) -> int:
        # a retry's grown capacity wins over the planned and the configured one
        if ctx.agg_capacity_override:
            return max(ctx.agg_capacity_override, self.capacity or 0)
        return self.capacity or ctx.config.agg_capacity()

    def _dec_scaled_sums(self, val_cols, val_nulls, ops, batch, ctx, site, from_state):
        """Exact decimal summation: f64 SUM inputs that are decimals (every
        value integral at 10^k, k <= 6) are rounded to int64 at scale 10^k
        before the reduction, and the sums divided back after. Integer sums
        are exact in any order, so money sums come out bit-identical across
        batch sizes, runs and devices.

        k is learned per (site, slot) through the plan cache (the smallest
        of 2, 4, 6 whose integrality and 2^52 bound hold; 99 = not a
        decimal), and every scaled run re-validates it on the device with a
        deferred speculation. A run that learns a slot's scale also sums it
        at the scale its device check picks (``_dec_pick``), so the sums
        are exact from the first run on, and a merge (fold or final) is
        exact in the same run as the partial sums it merges, however many
        merge levels the plan has. Returns (value columns, the divisor of
        each slot or None, the picked slots as (slot, code, int64 column,
        reciprocal))."""
        unscale: list = [None] * len(val_cols)
        picks: list = []
        cache = ctx.plan_cache
        if cache is None:
            return val_cols, unscale, picks
        out = list(val_cols)
        for j, (vc, vn, op) in enumerate(zip(val_cols, val_nulls, ops)):
            if op != AggOp.SUM or vc.dtype != torch.float64:
                continue
            # merge sites replace their learned scale each run: an earlier
            # run's inputs may have been inexact float partial sums, which
            # are integral only once the partial pass runs scaled
            key = ("dec_sum_last" if from_state else "dec_sum", "", site, j)
            code = cache.get(key)
            if code is None or (from_state and code not in (2, 4, 6)):
                learned, scaled, recip = _dec_pick(vc, batch.valid, vn)
                ctx.defer_learn(key, learned)
                picks.append((j, learned, scaled, recip))
                continue
            if code not in (2, 4, 6):
                continue
            scaled, ok = _dec_scale(vc, batch.valid, vn, int(code))
            ctx.defer_speculation(
                ~ok,
                "decimal-sum scaling went stale (values no longer integral at "
                "the learned scale, or sum bound exceeded)",
                [key],
            )
            out[j] = scaled
            unscale[j] = float(10 ** int(code))
        return out, unscale, picks

    def _run_group_agg(
        self,
        batch: DeviceBatch,
        ops: list[AggOp],
        n_groups: int,
        cap: int,
        from_state: bool,
        ctx: TaskContext,
        site: str,
    ) -> DeviceBatch:
        """One grouped pass -> state-shaped DeviceBatch. ``from_state``:
        the value columns are already state slots (merge pass); otherwise
        they come from the pre-projection via each slot's ``src``. The
        overflow flag is deferred to the task boundary."""
        key_cols = [batch.columns[i] for i in range(n_groups)]
        key_nulls = [batch.nulls[i] for i in range(n_groups)]
        val_cols, val_nulls = [], []
        for j, s in enumerate(self.spec.slots):
            if from_state:
                val_cols.append(batch.columns[n_groups + j])
                val_nulls.append(batch.nulls[n_groups + j])
            elif s.src is None:  # COUNT(*): count valid rows
                val_cols.append(
                    torch.ones(batch.capacity, dtype=torch.int64, device=batch.device)
                )
                val_nulls.append(None)
            else:
                val_cols.append(batch.columns[s.src])
                val_nulls.append(batch.nulls[s.src])
        # a batch of N rows holds at most N groups: small batches stay
        # cheap when the capacity grew for a big merge
        cap = min(cap, max(batch.capacity, 16))
        vocab = self._dense_vocab(batch, n_groups)
        dec_unscale: list = [None] * len(val_cols)
        if vocab is not None:
            # dictionary-coded or boolean keys with a small domain: the
            # dense path (the one-hot kernel; it sums f64 deterministically)
            res = dense_group_aggregate(
                key_cols, key_nulls, vocab, batch.valid, val_cols, val_nulls, list(ops)
            )
        else:
            val_cols, dec_unscale, picks = self._dec_scaled_sums(
                val_cols, val_nulls, ops, batch, ctx, site, from_state
            )
            # a picked slot is summed twice, in f64 and at its picked scale
            res = group_aggregate(
                key_cols, key_nulls, batch.valid,
                val_cols + [p[2] for p in picks],
                val_nulls + [val_nulls[p[0]] for p in picks],
                list(ops) + [AggOp.SUM] * len(picks), cap,
            )
            if picks:
                n = len(val_cols)
                values = list(res.values[:n])
                for (j, code, _, recip), exact in zip(picks, res.values[n:]):
                    values[j] = torch.where(
                        code != 99, exact.to(torch.float64) * recip, values[j]
                    )
                res = dataclasses.replace(
                    res, values=values, value_nulls=list(res.value_nulls[:n])
                )
        ctx.defer_check(
            res.overflow,
            "aggregate exceeded group capacity; raise ballista.tpu.agg_capacity",
            required=res.n_groups,
        )
        state_schema = batch.schema if from_state else self._schema
        out = _state_batch(res, state_schema)
        if any(d is not None for d in dec_unscale):
            # back to value units by the reciprocal, as the reference's
            # compiled divide by a constant does, so that the sums match it
            # bit for bit (a divide can differ from it in the last bit)
            cols = list(out.columns)
            for j, d in enumerate(dec_unscale):
                if d is not None:
                    cols[n_groups + j] = cols[n_groups + j] * (1.0 / d)
            out.columns = tuple(cols)
        dicts = {
            k: v
            for k, v in batch.dictionaries.items()
            if any(f.name == k and f.dtype == DataType.STRING for f in state_schema)
        }
        if not from_state:
            # STRING value slots (MIN/MAX over a coded column) carry their
            # source column's dictionary under the slot's renamed field
            for j, s in enumerate(self.spec.slots):
                f = state_schema.fields[n_groups + j]
                if f.dtype == DataType.STRING and s.src is not None:
                    d = batch.dictionaries.get(batch.schema.fields[s.src].name)
                    if d is not None:
                        dicts[f.name] = d
        out.dictionaries = dicts
        return out

    @staticmethod
    def _dense_vocab(batch: DeviceBatch, n_groups: int) -> list[int] | None:
        """Vocab sizes when EVERY group key is dictionary-coded (STRING) or
        BOOL and the dense slot space stays small; None otherwise."""
        if n_groups == 0:
            return None
        vocab: list[int] = []
        slots = 1
        for i in range(n_groups):
            f = batch.schema.fields[i]
            if f.dtype == DataType.STRING:
                d = batch.dictionaries.get(f.name)
                if d is None or len(d.values) == 0:
                    return None
                vocab.append(len(d.values))
            elif f.dtype == DataType.BOOL:
                vocab.append(2)
            else:
                return None
            slots *= vocab[-1] + 1
            if slots > DENSE_AGG_MAX_SLOTS:
                return None
        return vocab

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        cap = self._agg_capacity(ctx)
        n_groups = len(self.spec.group_names)
        if self.mode == "partial":
            yield from self._execute_partial(partition, ctx, cap, n_groups)
        else:
            yield from self._execute_final(partition, ctx, cap, n_groups)

    def _execute_partial(
        self, partition: int, ctx: TaskContext, cap: int, n_groups: int
    ) -> Iterator[DeviceBatch]:
        from ballista_tpu_torch.exec.pipeline import ProjectionExec

        if self._pre_plan is None:
            self._pre_plan = ProjectionExec(self.input, self._pre_exprs)
        ops = [s.op for s in self.spec.slots]

        if n_groups == 0:
            # scalar aggregate: one-row state per batch, concatenated
            states = []
            for b in self._pre_plan.execute(partition, ctx):
                with self.metrics.time("agg_time"):
                    states.append(_scalar_state_program(self.spec.slots, self._schema, b))
            if states:
                yield concat_batches(states)
            return

        merge_ops = [s.op.merge_op for s in self.spec.slots]
        # the plan-cache site of this operator's learned decimal scales
        site = self.display()

        def fold(states: list[DeviceBatch]) -> DeviceBatch:
            return self._run_group_agg(
                concat_batches(states), merge_ops, n_groups, cap, from_state=True,
                ctx=ctx, site=site + "|fold",
            )

        # fold every few batches: bounds the live states (merge ops are
        # associative)
        partials: list[DeviceBatch] = []
        for b in self._pre_plan.execute(partition, ctx):
            with self.metrics.time("agg_time"):
                partials.append(
                    self._run_group_agg(
                        b, ops, n_groups, cap, from_state=False, ctx=ctx, site=site
                    )
                )
                if len(partials) >= self._FOLD_WIDTH:
                    partials = [fold(partials)]
            self.metrics.add("input_batches")
        if not partials:
            return
        # every state this partial emits is key-unique on its own (a
        # per-batch grouping or a fold), which lets the final skip a merge
        if len(partials) > 1:
            with self.metrics.time("agg_time"):
                partials = [fold(partials)]
        partials[0].keys_unique = True
        yield partials[0]

    def _execute_final(
        self, partition: int, ctx: TaskContext, cap: int, n_groups: int
    ) -> Iterator[DeviceBatch]:
        # merges only this output partition's input partition: the input is
        # a one-partition coalesce (the funnel) or a hash repartition on the
        # group keys (K parallel merges, each owning its bucket's groups)
        merge_ops = [s.op.merge_op for s in self.spec.slots]
        budget = ctx.config.hbm_budget_mb() << 20
        if budget and n_groups > 0:
            # the states are collected under the budget: the moment their
            # total crosses it, the resident ones drain to host buckets and
            # the rest of the stream follows
            states, grace = self._collect_states_grace(partition, ctx, budget, n_groups)
            if grace is not None:
                yield from self._grace_merge(grace, ctx, cap, n_groups, merge_ops, budget)
                return
        else:
            states = list(self.input.execute(partition, ctx))
        if not states:
            return
        if n_groups == 0:
            with self.metrics.time("merge_time"):
                merged = concat_batches(states)
                n_slots = len(self.spec.slots)
                outs, nulls = scalar_aggregate(
                    merged.valid,
                    [merged.columns[i] for i in range(n_slots)],
                    [merged.nulls[i] for i in range(n_slots)],
                    merge_ops,
                )
                yield _finalize_scalar_program(
                    self.spec.finals, self._schema, outs, nulls, merged.device
                )
            return
        if len(states) == 1 and getattr(states[0], "keys_unique", False):
            # a lone key-unique state needs no merge
            with self.metrics.time("merge_time"):
                out = finalize_state(states[0], self.spec, self._schema)
            yield out
            return
        with self.metrics.time("merge_time"):
            state = self._run_group_agg(
                concat_batches(states), merge_ops, n_groups, cap, from_state=True,
                ctx=ctx, site=self.display(),
            )
        yield finalize_state(state, self.spec, self._schema)

    # Bucket fan-out of the spill files. K passes (a power of two dividing
    # it, chosen once the states' total is known) take consecutive bucket
    # ranges: every bucket holds whole groups, so any grouping of buckets
    # into passes is exact.
    _GRACE_BUCKETS = 64

    def _collect_states_grace(
        self, partition: int, ctx: TaskContext, budget: int, n_groups: int
    ) -> tuple:
        """This partition's partial states, collected under the device
        budget: (states, None) when they all fit, else (None, (spill set,
        total bytes)) with every state hash-spilled by group key to host
        bucket files. The switch fires the moment the running total crosses
        the budget, so the full set is never resident. A lone state over
        the budget does not spill: the child has materialized it already."""
        from ballista_tpu_torch.exec.spill import device_nbytes, spill_batch_by_keys

        key_idxs = tuple(range(n_groups))
        states: list[DeviceBatch] = []
        total = 0
        sset = None
        spilled = 0
        for st in self.input.execute(partition, ctx):
            total += device_nbytes(st)
            if sset is None and states and total > budget:
                sset = ctx.spill_manager().new_set(
                    f"agg-{id(self):x}-{partition}", self._GRACE_BUCKETS
                )
                with self.metrics.time("spill_time"):
                    for prev in states:
                        spilled += spill_batch_by_keys(sset, prev, key_idxs)
                states.clear()
            if sset is None:
                states.append(st)
            else:
                with self.metrics.time("spill_time"):
                    spilled += spill_batch_by_keys(sset, st, key_idxs)
        if sset is None:
            return states, None
        sset.finish_writes()
        self.metrics.add("spill_bytes", spilled)
        return None, (sset, total)

    def _grace_merge(
        self, grace: tuple, ctx: TaskContext, cap: int, n_groups: int,
        merge_ops: list, budget_bytes: int,
    ) -> Iterator[DeviceBatch]:
        """The out-of-core final merge: the partial states were spilled by
        group key (the shuffle's routing: strings by value, NULL keys in one
        bucket); each pass reloads one bucket range and merges it through
        the ordinary merge. Group keys are unique across buckets, so each
        pass's merged state finalizes on its own and the passes' outputs
        together are the in-memory result."""
        from ballista_tpu_torch.columnar.arrow_interop import table_from_arrow
        from ballista_tpu_torch.exec.spill import choose_passes

        sset, total_bytes = grace
        k = choose_passes(total_bytes, budget_bytes, self._GRACE_BUCKETS)
        self.metrics.add("spill_passes", k)
        group = self._GRACE_BUCKETS // k
        batch_rows = ctx.config.tpu_batch_rows()
        site = self.display() + "|grace"
        for pass_i in range(k):
            tabs = [
                t
                for b in range(pass_i * group, (pass_i + 1) * group)
                if (t := sset.read(b)) is not None and t.num_rows
            ]
            if not tabs:
                continue
            # narrowing off: every bucket reloads with one layout
            bucket: list[DeviceBatch] = []
            for t in tabs:
                bucket.extend(table_from_arrow(t, batch_rows, frozenset(), device=ctx.device))
            with self.metrics.time("merge_time"):
                state = self._run_group_agg(
                    concat_batches(bucket), merge_ops, n_groups, cap, from_state=True,
                    ctx=ctx, site=site,
                )
            yield finalize_state(state, self.spec, self._schema)
        sset.close()
