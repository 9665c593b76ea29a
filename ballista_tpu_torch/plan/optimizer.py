"""Logical-plan optimizer.

The reference gets optimization from DataFusion (invoked at
ballista/rust/scheduler/src/scheduler_server/grpc.rs:439-464 before physical
planning). Per SURVEY.md §7 the rebuild keeps the optimizer minimal — the
rules the TPC-H plans actually need:

1. constant folding (incl. ``date '1998-12-01' - interval '90' day`` and
   month-interval calendar arithmetic, which must never reach the device)
2. cross-join elimination: flatten comma-join trees + WHERE conjuncts into
   a greedy left-deep equi-join tree (every TPC-H query is written with
   comma joins)
3. predicate pushdown through projections/aliases/joins into scans
4. projection pushdown (column pruning) into scans
"""

from __future__ import annotations

import calendar
import datetime

from ballista_tpu_torch.datatypes import DataType, Schema
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.plan.logical import (
    Aggregate,
    CrossJoin,
    Distinct,
    EmptyRelation,
    Filter,
    Join,
    JoinType,
    Limit,
    LogicalPlan,
    Percentile,
    Projection,
    Sort,
    SortExpr,
    SubqueryAlias,
    TableScan,
    Union,
    Window,
)

EPOCH = datetime.date(1970, 1, 1)


def optimize(plan: LogicalPlan) -> LogicalPlan:
    plan = map_plan_expressions(plan, fold_constants)
    plan = map_plan_expressions(plan, factor_or_conjuncts)
    # Pushdown first so join conjuncts travel through decorrelation joins and
    # land directly above the cross-join trees they connect; then eliminate
    # cross joins; then push the now-placeable remainder; then prune.
    plan = push_down_filters(plan)
    plan = eliminate_cross_joins(plan)
    plan = push_down_filters(plan)
    plan = split_percentiles(plan)
    plan = prune_columns(plan)
    return plan


def split_percentiles(plan: LogicalPlan) -> LogicalPlan:
    """Aggregate nodes containing holistic percentile expressions split
    into Aggregate(rest) ⋈ Percentile(...) on the group keys, with a
    projection restoring the original output schema. The percentile side
    re-reads the aggregate's input (holistic aggregates cannot share the
    algebraic partial/merge pipeline); scans are device-cached, so the
    second pass is cheap for the common grouped-table shape."""
    kids = [split_percentiles(c) for c in plan.children()]
    plan = plan.with_children(kids) if kids else plan
    if not isinstance(plan, Aggregate):
        return plan
    percs = [
        e for e in plan.agg_exprs if isinstance(e, L.PercentileExpr)
    ]
    if not percs:
        return plan
    rest = tuple(
        e for e in plan.agg_exprs if not isinstance(e, L.PercentileExpr)
    )
    ins = plan.input.schema()

    # NULL group keys are their own group (SQL), but equi-joins never
    # match NULL — so every join key rides as a (zeroed value, is-null
    # flag) PAIR, and the Percentile side groups by the same pair.
    def _zero_lit(dt: DataType) -> L.Literal:
        zero = {
            DataType.STRING: "",
            DataType.BOOL: False,
            DataType.FLOAT32: 0.0,
            DataType.FLOAT64: 0.0,
        }.get(dt, 0)
        return L.Literal(zero, dt)

    def zeroed(e: L.Expr) -> L.Expr:
        dt = e.data_type(ins)
        return L.Case(((L.IsNotNull(e), e),), _zero_lit(dt))

    nullable = [g.nullable(ins) for g in plan.group_exprs]
    gz = [
        zeroed(g) if nl else g
        for g, nl in zip(plan.group_exprs, nullable)
    ]
    gflags = [
        L.IsNull(g) if nl else None
        for g, nl in zip(plan.group_exprs, nullable)
    ]

    def key_aliases(prefix: str) -> list[L.Alias]:
        out = []
        for i, (z, f) in enumerate(zip(gz, gflags)):
            out.append(L.Alias(z, f"{prefix}{i}"))
            if f is not None:
                out.append(L.Alias(f, f"{prefix}n{i}"))
        return out

    # one Percentile node per distinct value expression; each piece gets
    # ITS OWN key column names so chained joins never collide
    by_val: dict[str, list[L.PercentileExpr]] = {}
    for e in percs:
        by_val.setdefault(e.arg.name(), []).append(e)
    pieces: list[tuple[LogicalPlan, list[str]]] = []
    out_of: dict[int, str] = {}  # id(perc expr) -> output column name
    for vi, (vname, group) in enumerate(by_val.items()):
        p_keys = key_aliases(f"__pg{vi}_")
        p_key_names = [a.aname for a in p_keys]
        proj = Projection(
            plan.input,
            tuple(p_keys) + (L.Alias(group[0].arg, f"__pv{vi}"),),
        )
        reqs = []
        for j, e in enumerate(group):
            name = f"__pp{vi}_{j}"
            out_of[id(e)] = name
            reqs.append((L.Column(f"__pv{vi}"), e.q, name))
        pieces.append(
            (
                Percentile(
                    proj,
                    tuple(L.Column(n) for n in p_key_names),
                    tuple(p_key_names),
                    tuple(reqs),
                ),
                p_key_names,
            )
        )

    def join2(a: LogicalPlan, a_keys: list[str], b: LogicalPlan,
              b_keys: list[str]):
        if not plan.group_exprs:
            return CrossJoin(a, b)  # percentile side is a single row
        return Join(
            a, b,
            tuple(
                (L.Column(ak), L.Column(gn))
                for ak, gn in zip(a_keys, b_keys)
            ),
            JoinType.INNER,
        )

    if rest:
        # base aggregate keeps the ORIGINAL group exprs (real NULLs in
        # its output keys); a projection adds the null-safe join pair
        base = Aggregate(plan.input, plan.group_exprs, rest)
        base_cols = [L.Column(f.name) for f in base.schema()]
        bz: list[L.Alias] = []
        for i, (g, nl) in enumerate(zip(plan.group_exprs, nullable)):
            c = L.Column(g.name())
            dt = g.data_type(ins)
            if nl:
                bz.append(
                    L.Alias(
                        L.Case(((L.IsNotNull(c), c),), _zero_lit(dt)),
                        f"__bz{i}",
                    )
                )
                bz.append(L.Alias(L.IsNull(c), f"__bzn{i}"))
            else:
                bz.append(L.Alias(c, f"__bz{i}"))
        joined: LogicalPlan = Projection(base, tuple(base_cols + bz))
        base_keys = [a.aname for a in bz]
        for p, pk in pieces:
            joined = join2(joined, base_keys, p, pk)
        group_out = [L.Column(g.name()) for g in plan.group_exprs]
    else:
        joined, first_keys = pieces[0]
        for p, pk in pieces[1:]:
            joined = join2(joined, first_keys, p, pk)
        # reconstruct original group values (NULL where the flag is set)
        group_out = []
        ki = 0
        for g, nl in zip(plan.group_exprs, nullable):
            zc = L.Column(f"__pg0_{ki}")
            if nl:
                group_out.append(
                    L.Alias(
                        L.Case(
                            ((L.Not(L.Column(f"__pg0_n{ki}")), zc),), None
                        ),
                        g.name(),
                    )
                )
            else:
                group_out.append(L.Alias(zc, g.name()))
            ki += 1

    # restore the original Aggregate output schema (names and order)
    out_exprs: list[L.Expr] = list(group_out)
    for e in plan.agg_exprs:
        if isinstance(e, L.PercentileExpr):
            out_exprs.append(L.Alias(L.Column(out_of[id(e)]), e.name()))
        else:
            out_exprs.append(L.Column(e.name()))
    return Projection(joined, tuple(out_exprs))


# -- generic plan/expression mapping -----------------------------------------


def map_plan_expressions(plan: LogicalPlan, fn) -> LogicalPlan:
    """Apply an expression rewriter to every expression in the plan tree."""
    kids = [map_plan_expressions(c, fn) for c in plan.children()]
    if kids:
        plan = plan.with_children(kids)
    if isinstance(plan, Projection):
        return Projection(plan.input, tuple(_rw(e, fn) for e in plan.exprs))
    if isinstance(plan, Filter):
        return Filter(plan.input, _rw(plan.predicate, fn))
    if isinstance(plan, Aggregate):
        return Aggregate(
            plan.input,
            tuple(_rw(e, fn) for e in plan.group_exprs),
            tuple(_rw(e, fn) for e in plan.agg_exprs),
        )
    if isinstance(plan, Sort):
        return Sort(
            plan.input,
            tuple(
                SortExpr(_rw(s.expr, fn), s.ascending, s.nulls_first)
                for s in plan.sort_exprs
            ),
        )
    if isinstance(plan, Join):
        return Join(
            plan.left,
            plan.right,
            tuple((_rw(a, fn), _rw(b, fn)) for a, b in plan.on),
            plan.join_type,
            _rw(plan.filter, fn) if plan.filter is not None else None,
        )
    if isinstance(plan, TableScan) and plan.filters:
        return TableScan(
            plan.table_name,
            plan.source_schema,
            plan.projection,
            tuple(_rw(e, fn) for e in plan.filters),
            plan.source,
        )
    return plan


def _rw(e: L.Expr, fn) -> L.Expr:
    kids = e.children()
    if kids:
        e = e.with_children([_rw(c, fn) for c in kids])
    return fn(e)


# -- rule 1: constant folding -------------------------------------------------


def _add_months(days: int, months: int) -> int:
    d = EPOCH + datetime.timedelta(days=days)
    total = d.year * 12 + (d.month - 1) + months
    y, m = divmod(total, 12)
    day = min(d.day, calendar.monthrange(y, m + 1)[1])
    return (datetime.date(y, m + 1, day) - EPOCH).days


_FOLD_ARITH = {
    L.Operator.PLUS: lambda a, b: a + b,
    L.Operator.MINUS: lambda a, b: a - b,
    L.Operator.MULTIPLY: lambda a, b: a * b,
}


def fold_constants(e: L.Expr) -> L.Expr:
    """One bottom-up folding step (children already folded)."""
    if isinstance(e, L.BinaryExpr):
        lt, rt = e.left, e.right
        # date literal +/- interval literal -> date literal
        if (
            isinstance(lt, L.Literal)
            and lt.dtype == DataType.DATE32
            and isinstance(rt, L.IntervalLiteral)
            and e.op in (L.Operator.PLUS, L.Operator.MINUS)
        ):
            sign = 1 if e.op == L.Operator.PLUS else -1
            days = lt.value + sign * rt.days
            if rt.months:
                days = _add_months(days, sign * rt.months)
            return L.Literal(days, DataType.DATE32)
        if isinstance(lt, L.Literal) and isinstance(rt, L.Literal):
            if lt.value is None or rt.value is None:
                return L.Literal(None, DataType.NULL)
            if (
                e.op in _FOLD_ARITH
                and lt.dtype.is_numeric
                and rt.dtype.is_numeric
            ):
                v = _FOLD_ARITH[e.op](lt.value, rt.value)
                dtype = (
                    DataType.FLOAT64
                    if isinstance(v, float)
                    else L.Literal.infer(v).dtype
                )
                return L.Literal(v, dtype)
            if e.op == L.Operator.DIVIDE and lt.dtype.is_numeric and rt.dtype.is_numeric:
                if rt.value == 0:
                    return e
                if lt.dtype.is_integer and rt.dtype.is_integer:
                    q = abs(lt.value) // abs(rt.value)
                    if (lt.value < 0) != (rt.value < 0):
                        q = -q
                    return L.Literal(q, DataType.INT64)
                return L.Literal(lt.value / rt.value, DataType.FLOAT64)
    if isinstance(e, L.Negative) and isinstance(e.expr, L.Literal):
        v = e.expr.value
        if v is not None:
            return L.Literal(-v, e.expr.dtype)
    if isinstance(e, L.Not) and isinstance(e.expr, L.Literal):
        if e.expr.dtype == DataType.BOOL and e.expr.value is not None:
            return L.Literal(not e.expr.value, DataType.BOOL)
    return e


def factor_or_conjuncts(e: L.Expr) -> L.Expr:
    """Pull conjuncts common to every OR branch out of the OR:
    ``(k=x and A) or (k=x and B)`` -> ``k=x and (A or B)``. TPC-H q19's
    join key is written this way; without factoring it cannot become an
    equi-join."""
    if not (isinstance(e, L.BinaryExpr) and e.op == L.Operator.OR):
        return e
    branches = _split_disjuncts(e)
    if len(branches) < 2:
        return e
    branch_conjs = [_split_conjuncts(b) for b in branches]
    common: list[L.Expr] = []
    for c in branch_conjs[0]:
        if all(any(c.same_as(x) for x in bc) for bc in branch_conjs[1:]):
            common.append(c)
    if not common:
        return e
    rests = []
    for bc in branch_conjs:
        rest = [x for x in bc if not any(x.same_as(c) for c in common)]
        if not rest:
            return _conjoin(common)  # a branch reduced to TRUE
        rests.append(_conjoin(rest))
    ored = rests[0]
    for r in rests[1:]:
        ored = L.BinaryExpr(ored, L.Operator.OR, r)
    return _conjoin(common + [ored])


def _split_disjuncts(e: L.Expr) -> list[L.Expr]:
    if isinstance(e, L.BinaryExpr) and e.op == L.Operator.OR:
        return _split_disjuncts(e.left) + _split_disjuncts(e.right)
    return [e]


# -- rule 2: cross-join elimination ------------------------------------------


def eliminate_cross_joins(plan: LogicalPlan) -> LogicalPlan:
    kids = [eliminate_cross_joins(c) for c in plan.children()]
    if kids:
        plan = plan.with_children(kids)
    if not isinstance(plan, Filter):
        return plan
    base = plan.input
    if not isinstance(base, (CrossJoin, Join)):
        return plan
    # flatten the cross-join tree (stop at non-cross nodes)
    relations: list[LogicalPlan] = []

    def flatten(p: LogicalPlan) -> None:
        if isinstance(p, CrossJoin):
            flatten(p.left)
            flatten(p.right)
        else:
            relations.append(p)

    flatten(base)
    if len(relations) < 2:
        return plan
    conjuncts = _split_conjuncts(plan.predicate)

    # greedy left-deep join build
    placed = relations[0]
    remaining = relations[1:]
    unused = list(conjuncts)
    while remaining:
        ls, lq = placed.schema(), _qualifiers(placed)
        best = None
        for rel in remaining:
            rs, rq = rel.schema(), _qualifiers(rel)
            keys = []
            for c in unused:
                pair = _equi_pair_between(c, ls, lq, rs, rq)
                if pair is not None:
                    keys.append((c, pair))
            if keys:
                best = (rel, keys)
                break
        if best is None:
            # no connecting predicate: true cross join with the next relation
            placed = CrossJoin(placed, remaining.pop(0))
            continue
        rel, keys = best
        # NB: identity-based removal — Expr overloads __eq__ to build
        # comparison nodes, so list.remove() would match the wrong element.
        remaining = [r for r in remaining if r is not rel]
        used = {id(c) for c, _ in keys}
        unused = [u for u in unused if id(u) not in used]
        placed = Join(
            placed, rel, tuple(pair for _, pair in keys), JoinType.INNER, None
        )
    out: LogicalPlan = placed
    if unused:
        out = Filter(out, _conjoin(unused))
    # Joins may now expose equi keys for conjuncts that weren't available in
    # the original order; a second pass of pushdown handles placement.
    return out


def _split_conjuncts(e: L.Expr) -> list[L.Expr]:
    if isinstance(e, L.BinaryExpr) and e.op == L.Operator.AND:
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _conjoin(parts: list[L.Expr]) -> L.Expr:
    out = parts[0]
    for p in parts[1:]:
        out = L.BinaryExpr(out, L.Operator.AND, p)
    return out


def _resolvable(schema: Schema, name: str) -> bool:
    try:
        L.resolve_field_index(schema, name)
        return True
    except Exception:
        return False


def _qualifiers(plan: LogicalPlan) -> set[str]:
    """Table names/aliases a plan subtree exposes. Used to gate the
    qualified-name fallback of column resolution: ``points.k`` must not
    resolve against a subtree that doesn't contain relation ``points``
    merely because some relation there has a bare column ``k``."""
    if isinstance(plan, TableScan):
        return {plan.table_name}
    if isinstance(plan, SubqueryAlias):
        return {plan.alias}
    out: set[str] = set()
    for c in plan.children():
        out |= _qualifiers(c)
    return out


def _resolvable_on(schema: Schema, quals: set[str], name: str) -> bool:
    """Like ``_resolvable`` but qualifier-aware: a qualified name ``q.b``
    may only fall back to base-name-matching a bare field ``b`` if relation
    ``q`` (a member of ``quals``, see ``_qualifiers``) is in the subtree."""
    if "." in name and not any(f.name == name for f in schema.fields):
        if name.rsplit(".", 1)[0] not in quals:
            return False
    return _resolvable(schema, name)


def _equi_pair_between(
    c: L.Expr,
    ls: Schema,
    lq: set[str],
    rs: Schema,
    rq: set[str],
) -> tuple[L.Column, L.Column] | None:
    if not (isinstance(c, L.BinaryExpr) and c.op == L.Operator.EQ):
        return None
    a, b = c.left, c.right
    if not (isinstance(a, L.Column) and isinstance(b, L.Column)):
        return None
    # strictly one side each (a column ambiguous across both sides is not a
    # join key)
    a_l, a_r = _resolvable_on(ls, lq, a.cname), _resolvable_on(rs, rq, a.cname)
    b_l, b_r = _resolvable_on(ls, lq, b.cname), _resolvable_on(rs, rq, b.cname)
    if a_l and not a_r and b_r and not b_l:
        return (a, b)
    if b_l and not b_r and a_r and not a_l:
        return (b, a)
    return None


# -- rule 3: predicate pushdown ----------------------------------------------


def push_down_filters(plan: LogicalPlan) -> LogicalPlan:
    kids = [push_down_filters(c) for c in plan.children()]
    if kids:
        plan = plan.with_children(kids)
    if not isinstance(plan, Filter):
        return plan
    conjuncts = _split_conjuncts(plan.predicate)
    child = plan.input
    pushed, kept = _push_conjuncts(child, conjuncts)
    if kept == conjuncts and pushed is child:
        return plan
    if kept:
        return Filter(pushed, _conjoin(kept))
    return pushed


def _push_conjuncts(
    plan: LogicalPlan, conjuncts: list[L.Expr]
) -> tuple[LogicalPlan, list[L.Expr]]:
    """Try to push each conjunct into/below ``plan``. Returns (new plan,
    conjuncts that could not be pushed)."""
    if isinstance(plan, Projection):
        # rewrite conjuncts through the projection's aliases
        sub = {e.name(): (e.expr if isinstance(e, L.Alias) else e) for e in plan.exprs}
        pushable, kept = [], []
        for c in conjuncts:
            r = _rewrite_through(c, sub, plan.input.schema())
            (pushable if r is not None else kept).append(r if r is not None else c)
        if pushable:
            inner, not_pushed = _push_conjuncts(plan.input, pushable)
            if not_pushed:
                inner = Filter(inner, _conjoin(not_pushed))
            return Projection(inner, plan.exprs), kept
        return plan, kept
    if isinstance(plan, SubqueryAlias):
        # strip the alias qualifier and push below
        inner_schema = plan.input.schema()

        def dequal(e: L.Expr) -> L.Expr | None:
            if isinstance(e, L.Column):
                base = e.cname.rsplit(".", 1)[-1]
                if _resolvable(inner_schema, base):
                    return L.Column(base)
                return None
            kids = e.children()
            if not kids:
                return e
            new_kids = [dequal(k) for k in kids]
            if any(k is None for k in new_kids):
                return None
            return e.with_children(new_kids)

        pushable, kept = [], []
        for c in conjuncts:
            r = dequal(c)
            (pushable if r is not None else kept).append(r if r is not None else c)
        if pushable:
            inner, not_pushed = _push_conjuncts(plan.input, pushable)
            if not_pushed:
                inner = Filter(inner, _conjoin(not_pushed))
            return SubqueryAlias(inner, plan.alias), kept
        return plan, kept
    if isinstance(plan, Filter):
        inner, kept = _push_conjuncts(plan.input, conjuncts + _split_conjuncts(plan.predicate))
        if kept:
            return Filter(inner, _conjoin(kept)), []
        return inner, []
    if isinstance(plan, (Join, CrossJoin)):
        ls, rs = plan.left.schema(), plan.right.schema()
        lq, rq = _qualifiers(plan.left), _qualifiers(plan.right)
        left_push, right_push, kept = [], [], []
        semi = isinstance(plan, Join) and plan.join_type in (
            JoinType.SEMI, JoinType.ANTI,
        )
        outer_left = isinstance(plan, Join) and plan.join_type in (
            JoinType.LEFT, JoinType.FULL,
        )
        outer_right = isinstance(plan, Join) and plan.join_type in (
            JoinType.RIGHT, JoinType.FULL,
        )
        for c in conjuncts:
            cols = L.find_columns(c)
            on_left = all(_resolvable_on(ls, lq, n) for n in cols)
            on_right = (
                all(_resolvable_on(rs, rq, n) for n in cols) and not semi
            )
            # pushing below an outer join's preserved side changes results
            if on_left and not outer_right:
                left_push.append(c)
            elif on_right and not outer_left:
                right_push.append(c)
            else:
                kept.append(c)
        left = plan.left
        right = plan.right
        if left_push:
            left, np_ = _push_conjuncts(left, left_push)
            if np_:
                left = Filter(left, _conjoin(np_))
        if right_push:
            right, np_ = _push_conjuncts(right, right_push)
            if np_:
                right = Filter(right, _conjoin(np_))
        if isinstance(plan, Join):
            return (
                Join(left, right, plan.on, plan.join_type, plan.filter),
                kept,
            )
        return CrossJoin(left, right), kept
    if isinstance(plan, TableScan):
        return (
            TableScan(
                plan.table_name,
                plan.source_schema,
                plan.projection,
                plan.filters + tuple(conjuncts),
                plan.source,
            ),
            [],
        )
    if isinstance(plan, (Sort, Limit, Distinct)):
        # filters commute with sort; NOT with limit (changes which rows are
        # kept) — push through Sort/Distinct only.
        if isinstance(plan, Limit):
            return plan, conjuncts
        inner, kept = _push_conjuncts(plan.children()[0], conjuncts)
        if kept:
            inner = Filter(inner, _conjoin(kept))
        return plan.with_children([inner]), []
    return plan, conjuncts


def _rewrite_through(
    e: L.Expr, sub: dict[str, L.Expr], inner_schema: Schema
) -> L.Expr | None:
    """Rewrite a predicate in terms of the pre-projection schema, or None if
    it references something unavailable below (e.g. an aggregate output)."""
    if isinstance(e, L.Column):
        if e.cname in sub:
            repl = sub[e.cname]
            if L.find_aggregates(repl):
                return None
            return repl
        if _resolvable(inner_schema, e.cname):
            return e
        return None
    kids = e.children()
    if not kids:
        return e
    new_kids = [_rewrite_through(k, sub, inner_schema) for k in kids]
    if any(k is None for k in new_kids):
        return None
    return e.with_children(new_kids)


# -- rule 4: column pruning ---------------------------------------------------


def prune_columns(plan: LogicalPlan) -> LogicalPlan:
    return _prune(plan, required=None)


def _expr_columns(exprs) -> set[str]:
    out: set[str] = set()
    for e in exprs:
        out.update(L.find_columns(e))
    return out


def _prune(plan: LogicalPlan, required: set[str] | None) -> LogicalPlan:
    """``required`` = column names needed above (None = all)."""
    if isinstance(plan, TableScan):
        if required is None:
            return plan
        names = [
            f.name
            for f in plan.source_schema
            if f.name in required
            or any(r.rsplit(".", 1)[-1] == f.name for r in required)
        ]
        needed = set(names) | _expr_columns(plan.filters)
        proj = tuple(f.name for f in plan.source_schema if f.name in needed)
        if len(proj) == len(plan.source_schema):
            return plan
        if not proj:
            proj = (plan.source_schema.fields[0].name,)
        return TableScan(
            plan.table_name, plan.source_schema, proj, plan.filters,
            plan.source,
        )
    if isinstance(plan, Projection):
        need = _expr_columns(plan.exprs)
        return Projection(_prune(plan.input, need), plan.exprs)
    if isinstance(plan, Filter):
        need = None if required is None else required | _expr_columns([plan.predicate])
        return Filter(_prune(plan.input, need), plan.predicate)
    if isinstance(plan, Aggregate):
        need = _expr_columns(plan.group_exprs) | _expr_columns(plan.agg_exprs)
        return Aggregate(_prune(plan.input, need), plan.group_exprs, plan.agg_exprs)
    if isinstance(plan, Sort):
        need = (
            None
            if required is None
            else required | _expr_columns([s.expr for s in plan.sort_exprs])
        )
        return Sort(_prune(plan.input, need), plan.sort_exprs)
    if isinstance(plan, Limit):
        return Limit(_prune(plan.input, required), plan.skip, plan.fetch)
    if isinstance(plan, Distinct):
        return Distinct(_prune(plan.input, required))
    if isinstance(plan, SubqueryAlias):
        if required is None:
            inner_req = None
        else:
            inner_req = {r.rsplit(".", 1)[-1] for r in required}
        return SubqueryAlias(_prune(plan.input, inner_req), plan.alias)
    if isinstance(plan, (Join, CrossJoin)):
        extra: set[str] = set()
        if isinstance(plan, Join):
            for a, b in plan.on:
                extra.update(L.find_columns(a))
                extra.update(L.find_columns(b))
            if plan.filter is not None:
                extra.update(L.find_columns(plan.filter))
        if required is None:
            lreq = rreq = None
        else:
            need = required | extra
            ls, rs = plan.left.schema(), plan.right.schema()
            lq, rq = _qualifiers(plan.left), _qualifiers(plan.right)
            lreq = {n for n in need if _resolvable_on(ls, lq, n)}
            rreq = {n for n in need if _resolvable_on(rs, rq, n)}
        return plan.with_children(
            [_prune(plan.left, lreq), _prune(plan.right, rreq)]
        )
    if isinstance(plan, Window):
        # the input must keep the window's key columns; the window's own
        # output names are produced here, not required below
        if required is None:
            inner_req = None
        else:
            inner_req = {r for r in required if r not in plan.names}
            inner_req |= _expr_columns(
                [e for w in plan.window_exprs for e in w.partition_by]
                + [e for w in plan.window_exprs for e, _, _ in w.order_by]
                + [
                    w.arg
                    for w in plan.window_exprs
                    if w.arg is not None
                ]
            )
        return plan.with_children([_prune(plan.input, inner_req)])
    if isinstance(plan, Union):
        # column pruning across union requires positional mapping; skip.
        return plan.with_children([_prune(c, None) for c in plan.children()])
    if isinstance(plan, Percentile):
        need = _expr_columns(
            list(plan.group_exprs) + [v for v, _, _ in plan.requests]
        )
        return plan.with_children([_prune(plan.input, need)])
    if isinstance(plan, (EmptyRelation,)):
        return plan
    return plan.with_children([_prune(c, required) for c in plan.children()])
