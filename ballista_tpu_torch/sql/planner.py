"""SQL AST -> logical plan.

The DataFusion SQL-planner equivalent (the reference calls DataFusion's
``SessionContext::sql`` at ballista/rust/scheduler/src/scheduler_server/
grpc.rs:376-398). Includes the decorrelation rewrites TPC-H needs:

- uncorrelated scalar subquery  -> CrossJoin against a 1-row aggregate
- correlated scalar subquery    -> Aggregate grouped by correlation keys +
                                   equi-join on those keys (q2, q17, q20)
- [NOT] IN (SELECT ...)         -> SEMI / ANTI equi-join (q16, q18, q20)
- [NOT] EXISTS (SELECT ...)     -> SEMI / ANTI join on correlation keys (q4,
                                   q21, q22), with residual join filter
- COUNT(DISTINCT x)             -> two-level aggregate (q16)
- GROUP BY / ORDER BY aliases   -> substitution from the select list (q8's
                                   ``group by o_year``)
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping

from ballista_tpu_torch.datatypes import DataType, Schema
from ballista_tpu_torch.errors import PlanError, SchemaError
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
    Projection,
    Sort,
    SortExpr,
    Window,
    SubqueryAlias,
    TableScan,
    Union,
)
from ballista_tpu_torch.sql import ast


class Catalog:
    """Table name -> schema resolution (the client-side table registry in
    the reference, ballista/rust/client/src/context.rs:258-308)."""

    def schema_of(self, table: str) -> Schema:
        raise NotImplementedError

    def source_of(self, table: str) -> tuple[str, str, bool, str] | None:
        """(kind, path, has_header, delimiter) for file tables, or None for
        in-memory tables (which only in-proc modes can resolve)."""
        return None

    def has_table(self, table: str) -> bool:
        try:
            self.schema_of(table)
            return True
        except Exception:
            return False


class DictCatalog(Catalog):
    def __init__(self, tables: Mapping[str, Schema]):
        self.tables = dict(tables)

    def schema_of(self, table: str) -> Schema:
        if table not in self.tables:
            raise PlanError(f"table {table!r} not found")
        return self.tables[table]


def _walk_exprs(e: L.Expr):
    yield e
    for c in e.children():
        yield from _walk_exprs(c)


def _split_conjuncts(e: L.Expr) -> list[L.Expr]:
    if isinstance(e, L.BinaryExpr) and e.op == L.Operator.AND:
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _conjoin(parts: list[L.Expr]) -> L.Expr | None:
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = L.BinaryExpr(out, L.Operator.AND, p)
    return out


def _resolvable(schema: Schema, name: str) -> bool:
    try:
        L.resolve_field_index(schema, name)
        return True
    except SchemaError:
        return False


def _rewrite(e: L.Expr, fn) -> L.Expr:
    """Bottom-up expression rewrite."""
    kids = e.children()
    if kids:
        e = e.with_children([_rewrite(c, fn) for c in kids])
    return fn(e)


class SqlPlanner:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        self._sq_counter = itertools.count(1)

    # -- entry ---------------------------------------------------------------
    def plan(self, stmt) -> LogicalPlan:
        if isinstance(stmt, ast.Select):
            return self.plan_select(stmt)
        if isinstance(stmt, ast.SetOp):
            return self.plan_setop(stmt)
        raise PlanError(f"cannot plan statement {type(stmt).__name__}")

    def plan_setop(self, s: ast.SetOp) -> LogicalPlan:
        left = self.plan(s.left)
        right = self.plan(s.right)
        plan: LogicalPlan = Union((left, right), all=True)
        if not s.all:
            plan = Distinct(plan)
        if s.order_by:
            plan = Sort(plan, self._sort_exprs(s.order_by, plan.schema(), {}))
        if s.limit is not None:
            plan = Limit(plan, 0, s.limit)
        return plan

    # -- SELECT --------------------------------------------------------------
    def plan_select(self, s: ast.Select, outer: Schema | None = None) -> LogicalPlan:
        # 1. FROM
        if s.from_ is None:
            plan: LogicalPlan = EmptyRelation(produce_one_row=True)
        else:
            plan = self.plan_table_ref(s.from_)

        # 2. WHERE (with subquery elimination; may add joins)
        if s.where is not None:
            plan, remaining = self._plan_predicate(plan, s.where, outer)
            if remaining is not None:
                plan = Filter(plan, remaining)

        in_schema = plan.schema()

        # 3. select list: expand wildcard, collect aliases
        projections: list[L.Expr] = []
        for p in s.projections:
            if isinstance(p, L.Wildcard):
                projections.extend(L.Column(f.name) for f in in_schema)
            else:
                projections.append(p)
        alias_map = {
            p.aname: p.expr for p in projections if isinstance(p, L.Alias)
        }

        # GROUP BY terms may reference select aliases (q8: group by o_year)
        group_exprs = [
            self._substitute_alias(g, alias_map) for g in s.group_by
        ]
        having = (
            self._substitute_alias(s.having, alias_map)
            if s.having is not None
            else None
        )

        # 4. aggregation
        agg_nodes: list[L.AggregateExpr] = []
        for p in projections:
            agg_nodes.extend(L.find_aggregates(p))
        if having is not None:
            # ScalarSubquery nodes are leaves here; their elimination happens
            # AFTER aggregation (q11: the subquery joins against the
            # aggregate's output, not its input — otherwise the synthetic
            # __sqN column would be dropped by the Aggregate schema).
            agg_nodes.extend(L.find_aggregates(having))
        for ob in s.order_by:
            agg_nodes.extend(L.find_aggregates(ob.expr))

        # 3b. window functions: computed over the post-WHERE rows, appended
        # as synthetic columns the select list then references. Ranking
        # windows mixed with GROUP BY would need the aggregate output as
        # window input — not supported yet, reject loudly.
        window_nodes: list[L.WindowFunction] = []
        for p in projections:
            window_nodes.extend(
                e for e in _walk_exprs(p) if isinstance(e, L.WindowFunction)
            )
        if window_nodes:
            if agg_nodes or group_exprs or any(
                L.find_aggregates(p) for p in projections
            ):
                raise PlanError(
                    "window functions combined with GROUP BY/aggregates "
                    "are not supported yet"
                )
            uniq: list[L.WindowFunction] = []
            for w in window_nodes:
                if not any(w.name() == u.name() for u in uniq):
                    uniq.append(w)
            names = tuple(f"__w{i}" for i in range(len(uniq)))
            plan = Window(plan, tuple(uniq), names)
            by_name = {w.name(): n for w, n in zip(uniq, names)}

            def _sub_window(e: L.Expr) -> L.Expr:
                if isinstance(e, L.WindowFunction):
                    return L.Column(by_name[e.name()])
                kids = e.children()
                if kids:
                    e = e.with_children([_sub_window(c) for c in kids])
                return e

            # a bare top-level window keeps its display name as the output
            # column (not the synthetic __wN), matching aggregate naming
            projections = [
                L.Alias(L.Column(by_name[p.name()]), p.name())
                if isinstance(p, L.WindowFunction)
                else _sub_window(p)
                for p in projections
            ]
            alias_map = {
                p.aname: p.expr
                for p in projections
                if isinstance(p, L.Alias)
            }

        if agg_nodes or group_exprs:
            plan, projections, having = self._plan_aggregate(
                plan, group_exprs, projections, having, alias_map
            )
        if having is not None:
            plan, having = self._plan_predicate(
                plan, having, outer, filter_now=False
            )
            if having is not None:
                plan = Filter(plan, having)

        # 5. projection
        plan = Projection(plan, tuple(projections))

        if s.distinct:
            plan = Distinct(plan)

        # 6. ORDER BY (aliases or projected columns)
        if s.order_by:
            plan = Sort(
                plan, self._sort_exprs(s.order_by, plan.schema(), alias_map)
            )

        # 7. LIMIT / OFFSET
        if s.limit is not None or s.offset:
            plan = Limit(plan, s.offset, s.limit)
        return plan

    # -- FROM ----------------------------------------------------------------
    def plan_table_ref(self, ref: ast.TableRef) -> LogicalPlan:
        if isinstance(ref, ast.Relation):
            schema = self.catalog.schema_of(ref.name)
            source = self.catalog.source_of(ref.name)
            plan: LogicalPlan = TableScan(ref.name, schema, source=source)
            if ref.alias and ref.alias != ref.name:
                plan = SubqueryAlias(plan, ref.alias)
            return plan
        if isinstance(ref, ast.Derived):
            sub = self.plan(ref.query)
            return SubqueryAlias(sub, ref.alias)
        if isinstance(ref, ast.JoinClause):
            left = self.plan_table_ref(ref.left)
            right = self.plan_table_ref(ref.right)
            # bare column-name collisions (e.g. both sides have `id1`) make
            # the joined schema unresolvable; qualify each colliding side
            # with its table name so `x.id1` resolves exactly and a bare
            # `id1` correctly reports ambiguity (DataFusion gets this from
            # qualified DFSchema fields; here qualification is opt-in at
            # the collision site to keep TPC-H-style disjoint schemas bare)
            lnames = {f.name for f in left.schema().fields}
            rnames = {f.name for f in right.schema().fields}
            if lnames & rnames:
                ql = self._qualify(left, ref.left)
                qr = self._qualify(right, ref.right)
                # all-or-nothing: qualifying only one side would let the
                # bare name silently resolve to the unqualified side; left
                # unqualified on BOTH sides, the duplicate-exact-match check
                # in resolve_field_index reports ambiguity instead
                if ql is not left and qr is not right:
                    left, right = ql, qr
            if ref.kind == "cross":
                return CrossJoin(left, right)
            jt = {
                "inner": JoinType.INNER,
                "left": JoinType.LEFT,
                "right": JoinType.RIGHT,
                "full": JoinType.FULL,
            }[ref.kind]
            on_pairs, residual = self._extract_equi_keys(
                ref.on, left.schema(), right.schema()
            )
            if not on_pairs:
                if jt != JoinType.INNER:
                    raise PlanError(
                        f"{ref.kind.upper()} JOIN requires at least one "
                        "equality condition"
                    )
                plan = CrossJoin(left, right)
                if ref.on is not None:
                    plan = Filter(plan, ref.on)
                return plan
            return Join(left, right, tuple(on_pairs), jt, residual)
        raise PlanError(f"unsupported table ref {type(ref).__name__}")

    @staticmethod
    def _qualify(plan: LogicalPlan, ref: ast.TableRef) -> LogicalPlan:
        """Wrap a join input in SubqueryAlias so its fields carry a
        ``table.`` prefix — only when not already qualified."""
        name = None
        if isinstance(ref, ast.Relation):
            name = ref.alias or ref.name
        elif isinstance(ref, ast.Derived):
            name = ref.alias
        if name is None:
            return plan  # nested join etc. — already a mix, leave as-is
        if any("." in f.name for f in plan.schema().fields):
            return plan  # already qualified (explicit alias)
        return SubqueryAlias(plan, name)

    def _extract_equi_keys(
        self, cond: L.Expr | None, ls: Schema, rs: Schema
    ) -> tuple[list[tuple[L.Expr, L.Expr]], L.Expr | None]:
        """Split an ON condition into left=right key pairs + residual."""
        if cond is None:
            return [], None
        pairs: list[tuple[L.Expr, L.Expr]] = []
        residual: list[L.Expr] = []
        for c in _split_conjuncts(cond):
            pair = self._as_equi_pair(c, ls, rs)
            if pair is not None:
                pairs.append(pair)
            else:
                residual.append(c)
        return pairs, _conjoin(residual)

    def _as_equi_pair(
        self, c: L.Expr, ls: Schema, rs: Schema
    ) -> tuple[L.Expr, L.Expr] | None:
        if not (isinstance(c, L.BinaryExpr) and c.op == L.Operator.EQ):
            return None
        a, b = c.left, c.right
        if not (isinstance(a, L.Column) and isinstance(b, L.Column)):
            return None
        a_left = _resolvable(ls, a.cname)
        b_right = _resolvable(rs, b.cname)
        if a_left and b_right:
            return (a, b)
        if _resolvable(rs, a.cname) and _resolvable(ls, b.cname):
            return (b, a)
        return None

    # -- WHERE / subqueries --------------------------------------------------
    def _plan_predicate(
        self,
        plan: LogicalPlan,
        pred: L.Expr,
        outer: Schema | None,
        filter_now: bool = True,
    ) -> tuple[LogicalPlan, L.Expr | None]:
        """Eliminate subquery expressions from a predicate, joining as
        needed. Returns (new plan, remaining predicate or None)."""
        conjuncts = _split_conjuncts(pred)
        remaining: list[L.Expr] = []
        for c in conjuncts:
            plan, rewritten = self._eliminate_subqueries(plan, c, outer)
            if rewritten is not None:
                remaining.append(rewritten)
        return plan, _conjoin(remaining)

    def _eliminate_subqueries(
        self, plan: LogicalPlan, c: L.Expr, outer: Schema | None
    ) -> tuple[LogicalPlan, L.Expr | None]:
        """Handle one conjunct. Returns (plan, residual predicate)."""
        # [NOT] IN (SELECT ...) at conjunct top level -> semi/anti join
        if isinstance(c, ast.InSubquery):
            return self._plan_in_subquery(plan, c), None
        if isinstance(c, ast.Exists):
            return self._plan_exists(plan, c.query, negated=c.negated), None
        if isinstance(c, L.Not) and isinstance(c.expr, ast.Exists):
            return (
                self._plan_exists(plan, c.expr.query, negated=not c.expr.negated),
                None,
            )
        if isinstance(c, L.Not) and isinstance(c.expr, ast.InSubquery):
            inner = c.expr
            return (
                self._plan_in_subquery(
                    plan,
                    ast.InSubquery(inner.expr, inner.query, not inner.negated),
                ),
                None,
            )
        # scalar subqueries anywhere inside the conjunct
        scalars: list[ast.ScalarSubquery] = []

        def find(e: L.Expr) -> None:
            if isinstance(e, ast.ScalarSubquery):
                scalars.append(e)
            for k in e.children():
                find(k)
            if isinstance(e, ast.ScalarSubquery):
                pass

        find(c)
        for sq in scalars:
            plan, replacement = self._plan_scalar_subquery(plan, sq)

            def sub(e: L.Expr, _sq=sq, _r=replacement) -> L.Expr:
                return _r if e is _sq else e

            c = _rewrite(c, sub)
        return plan, c

    def _plan_in_subquery(
        self, plan: LogicalPlan, c: ast.InSubquery
    ) -> LogicalPlan:
        sub = self.plan_select_for_subquery(c.query, plan.schema())
        alias = f"__sq{next(self._sq_counter)}"
        sub_aliased = SubqueryAlias(sub.plan, alias)
        sub_schema = sub_aliased.schema()
        if len(sub.output_cols) != 1:
            raise PlanError("IN subquery must produce exactly one column")
        right_key = L.Column(f"{alias}.{sub.output_cols[0].rsplit('.', 1)[-1]}")
        on = [(c.expr, right_key)]
        # correlation keys become additional join keys
        for (outer_col, inner_col) in sub.correlation:
            on.append(
                (outer_col, L.Column(f"{alias}.{inner_col.rsplit('.', 1)[-1]}"))
            )
        jt = JoinType.ANTI if c.negated else JoinType.SEMI
        return Join(plan, sub_aliased, tuple(on), jt, None)

    def _plan_exists(
        self, plan: LogicalPlan, query: ast.Select, negated: bool
    ) -> LogicalPlan:
        sub = self.plan_select_for_subquery(
            query, plan.schema(), project_correlation=True
        )
        if not sub.correlation:
            raise PlanError("uncorrelated EXISTS is not supported")
        alias = f"__sq{next(self._sq_counter)}"
        sub_aliased = SubqueryAlias(sub.plan, alias)
        on = [
            (outer_col, L.Column(f"{alias}.{inner.rsplit('.', 1)[-1]}"))
            for outer_col, inner in sub.correlation
        ]
        residual = None
        if sub.residual is not None:
            # Residual correlated predicate references subquery columns —
            # requalify inner columns under the alias.
            inner_schema = sub.plan.schema()

            def requal(e: L.Expr) -> L.Expr:
                if isinstance(e, L.Column) and _resolvable(inner_schema, e.cname):
                    return L.Column(f"{alias}.{e.cname.rsplit('.', 1)[-1]}")
                return e

            residual = _rewrite(sub.residual, requal)
        jt = JoinType.ANTI if negated else JoinType.SEMI
        return Join(plan, sub_aliased, tuple(on), jt, residual)

    def _plan_scalar_subquery(
        self, plan: LogicalPlan, sq: ast.ScalarSubquery
    ) -> tuple[LogicalPlan, L.Expr]:
        sub = self.plan_select_for_subquery(sq.query, plan.schema())
        if len(sub.output_cols) != 1:
            raise PlanError("scalar subquery must produce exactly one column")
        alias = f"__sq{next(self._sq_counter)}"
        sub_aliased = SubqueryAlias(sub.plan, alias)
        out_col = L.Column(
            f"{alias}.{sub.output_cols[0].rsplit('.', 1)[-1]}"
        )
        if not sub.correlation:
            # 1-row relation: cross join, no duplication.
            return CrossJoin(plan, sub_aliased), out_col
        on = tuple(
            (outer_col, L.Column(f"{alias}.{inner.rsplit('.', 1)[-1]}"))
            for outer_col, inner in sub.correlation
        )
        return Join(plan, sub_aliased, on, JoinType.INNER, None), out_col

    @dataclasses.dataclass
    class Subplan:
        plan: LogicalPlan
        output_cols: list[str]  # projected output column names
        correlation: list[tuple[L.Column, str]]  # (outer col, inner col name)
        residual: L.Expr | None  # correlated non-equi predicate (EXISTS only)

    def plan_select_for_subquery(
        self,
        q: ast.Select,
        outer_schema: Schema,
        project_correlation: bool = False,
    ) -> "SqlPlanner.Subplan":
        """Plan a subquery, splitting correlated predicates out of WHERE.

        The decorrelation contract: equality conjuncts between an
        outer-schema column and an inner column become correlation keys; for
        aggregate subqueries the inner plan is re-grouped by those keys
        (classic magic-set style rewrite, the shape q2/q17/q20 need).
        """
        if q.from_ is None:
            raise PlanError("subquery requires FROM")
        inner = self.plan_table_ref(q.from_)
        inner_schema = inner.schema()

        correlation: list[tuple[L.Column, str]] = []
        residual: list[L.Expr] = []
        pure: list[L.Expr] = []
        if q.where is not None:
            for c in _split_conjuncts(q.where):
                cols = L.find_columns(c)
                outer_only = [
                    n
                    for n in cols
                    if not _resolvable(inner_schema, n)
                    and _resolvable(outer_schema, n)
                ]
                if not outer_only:
                    pure.append(c)
                    continue
                pair = self._correlation_pair(c, inner_schema, outer_schema)
                if pair is not None:
                    correlation.append(pair)
                else:
                    residual.append(c)

        if not correlation and not residual:
            # Uncorrelated: plan as an ordinary SELECT (handles its own
            # GROUP BY / HAVING — the q18 shape).
            sub_select = ast.Select(
                q.projections, q.distinct, q.from_, _conjoin(pure),
                q.group_by, q.having, q.order_by, q.limit, q.offset,
            )
            plan = self.plan_select(sub_select)
            return SqlPlanner.Subplan(
                plan=plan,
                output_cols=list(plan.schema().names),
                correlation=[],
                residual=None,
            )
        # nested subqueries inside the pure predicates
        plan = inner
        pure_remaining: list[L.Expr] = []
        for c in pure:
            plan, rewritten = self._eliminate_subqueries(plan, c, outer_schema)
            if rewritten is not None:
                pure_remaining.append(rewritten)
        if pure_remaining:
            plan = Filter(plan, _conjoin(pure_remaining))

        inner_corr_names = [ic for _, ic in correlation]

        # aggregate subquery?
        agg_nodes: list[L.AggregateExpr] = []
        projections = [p for p in q.projections]
        for p in projections:
            if not isinstance(p, L.Wildcard):
                agg_nodes.extend(L.find_aggregates(p))

        if agg_nodes:
            if q.group_by:
                raise PlanError(
                    "aggregate subquery with its own GROUP BY is not supported"
                )
            group_cols = [L.Column(n) for n in inner_corr_names]
            plan, projections, _ = self._plan_aggregate(
                plan, group_cols, projections, None, {}
            )
            # projections now reference agg outputs; append correlation keys
            proj_exprs = list(projections) + [
                L.Column(n) for n in inner_corr_names
            ]
            plan = Projection(plan, tuple(proj_exprs))
            out_names = [e.name() for e in projections]
        else:
            out_exprs: list[L.Expr] = []
            for p in projections:
                if isinstance(p, L.Wildcard):
                    if not project_correlation:
                        out_exprs.extend(
                            L.Column(f.name) for f in plan.schema()
                        )
                else:
                    out_exprs.append(p)
            if q.having is not None:
                raise PlanError("HAVING in non-aggregate subquery")
            keep = out_exprs + [
                L.Column(n)
                for n in inner_corr_names
                if not any(
                    isinstance(e, L.Column) and e.cname == n for e in out_exprs
                )
            ]
            # Residual correlated predicates (q21: l2.l_suppkey <>
            # l1.l_suppkey) are evaluated as a join filter AFTER the
            # decorrelation join — their inner columns must survive the
            # projection.
            plan_schema = plan.schema()
            for r in residual:
                for n in L.find_columns(r):
                    if _resolvable(plan_schema, n) and not any(
                        isinstance(e, L.Column) and e.cname == n for e in keep
                    ):
                        keep.append(L.Column(n))
            if q.distinct or True:
                # Semi/anti/inner-join consumers only need distinct keys;
                # dedup protects the unique-build join kernel.
                pass
            plan = Projection(plan, tuple(keep))
            out_names = [e.name() for e in out_exprs]

        if q.having is not None and agg_nodes:
            # HAVING on aggregate subquery (q18): filter after aggregate,
            # before the outer join. Re-plan: the aggregate was built by
            # _plan_aggregate which rewrote HAVING references — handled in
            # plan_select; here support the simple case by re-deriving.
            having_aggs = L.find_aggregates(q.having)
            if having_aggs:
                hav = self._rewrite_against_agg_output(q.having, plan.schema())
                plan = Filter(plan, hav)
            else:
                plan = Filter(plan, q.having)

        return SqlPlanner.Subplan(
            plan=plan,
            output_cols=out_names,
            correlation=correlation,
            residual=_conjoin(residual),
        )

    def _correlation_pair(
        self, c: L.Expr, inner_schema: Schema, outer_schema: Schema
    ) -> tuple[L.Column, str] | None:
        """col_eq conjunct linking one outer column to one inner column."""
        if not (isinstance(c, L.BinaryExpr) and c.op == L.Operator.EQ):
            return None
        a, b = c.left, c.right
        if not (isinstance(a, L.Column) and isinstance(b, L.Column)):
            return None
        a_inner = _resolvable(inner_schema, a.cname)
        b_inner = _resolvable(inner_schema, b.cname)
        if a_inner and not b_inner and _resolvable(outer_schema, b.cname):
            return (b, a.cname)
        if b_inner and not a_inner and _resolvable(outer_schema, a.cname):
            return (a, b.cname)
        return None

    # -- aggregation ---------------------------------------------------------
    def _plan_aggregate(
        self,
        plan: LogicalPlan,
        group_exprs: list[L.Expr],
        projections: list[L.Expr],
        having: L.Expr | None,
        alias_map: dict[str, L.Expr],
    ) -> tuple[LogicalPlan, list[L.Expr], L.Expr | None]:
        """Build Aggregate node; rewrite projections/having to reference its
        output columns."""
        agg_exprs: list[L.AggregateExpr] = []

        def collect(e: L.Expr) -> None:
            for a in L.find_aggregates(e):
                if not any(a.same_as(x) for x in agg_exprs):
                    agg_exprs.append(a)

        for p in projections:
            collect(p)
        if having is not None:
            collect(having)

        # COUNT(DISTINCT x) -> two-level aggregate
        distinct_aggs = [a for a in agg_exprs if a.distinct]
        if distinct_aggs:
            if len(agg_exprs) != len(distinct_aggs):
                raise PlanError(
                    "mixing DISTINCT and plain aggregates is not supported"
                )
            args = {a.arg.name() for a in distinct_aggs}
            if len(args) != 1:
                raise PlanError(
                    "multiple distinct aggregate arguments are not supported"
                )
            arg = distinct_aggs[0].arg
            inner_groups = tuple(group_exprs) + (arg,)
            plan = Aggregate(plan, inner_groups, ())
            # outer aggregate over deduped rows
            new_groups = [L.Column(g.name()) for g in group_exprs]
            rewritten_aggs = []
            for a in distinct_aggs:
                if a.func not in (L.AggFunc.COUNT, L.AggFunc.SUM, L.AggFunc.AVG,
                                  L.AggFunc.MIN, L.AggFunc.MAX):
                    raise PlanError(f"unsupported DISTINCT aggregate {a.func}")
                rewritten_aggs.append(
                    L.AggregateExpr(a.func, L.Column(arg.name()), False)
                )
            agg_plan = Aggregate(plan, tuple(new_groups), tuple(rewritten_aggs))
            out = self._rewrite_projections_against_agg(
                projections, group_exprs, agg_exprs, rewritten_aggs
            )
            hav = (
                self._rewrite_having(having, group_exprs, agg_exprs, rewritten_aggs)
                if having is not None
                else None
            )
            return agg_plan, out, hav

        agg_plan = Aggregate(plan, tuple(group_exprs), tuple(agg_exprs))
        out = self._rewrite_projections_against_agg(
            projections, group_exprs, agg_exprs, agg_exprs
        )
        hav = (
            self._rewrite_having(having, group_exprs, agg_exprs, agg_exprs)
            if having is not None
            else None
        )
        return agg_plan, out, hav

    def _rewrite_projections_against_agg(
        self,
        projections: list[L.Expr],
        group_exprs: list[L.Expr],
        agg_exprs: list[L.AggregateExpr],
        agg_outputs: list[L.AggregateExpr],
    ) -> list[L.Expr]:
        return [
            self._rewrite_one_against_agg(p, group_exprs, agg_exprs, agg_outputs)
            for p in projections
        ]

    def _rewrite_having(
        self, having, group_exprs, agg_exprs, agg_outputs
    ) -> L.Expr:
        return self._rewrite_one_against_agg(
            having, group_exprs, agg_exprs, agg_outputs
        )

    def _rewrite_one_against_agg(
        self,
        e: L.Expr,
        group_exprs: list[L.Expr],
        agg_exprs: list[L.AggregateExpr],
        agg_outputs: list[L.AggregateExpr],
    ) -> L.Expr:
        """Replace aggregate nodes / group expressions with columns of the
        Aggregate output schema."""

        def repl(x: L.Expr) -> L.Expr:
            if isinstance(x, L.AggregateExpr):
                for a, out in zip(agg_exprs, agg_outputs):
                    if x.same_as(a):
                        return L.Column(out.name())
                raise PlanError(f"aggregate {x.name()} not in aggregate node")
            for g in group_exprs:
                if x.same_as(g):
                    return L.Column(g.name())
            return x

        # top-down so whole group-expr subtrees are replaced before their
        # leaves are visited
        def walk(x: L.Expr) -> L.Expr:
            y = repl(x)
            if y is not x:
                return y
            kids = x.children()
            if not kids:
                return x
            return x.with_children([walk(k) for k in kids])

        return walk(e)

    def _rewrite_against_agg_output(self, e: L.Expr, schema: Schema) -> L.Expr:
        def repl(x: L.Expr) -> L.Expr:
            if isinstance(x, L.AggregateExpr) and _resolvable(schema, x.name()):
                return L.Column(x.name())
            return x

        def walk(x: L.Expr) -> L.Expr:
            y = repl(x)
            if y is not x:
                return y
            kids = x.children()
            if not kids:
                return x
            return x.with_children([walk(k) for k in kids])

        return walk(e)

    # -- helpers -------------------------------------------------------------
    def _substitute_alias(self, e: L.Expr, alias_map: dict[str, L.Expr]) -> L.Expr:
        def repl(x: L.Expr) -> L.Expr:
            if isinstance(x, L.Column) and x.cname in alias_map:
                return alias_map[x.cname]
            return x

        return _rewrite(e, repl)

    def _sort_exprs(
        self,
        order_by: tuple[ast.OrderItem, ...],
        schema: Schema,
        alias_map: dict[str, L.Expr],
    ) -> tuple[SortExpr, ...]:
        out = []
        for ob in order_by:
            e = ob.expr
            # positional ORDER BY 1
            if isinstance(e, L.Literal) and isinstance(e.value, int) and e.dtype == DataType.INT64:
                idx = e.value - 1
                if not (0 <= idx < len(schema)):
                    raise PlanError(f"ORDER BY position {e.value} out of range")
                e = L.Column(schema.fields[idx].name)
            elif isinstance(e, L.Column):
                if not _resolvable(schema, e.cname):
                    raise PlanError(
                        f"ORDER BY column {e.cname!r} is not in the select "
                        f"list; available: {schema.names}"
                    )
            else:
                # expression ORDER BY: must match a projected expression name
                if _resolvable(schema, e.name()):
                    e = L.Column(e.name())
                else:
                    raise PlanError(
                        f"ORDER BY expression {e.name()!r} must appear in the "
                        "select list"
                    )
            default_nulls_first = not ob.ascending  # SQL default
            out.append(
                SortExpr(
                    e,
                    ob.ascending,
                    ob.nulls_first
                    if ob.nulls_first is not None
                    else default_nulls_first,
                )
            )
        return tuple(out)
