"""Serde-closure audit: prove the proto vocabulary is TOTAL.

Structurally enumerates every logical plan node class, physical operator
class, and expression class the engine defines, auto-generates round-trip
exemplar instances for each, and asserts:

1. **Coverage** — every class either round-trips through the codec or is
   named in an explicit exemption table with a reason. A new node class
   added without serde (or without a deliberate exemption) fails the
   tier-1 suite at collection time instead of failing a distributed job at
   executor runtime (the MeshSort ``fetch=None`` class of bug).
2. **Byte stability** — ``encode(decode(encode(x))) == encode(x)``, which
   catches defaulted/optional proto fields silently dropped on one side of
   the round trip (display-string comparison alone misses fields that do
   not render).
3. **Display fidelity** — the decoded plan renders identically.

Run as a tier-1 test (tests/test_torch_serde_closure.py) or ad hoc via
``python -m ballista_tpu_torch.analysis.serde_audit``.

The port's copy of ``ballista_tpu/analysis/serde_audit.py``: the same
exemplars and exemptions over the port's classes and codec. The port has
no mesh operators (``exec/mesh.py`` is not ported), so it has no mesh
exemplars and needs no exemption for them.
"""

from __future__ import annotations

import dataclasses

from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.plan import logical as P

# classes deliberately OUTSIDE the serde vocabulary; each needs a reason
# (the audit fails on any class that is neither covered nor listed here)
EXEMPT_PHYSICAL: dict[str, str] = {
    "_StagedFileScanExec": "abstract staged-scan base; csv/avro subclasses "
    "carry the wire format",
}
EXEMPT_LOGICAL: dict[str, str] = {}
EXEMPT_EXPR: dict[str, str] = {
    "WindowFunction": "serialized via WindowExprNode inside Window plan "
    "nodes (audited separately below), never as a bare ExprNode",
}


@dataclasses.dataclass
class AuditResult:
    domain: str  # "expr" | "logical" | "physical"
    covered: list[str]
    exempt: dict[str, str]
    missing: list[str]  # classes with neither round-trip nor exemption
    failures: list[str]  # round-trip breakages

    @property
    def ok(self) -> bool:
        return not self.missing and not self.failures

    def summary(self) -> str:
        s = (
            f"{self.domain}: {len(self.covered)} classes round-tripped, "
            f"{len(self.exempt)} exempt"
        )
        if self.missing:
            s += f"; MISSING serde coverage: {sorted(self.missing)}"
        if self.failures:
            s += "; FAILURES:\n  " + "\n  ".join(self.failures)
        return s


def _subclasses(base: type) -> set[type]:
    out: set[type] = set()

    def walk(c: type) -> None:
        for s in c.__subclasses__():
            if s not in out:
                out.add(s)
                walk(s)

    walk(base)
    return out


def _import_operator_modules() -> None:
    """Import every module that may define ExecutionPlan subclasses.

    ``__subclasses__`` only sees classes whose defining module has been
    imported — without this sweep, a new ``exec/newop.py`` operator would
    be invisible to the closure audit and the 'vocabulary is TOTAL' claim
    would be silently hollow. Import errors propagate: a broken operator
    module must fail the audit loudly, not hide its classes."""
    import importlib
    import pkgutil

    import ballista_tpu_torch.distributed_plan  # noqa: F401
    import ballista_tpu_torch.exec as exec_pkg
    import ballista_tpu_torch.executor as executor_pkg

    for pkg in (exec_pkg, executor_pkg):
        for m in pkgutil.iter_modules(pkg.__path__):
            if m.name.startswith("__"):
                continue
            importlib.import_module(f"{pkg.__name__}.{m.name}")


# -------------------------------------------------------------- exprs -----

_COL = L.Column("a")
_COLB = L.Column("b")
_LIT = L.Literal(3, DataType.INT64)
_PRED = L.BinaryExpr(_COL, L.Operator.GT, _LIT)


def _expr_exemplars() -> dict[str, list[L.Expr]]:
    return {
        "Column": [L.Column("a"), L.Column("t.a")],
        "Literal": [
            L.Literal(None, DataType.NULL),
            L.Literal(None, DataType.INT64),
            L.Literal(False, DataType.BOOL),
            L.Literal(0, DataType.INT32),
            L.Literal(-7, DataType.INT64),
            L.Literal(0.0, DataType.FLOAT64),
            L.Literal(1.5, DataType.FLOAT32),
            L.Literal("", DataType.STRING),
            L.Literal("x'y", DataType.STRING),
            L.Literal(0, DataType.DATE32),
            L.Literal(-1, DataType.TIMESTAMP_US),
        ],
        "IntervalLiteral": [L.IntervalLiteral(0, 0), L.IntervalLiteral(13, -2)],
        "BinaryExpr": [
            L.BinaryExpr(_COL, op, _LIT) for op in L.Operator
        ],
        "Not": [L.Not(_PRED)],
        "Negative": [L.Negative(_COL)],
        "IsNull": [L.IsNull(_COL)],
        "IsNotNull": [L.IsNotNull(_COL)],
        "Cast": [L.Cast(_COL, dt) for dt in DataType],
        "Case": [
            L.Case((), _LIT),
            L.Case(((_PRED, _LIT),), None),
            L.Case(((_PRED, _LIT), (L.IsNull(_COL), _COLB)), _COL),
        ],
        "InList": [
            L.InList(_COL, (), False),
            L.InList(_COL, (_LIT, L.Literal(4, DataType.INT64)), True),
        ],
        "Between": [L.Between(_COL, _LIT, _COLB, True)],
        "Like": [L.Like(_COL, "a%_b", True), L.Like(_COL, "", False)],
        "Alias": [L.Alias(_PRED, "p")],
        "Wildcard": [L.Wildcard()],
        "AggregateExpr": (
            [L.AggregateExpr(f, _COL) for f in L.AggFunc]
            + [
                L.AggregateExpr(L.AggFunc.COUNT, L.Wildcard()),
                L.AggregateExpr(L.AggFunc.SUM, _COL, distinct=True),
                L.AggregateExpr(L.AggFunc.CORR, _COL, arg2=_COLB),
            ]
        ),
        "PercentileExpr": [
            L.PercentileExpr(_COL, 0.0),
            L.PercentileExpr(_COL, 0.5),
            L.PercentileExpr(_COL, 1.0),
        ],
        "UdafExpr": [L.UdafExpr("my_agg", _COL)],
        "ScalarFunction": [
            L.ScalarFunction("abs", (_COL,)),
            L.ScalarFunction("coalesce", (_COL, _LIT)),
            L.ScalarFunction("substr", (_COL, _LIT, _LIT)),
        ],
    }


def _window_exemplars() -> list[L.WindowFunction]:
    return [
        L.WindowFunction("row_number", (), ((_COLB, False, None),)),
        L.WindowFunction(
            "dense_rank", (_COL,), ((_COLB, True, True),), offset=1
        ),
        L.WindowFunction("lag", (_COL,), ((_COLB, True, False),), arg=_COLB,
                         offset=0),
        L.WindowFunction("lead", (), ((_COLB, True, None),), arg=_COLB,
                         offset=3),
        L.WindowFunction(
            "sum",
            (_COL,),
            ((_COLB, True, None),),
            arg=_COLB,
            frame=L.WindowFrame("rows", "p", 2, "f", 1),
        ),
        L.WindowFunction(
            "count",
            (),
            (),
            arg=_COL,
            frame=L.WindowFrame("range", "up", 0, "cur", 0),
        ),
    ]


def audit_expressions() -> AuditResult:
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.serde import (
        _window_expr_from_proto,
        _window_expr_to_proto,
        expr_from_proto,
        expr_to_proto,
    )

    exemplars = _expr_exemplars()
    covered: list[str] = []
    failures: list[str] = []
    for cname, instances in exemplars.items():
        ok = True
        for e in instances:
            try:
                enc = expr_to_proto(e).SerializeToString()
                back = expr_from_proto(pb.ExprNode.FromString(enc))
                enc2 = expr_to_proto(back).SerializeToString()
            except Exception as exc:  # noqa: BLE001 — report, don't abort
                failures.append(f"{cname} {e!r}: {type(exc).__name__}: {exc}")
                ok = False
                continue
            if enc2 != enc:
                failures.append(
                    f"{cname} {e.name()!r}: re-encode differs (field "
                    "dropped or defaulted across the round trip)"
                )
                ok = False
            elif back.name() != e.name():
                failures.append(
                    f"{cname}: display drift {e.name()!r} -> {back.name()!r}"
                )
                ok = False
        if ok:
            covered.append(cname)
    # WindowFunction rides WindowExprNode
    for wf in _window_exemplars():
        try:
            enc = _window_expr_to_proto(wf).SerializeToString()
            back = _window_expr_from_proto(pb.WindowExprNode.FromString(enc))
            enc2 = _window_expr_to_proto(back).SerializeToString()
        except Exception as exc:  # noqa: BLE001
            failures.append(
                f"WindowFunction {wf.name()!r}: {type(exc).__name__}: {exc}"
            )
            continue
        if enc2 != enc or back.name() != wf.name():
            failures.append(
                f"WindowFunction {wf.name()!r}: round trip drift"
            )
    all_classes = {
        c.__name__ for c in _subclasses(L.Expr) if c.__module__ == L.__name__
    }
    missing = sorted(
        all_classes - set(covered) - set(EXEMPT_EXPR) - set(exemplars)
    )
    return AuditResult("expr", covered, EXEMPT_EXPR, missing, failures)


# ------------------------------------------------------------ logical -----

_SCHEMA = Schema(
    [
        Field("a", DataType.INT64, False),
        Field("b", DataType.FLOAT64),
        Field("s", DataType.STRING),
    ]
)
_SCHEMA2 = Schema([Field("k", DataType.INT64, False), Field("w", DataType.FLOAT64)])


def _logical_exemplars() -> dict[str, list[P.LogicalPlan]]:
    scan = P.TableScan("t", _SCHEMA)
    scan2 = P.TableScan("d", _SCHEMA2)
    fscan = P.TableScan(
        "f",
        _SCHEMA,
        projection=("a", "b"),
        filters=(_PRED,),
        source=("csv", "/data/f.csv", True, "|"),
    )
    return {
        "TableScan": [scan, fscan, P.TableScan("p", _SCHEMA, (),
                      source=("parquet", "/data/p.parquet", False, ","))],
        "EmptyRelation": [
            P.EmptyRelation(True, Schema([])),
            P.EmptyRelation(False, _SCHEMA2),
        ],
        "Projection": [P.Projection(scan, (_COL, L.Alias(_PRED, "p")))],
        "Filter": [P.Filter(scan, _PRED)],
        "Aggregate": [
            P.Aggregate(
                scan,
                (_COL,),
                (L.AggregateExpr(L.AggFunc.SUM, _COLB),),
            ),
            P.Aggregate(scan, (), (L.AggregateExpr(L.AggFunc.COUNT, L.Wildcard()),)),
        ],
        "Sort": [
            P.Sort(scan, (P.SortExpr(_COL, False, True),
                          P.SortExpr(_COLB, True, False))),
        ],
        "Limit": [P.Limit(scan, 0, None), P.Limit(scan, 5, 0), P.Limit(scan, 0, 7)],
        "Join": [
            P.Join(scan, scan2, ((_COL, L.Column("k")),), P.JoinType.INNER),
            P.Join(
                scan, scan2, ((_COL, L.Column("k")),), P.JoinType.LEFT,
                filter=L.BinaryExpr(_COLB, L.Operator.LT, L.Column("w")),
            ),
            P.Join(scan, scan2, ((_COL, L.Column("k")),), P.JoinType.ANTI),
        ],
        "CrossJoin": [P.CrossJoin(scan, scan2)],
        "Union": [P.Union((scan, scan), all=True), P.Union((scan, scan), all=False)],
        "Distinct": [P.Distinct(scan)],
        "Window": [
            P.Window(scan, tuple(_window_exemplars()[:2]), ("rn", "dr")),
        ],
        "Percentile": [
            P.Percentile(
                scan, (_COL,), ("g0",), ((_COLB, 0.5, "p50"), (_COLB, 0.9, "p90"))
            ),
        ],
        "SubqueryAlias": [P.SubqueryAlias(scan, "x")],
    }


def audit_logical() -> AuditResult:
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.serde import logical_from_proto, logical_to_proto

    covered: list[str] = []
    failures: list[str] = []
    exemplars = _logical_exemplars()
    for cname, plans in exemplars.items():
        ok = True
        for plan in plans:
            try:
                enc = logical_to_proto(plan).SerializeToString()
                back = logical_from_proto(pb.LogicalPlanNode.FromString(enc))
                enc2 = logical_to_proto(back).SerializeToString()
            except Exception as exc:  # noqa: BLE001
                failures.append(
                    f"{cname} [{plan.describe()}]: {type(exc).__name__}: {exc}"
                )
                ok = False
                continue
            if enc2 != enc:
                failures.append(
                    f"{cname} [{plan.describe()}]: re-encode differs (field "
                    "dropped or defaulted across the round trip)"
                )
                ok = False
            elif back.display() != plan.display():
                failures.append(
                    f"{cname}: display drift\n{plan.display()}\n--\n"
                    f"{back.display()}"
                )
                ok = False
        if ok:
            covered.append(cname)
    all_classes = {
        c.__name__
        for c in _subclasses(P.LogicalPlan)
        if c.__module__ == P.__name__
    }
    missing = sorted(
        all_classes - set(covered) - set(EXEMPT_LOGICAL) - set(exemplars)
    )
    return AuditResult("logical", covered, EXEMPT_LOGICAL, missing, failures)


# ----------------------------------------------------------- physical -----


def _physical_exemplars(ctx):
    """Exemplar ExecutionPlan trees covering the full serde vocabulary.

    ``ctx`` is a TorchContext with tables 't' (_SCHEMA) and 'd' (_SCHEMA2)
    registered — memory scans resolve through it on decode, mirroring the
    distributed provider contract."""
    from ballista_tpu_torch.distributed_plan import UnresolvedShuffleExec
    from ballista_tpu_torch.exec.aggregate import HashAggregateExec
    from ballista_tpu_torch.exec.joins import (
        CrossJoinExec,
        EmptyExec,
        HashJoinExec,
        UnionExec,
    )
    from ballista_tpu_torch.exec.percentile import PercentileExec
    from ballista_tpu_torch.exec.pipeline import (
        CoalescePartitionsExec,
        FilterExec,
        ProjectionExec,
        RenameExec,
    )
    from ballista_tpu_torch.exec.repartition import HashRepartitionExec
    from ballista_tpu_torch.exec.scan import AvroScanExec, CsvScanExec, ParquetScanExec
    from ballista_tpu_torch.exec.sort import GlobalLimitExec, SortExec
    from ballista_tpu_torch.exec.window import WindowExec
    from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec
    from ballista_tpu_torch.executor.reader import ShuffleReaderExec
    from ballista_tpu_torch.scheduler_types import PartitionLocation

    def mem():
        s = ctx.scan("t", None, 2)
        s.table_name = "t"  # the physical planner stamps this on real plans
        return s

    def mem2():
        s = ctx.scan("d", None, 2)
        s.table_name = "d"
        return s

    csv = CsvScanExec("/data/f.csv", _SCHEMA, True, "|", ["a", "b"], 2)
    csv.table_name = "f"  # planner-stamped; decode must preserve it
    pq = ParquetScanExec("/data/p.parquet", _SCHEMA, None, 3, predicates=[_PRED])
    pq.table_name = "p"
    avro = AvroScanExec("/data/a.avro", _SCHEMA, None, 1)
    partial = HashAggregateExec(
        mem(), [_COL], [L.AggregateExpr(L.AggFunc.SUM, _COLB)], mode="partial"
    )
    final = HashAggregateExec(
        CoalescePartitionsExec(partial),
        [_COL],
        [L.AggregateExpr(L.AggFunc.SUM, _COLB)],
        mode="final",
        spec=partial.spec,
        planned_input_schema=partial.planned_input_schema,
    )
    join_on = [(_COL, L.Column("k"))]
    loc = PartitionLocation(
        job_id="j1", stage_id=1, partition=0, executor_id="e1",
        host="h", port=50050, path="/w/p0.arrow",
    )
    plans = [
        mem(),
        csv,
        pq,
        avro,
        FilterExec(mem(), _PRED),
        ProjectionExec(mem(), [_COL, L.Alias(_PRED, "p")]),
        partial,
        final,
        SortExec(mem(), [P.SortExpr(_COL, False, True)], None),
        SortExec(mem(), [P.SortExpr(_COL)], 5),
        GlobalLimitExec(CoalescePartitionsExec(mem()), 2, 9),
        GlobalLimitExec(CoalescePartitionsExec(mem()), 0, None),
        HashJoinExec(mem(), mem2(), join_on, P.JoinType.INNER),
        HashJoinExec(
            mem(), mem2(), join_on, P.JoinType.LEFT,
            filter=L.BinaryExpr(_COLB, L.Operator.LT, L.Column("w")),
        ),
        HashJoinExec(
            HashRepartitionExec(mem(), [_COL], 4),
            HashRepartitionExec(mem2(), [L.Column("k")], 4),
            join_on, P.JoinType.SEMI, partition_mode="partitioned",
        ),
        HashRepartitionExec(mem(), [_COL, _COLB], 3),
        CrossJoinExec(mem(), mem2()),
        UnionExec([mem(), mem()]),
        RenameExec(mem(), Schema([Field(f"x.{f.name}", f.dtype, f.nullable)
                                  for f in _SCHEMA])),
        CoalescePartitionsExec(mem()),
        WindowExec(mem(), list(_window_exemplars()[:2]), ["rn", "dr"]),
        PercentileExec(mem(), [_COL], ["g0"], [(_COLB, 0.5, "p50")]),
        EmptyExec(True, Schema([])),
        EmptyExec(False, _SCHEMA2),
        ShuffleWriterExec("job1", 3, HashRepartitionExec(mem(), [_COL], 4),
                          [_COL], 4),
        ShuffleWriterExec("job1", 4, mem(), [], 1),
        ShuffleReaderExec([[loc], []], _SCHEMA),
        UnresolvedShuffleExec(2, _SCHEMA, 3, 4),
    ]
    return plans


def audit_physical(ctx=None, device: str = "cpu") -> AuditResult:
    """Round-trip the physical vocabulary through BallistaCodec and check
    class coverage. A fresh single-process TorchContext on ``device``
    serves as the memory provider when none is given."""
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.serde import BallistaCodec

    if ctx is None:
        import pyarrow as pa

        from ballista_tpu_torch.exec.context import TorchContext

        ctx = TorchContext(device=device)
        ctx.register_table(
            "t", pa.table({"a": [1, 2], "b": [0.5, 1.5], "s": ["x", "y"]})
        )
        ctx.register_table("d", pa.table({"k": [1], "w": [2.0]}))

    codec = BallistaCodec(provider=ctx)
    covered: set[str] = set()
    failures: list[str] = []
    for plan in _physical_exemplars(ctx):
        observed = {type(p).__name__ for p in _walk_plan(plan)}
        try:
            enc = codec.physical_to_proto(plan).SerializeToString()
            back = codec.physical_from_proto(pb.PhysicalPlanNode.FromString(enc))
            enc2 = codec.physical_to_proto(back).SerializeToString()
        except Exception as exc:  # noqa: BLE001
            failures.append(
                f"[{plan.describe()}]: {type(exc).__name__}: {exc}"
            )
            continue
        if enc2 != enc:
            failures.append(
                f"[{plan.describe()}]: re-encode differs (field dropped "
                "or defaulted across the round trip)"
            )
        elif back.display() != plan.display():
            failures.append(
                f"display drift:\n{plan.display()}\n--\n{back.display()}"
            )
        else:
            covered |= observed
    from ballista_tpu_torch.exec.base import ExecutionPlan

    _import_operator_modules()
    all_classes = {
        c.__name__
        for c in _subclasses(ExecutionPlan)
        if c.__module__.startswith("ballista_tpu_torch.")
    }
    missing = sorted(all_classes - covered - set(EXEMPT_PHYSICAL))
    return AuditResult(
        "physical", sorted(covered), EXEMPT_PHYSICAL, missing, failures
    )


def _walk_plan(plan):
    yield plan
    for c in plan.children():
        yield from _walk_plan(c)


def main() -> int:
    results = [audit_expressions(), audit_logical(), audit_physical()]
    ok = True
    for r in results:
        print(r.summary())
        ok = ok and r.ok
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
