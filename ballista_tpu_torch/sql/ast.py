"""SQL statement AST (between the parser and the logical planner).

Expressions reuse :mod:`ballista_tpu.expr.logical` directly; the three
subquery forms that cannot exist in a compiled expression (scalar subquery,
IN (SELECT ...), EXISTS) are represented by placeholder Expr subclasses here
and eliminated by the planner's decorrelation pass.
"""

from __future__ import annotations

import dataclasses

from ballista_tpu_torch.datatypes import DataType, Schema
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.expr import logical as L


# -- subquery expression placeholders ----------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ScalarSubquery(L.Expr):
    query: "Select"

    def data_type(self, schema: Schema) -> DataType:
        raise PlanError("scalar subquery must be decorrelated before typing")

    def nullable(self, schema: Schema) -> bool:
        return True

    def name(self) -> str:
        return "(<scalar subquery>)"


@dataclasses.dataclass(frozen=True, eq=False)
class InSubquery(L.Expr):
    expr: L.Expr
    query: "Select"
    negated: bool

    def data_type(self, schema: Schema) -> DataType:
        return DataType.BOOL

    def nullable(self, schema: Schema) -> bool:
        return False

    def name(self) -> str:
        neg = "NOT " if self.negated else ""
        return f"{self.expr.name()} {neg}IN (<subquery>)"

    def children(self) -> list[L.Expr]:
        return [self.expr]

    def with_children(self, children):
        return InSubquery(children[0], self.query, self.negated)


@dataclasses.dataclass(frozen=True, eq=False)
class Exists(L.Expr):
    query: "Select"
    negated: bool

    def data_type(self, schema: Schema) -> DataType:
        return DataType.BOOL

    def nullable(self, schema: Schema) -> bool:
        return False

    def name(self) -> str:
        return f"{'NOT ' if self.negated else ''}EXISTS (<subquery>)"


# -- relations ----------------------------------------------------------------


class TableRef:
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class Relation(TableRef):
    name: str
    alias: str | None = None


@dataclasses.dataclass(frozen=True, eq=False)
class Derived(TableRef):
    query: "Select | SetOp"
    alias: str


@dataclasses.dataclass(frozen=True, eq=False)
class JoinClause(TableRef):
    left: TableRef
    right: TableRef
    kind: str  # inner | left | right | full | cross
    on: L.Expr | None


# -- statements ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class OrderItem:
    expr: L.Expr
    ascending: bool
    nulls_first: bool | None  # None = SQL default (LAST for ASC, FIRST for DESC)


@dataclasses.dataclass(frozen=True, eq=False)
class Select:
    projections: tuple[L.Expr, ...]  # L.Wildcard() for *
    distinct: bool
    from_: TableRef | None
    where: L.Expr | None
    group_by: tuple[L.Expr, ...]
    having: L.Expr | None
    order_by: tuple[OrderItem, ...]
    limit: int | None
    offset: int


@dataclasses.dataclass(frozen=True, eq=False)
class SetOp:
    op: str  # "union"
    all: bool
    left: "Select | SetOp"
    right: "Select | SetOp"
    order_by: tuple[OrderItem, ...] = ()
    limit: int | None = None


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnDef:
    name: str
    dtype: DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True, eq=False)
class CreateExternalTable:
    name: str
    columns: tuple[ColumnDef, ...] | None  # None = infer from file
    stored_as: str  # csv | parquet
    has_header: bool
    location: str
    delimiter: str = ","
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class DropTable:
    name: str
    if_exists: bool


@dataclasses.dataclass(frozen=True, eq=False)
class ShowTables:
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class ShowColumns:
    table: str


@dataclasses.dataclass(frozen=True, eq=False)
class Explain:
    verbose: bool
    query: "Select | SetOp"
    # EXPLAIN VERIFY: run the static plan verifier
    # (ballista_tpu/analysis/verifier.py) and print its report alongside
    # the plans instead of executing anything
    verify: bool = False
    # EXPLAIN ANALYZE: EXECUTE the query with per-operator metering
    # (ballista_tpu/obs/profile.py) and re-print the physical plan
    # annotated with measured rows/bytes/elapsed per operator
    analyze: bool = False


Statement = (
    Select
    | SetOp
    | CreateExternalTable
    | DropTable
    | ShowTables
    | ShowColumns
    | Explain
)
