"""Recursive-descent SQL parser.

Grammar coverage is driven by the reference's workload: all 22 TPC-H queries
(benchmarks/queries/ in the reference), the reference client's intercepted
DDL (CREATE EXTERNAL TABLE / SHOW — ref
ballista/rust/client/src/context.rs:311-435), and EXPLAIN.

Expressions parse with standard SQL precedence:
OR < AND < NOT < (comparison | BETWEEN | IN | LIKE | IS) < +- < */% < unary.
"""

from __future__ import annotations

import datetime

from ballista_tpu_torch.datatypes import DataType
from ballista_tpu_torch.errors import SqlError
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.sql import ast
from ballista_tpu_torch.sql.lexer import Tok, Token, tokenize

_TYPE_NAMES: dict[str, DataType] = {
    "int": DataType.INT32,
    "integer": DataType.INT32,
    "smallint": DataType.INT32,
    "tinyint": DataType.INT32,
    "bigint": DataType.INT64,
    "float": DataType.FLOAT32,
    "real": DataType.FLOAT32,
    "double": DataType.FLOAT64,
    "decimal": DataType.FLOAT64,
    "numeric": DataType.FLOAT64,
    "varchar": DataType.STRING,
    "char": DataType.STRING,
    "text": DataType.STRING,
    "string": DataType.STRING,
    "date": DataType.DATE32,
    "timestamp": DataType.TIMESTAMP_US,
    "boolean": DataType.BOOL,
    "bool": DataType.BOOL,
}

_AGG_NAMES = {f.value for f in L.AggFunc}


def parse_sql(sql: str) -> ast.Statement:
    """Parse one SQL statement (a trailing ``;`` is tolerated)."""
    return Parser(sql).parse_statement()


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers -------------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != Tok.EOF:
            self.i += 1
        return t

    def accept_kw(self, *words: str) -> bool:
        if self.peek().is_kw(*words):
            self.next()
            return True
        return False

    def expect_kw(self, *words: str) -> Token:
        t = self.next()
        if not t.is_kw(*words):
            raise SqlError(
                f"expected {'/'.join(words).upper()} but found "
                f"{t.value!r} at offset {t.pos}"
            )
        return t

    def accept_punct(self, p: str) -> bool:
        t = self.peek()
        if t.kind == Tok.PUNCT and t.value == p:
            self.next()
            return True
        return False

    def expect_punct(self, p: str) -> None:
        t = self.next()
        if not (t.kind == Tok.PUNCT and t.value == p):
            raise SqlError(f"expected {p!r} but found {t.value!r} at offset {t.pos}")

    def accept_op(self, *ops: str) -> str | None:
        t = self.peek()
        if t.kind == Tok.OP and t.value in ops:
            self.next()
            return t.value
        return None

    def expect_ident(self) -> str:
        t = self.next()
        # Non-reserved keywords usable as identifiers (e.g. a column named
        # "year"): allow keywords where an identifier is required, except
        # structural ones that would mask real syntax errors.
        if t.kind == Tok.IDENT:
            return t.value
        if t.kind == Tok.KEYWORD and t.value in (
            "year", "month", "day", "date", "timestamp", "first", "last",
            "location", "tables", "columns", "row", "values", "over",
            "partition", "rows", "range", "unbounded", "preceding",
            "following", "current",
        ):
            return t.value
        raise SqlError(f"expected identifier but found {t.value!r} at offset {t.pos}")

    # -- statements ----------------------------------------------------------
    def parse_table_name(self) -> str:
        """A possibly schema-qualified table name (``system.queries``):
        dot-joined identifiers stored as ONE flat registry name — the
        catalog has no schema hierarchy, the dotted string IS the key
        (docs/observability.md system tables)."""
        name = self.expect_ident()
        while self.accept_punct("."):
            name = f"{name}.{self.expect_ident()}"
        return name

    def parse_statement(self) -> ast.Statement:
        stmt = self._statement()
        self.accept_punct(";")
        if self.peek().kind != Tok.EOF:
            t = self.peek()
            raise SqlError(f"unexpected {t.value!r} after statement at offset {t.pos}")
        return stmt

    def _statement(self) -> ast.Statement:
        t = self.peek()
        if t.is_kw("select") or (t.kind == Tok.PUNCT and t.value == "("):
            return self.parse_query()
        if t.is_kw("create"):
            return self.parse_create()
        if t.is_kw("drop"):
            return self.parse_drop()
        if t.is_kw("show"):
            return self.parse_show()
        if t.is_kw("describe"):
            self.next()
            return ast.ShowColumns(self.parse_table_name())
        if t.is_kw("explain"):
            self.next()
            verbose = self.accept_kw("verbose")
            # VERIFY is contextual (only meaningful right after
            # EXPLAIN [VERBOSE]), NOT a reserved word — `select verify
            # from t` must keep parsing as an identifier. ANALYZE is
            # already a lexer keyword, so it accepts as one.
            verify = False
            nt = self.peek()
            if nt.kind == Tok.IDENT and nt.value.lower() == "verify":
                self.next()
                verify = True
            analyze = not verify and self.accept_kw("analyze")
            return ast.Explain(
                verbose, self.parse_query(), verify=verify, analyze=analyze
            )
        raise SqlError(f"unsupported statement starting with {t.value!r}")

    def parse_create(self) -> ast.CreateExternalTable:
        self.expect_kw("create")
        self.expect_kw("external")
        self.expect_kw("table")
        if_not_exists = False
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        name = self.expect_ident()
        columns = None
        if self.accept_punct("("):
            cols = []
            while True:
                cname = self.expect_ident()
                dtype = self.parse_type_name()
                nullable = True
                if self.accept_kw("not"):
                    self.expect_kw("null")
                    nullable = False
                cols.append(ast.ColumnDef(cname, dtype, nullable))
                if not self.accept_punct(","):
                    break
            self.expect_punct(")")
            columns = tuple(cols)
        self.expect_kw("stored")
        self.expect_kw("as")
        fmt_tok = self.next()
        stored_as = fmt_tok.value.lower()
        if stored_as not in ("csv", "parquet", "avro"):
            raise SqlError(f"unsupported storage format {stored_as!r}")
        has_header = False
        delimiter = ","
        while True:
            if self.accept_kw("with"):
                self.expect_kw("header")
                self.expect_kw("row")
                has_header = True
            elif self.accept_kw("delimiter"):
                delimiter = self.next().value
            else:
                break
        self.expect_kw("location")
        loc = self.next()
        if loc.kind != Tok.STRING:
            raise SqlError("LOCATION requires a quoted path")
        return ast.CreateExternalTable(
            name, columns, stored_as, has_header, loc.value, delimiter,
            if_not_exists,
        )

    def parse_drop(self) -> ast.DropTable:
        self.expect_kw("drop")
        self.expect_kw("table")
        if_exists = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        return ast.DropTable(self.parse_table_name(), if_exists)

    def parse_show(self) -> ast.Statement:
        self.expect_kw("show")
        if self.accept_kw("tables"):
            return ast.ShowTables()
        if self.accept_kw("columns"):
            self.expect_kw("from")
            return ast.ShowColumns(self.parse_table_name())
        raise SqlError("expected SHOW TABLES or SHOW COLUMNS FROM <table>")

    def parse_type_name(self) -> DataType:
        t = self.next()
        name = t.value.lower()
        if name == "double" and self.peek().kind == Tok.IDENT and self.peek().value == "precision":
            self.next()
        dtype = _TYPE_NAMES.get(name)
        if dtype is None:
            raise SqlError(f"unknown type name {t.value!r} at offset {t.pos}")
        if self.accept_punct("("):  # varchar(n) / decimal(p,s)
            self.next()
            if self.accept_punct(","):
                self.next()
            self.expect_punct(")")
        return dtype

    # -- queries -------------------------------------------------------------
    def parse_query(self) -> "ast.Select | ast.SetOp":
        left = self.parse_query_term()
        while self.peek().is_kw("union"):
            self.next()
            all_ = self.accept_kw("all")
            right = self.parse_query_term()
            left = ast.SetOp("union", all_, left, right)
        # trailing ORDER BY / LIMIT bind to the whole set expression
        order_by = self.parse_order_by()
        limit, offset = self.parse_limit_offset()
        if isinstance(left, ast.SetOp):
            if order_by or limit is not None:
                left = ast.SetOp(
                    left.op, left.all, left.left, left.right,
                    tuple(order_by), limit,
                )
            return left
        if order_by or limit is not None or offset:
            left = ast.Select(
                left.projections, left.distinct, left.from_, left.where,
                left.group_by, left.having,
                tuple(order_by) or left.order_by,
                limit if limit is not None else left.limit,
                offset or left.offset,
            )
        return left

    def parse_query_term(self) -> "ast.Select | ast.SetOp":
        if self.accept_punct("("):
            q = self.parse_query()
            self.expect_punct(")")
            return q
        return self.parse_select()

    def parse_select(self) -> ast.Select:
        self.expect_kw("select")
        distinct = self.accept_kw("distinct")
        self.accept_kw("all")
        projections = [self.parse_select_item()]
        while self.accept_punct(","):
            projections.append(self.parse_select_item())
        from_ = None
        if self.accept_kw("from"):
            from_ = self.parse_table_refs()
        where = self.parse_expr() if self.accept_kw("where") else None
        group_by: list[L.Expr] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by.append(self.parse_expr())
            while self.accept_punct(","):
                group_by.append(self.parse_expr())
        having = self.parse_expr() if self.accept_kw("having") else None
        # ORDER BY / LIMIT are parsed by parse_query so they bind to the
        # whole set expression when this SELECT is a UNION arm.
        return ast.Select(
            tuple(projections), distinct, from_, where, tuple(group_by),
            having, (), None, 0,
        )

    def parse_select_item(self) -> L.Expr:
        t = self.peek()
        if t.kind == Tok.OP and t.value == "*":
            self.next()
            return L.Wildcard()
        # qualified wildcard t.*
        if (
            t.kind == Tok.IDENT
            and self.peek(1).kind == Tok.PUNCT
            and self.peek(1).value == "."
            and self.peek(2).kind == Tok.OP
            and self.peek(2).value == "*"
        ):
            self.next(); self.next(); self.next()
            return L.Wildcard()  # planner expands from full schema
        e = self.parse_expr()
        if self.accept_kw("as"):
            return L.Alias(e, self.expect_ident())
        nxt = self.peek()
        if nxt.kind == Tok.IDENT:
            self.next()
            return L.Alias(e, nxt.value)
        return e

    def parse_order_by(self) -> list[ast.OrderItem]:
        if not self.peek().is_kw("order"):
            return []
        self.next()
        self.expect_kw("by")
        items = [self.parse_order_item()]
        while self.accept_punct(","):
            items.append(self.parse_order_item())
        return items

    def parse_order_item(self) -> ast.OrderItem:
        e = self.parse_expr()
        asc = True
        if self.accept_kw("asc"):
            asc = True
        elif self.accept_kw("desc"):
            asc = False
        nulls_first: bool | None = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nulls_first = True
            else:
                self.expect_kw("last")
                nulls_first = False
        return ast.OrderItem(e, asc, nulls_first)

    def parse_limit_offset(self) -> tuple[int | None, int]:
        limit = None
        offset = 0
        while True:
            if self.accept_kw("limit"):
                t = self.next()
                if t.kind != Tok.NUMBER:
                    raise SqlError("LIMIT requires a number")
                limit = int(t.value)
            elif self.accept_kw("offset"):
                t = self.next()
                if t.kind != Tok.NUMBER:
                    raise SqlError("OFFSET requires a number")
                offset = int(t.value)
            else:
                return limit, offset

    # -- table refs ----------------------------------------------------------
    def parse_table_refs(self) -> ast.TableRef:
        left = self.parse_table_ref()
        while True:
            if self.accept_punct(","):
                right = self.parse_table_ref()
                left = ast.JoinClause(left, right, "cross", None)
                continue
            t = self.peek()
            if t.is_kw("cross"):
                self.next()
                self.expect_kw("join")
                right = self.parse_table_ref()
                left = ast.JoinClause(left, right, "cross", None)
                continue
            kind = None
            if t.is_kw("join", "inner"):
                kind = "inner"
                self.next()
                if t.is_kw("inner"):
                    self.expect_kw("join")
            elif t.is_kw("left", "right", "full"):
                kind = t.value
                self.next()
                self.accept_kw("outer")
                self.expect_kw("join")
            if kind is None:
                return left
            right = self.parse_table_ref()
            self.expect_kw("on")
            on = self.parse_expr()
            left = ast.JoinClause(left, right, kind, on)

    def parse_table_ref(self) -> ast.TableRef:
        if self.accept_punct("("):
            q = self.parse_query()
            self.expect_punct(")")
            self.accept_kw("as")
            alias = self.expect_ident()
            return ast.Derived(q, alias)
        name = self.parse_table_name()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.peek().kind == Tok.IDENT:
            alias = self.next().value
        return ast.Relation(name, alias)

    # -- expressions ---------------------------------------------------------
    def parse_expr(self) -> L.Expr:
        return self.parse_or()

    def parse_or(self) -> L.Expr:
        left = self.parse_and()
        while self.accept_kw("or"):
            left = L.BinaryExpr(left, L.Operator.OR, self.parse_and())
        return left

    def parse_and(self) -> L.Expr:
        left = self.parse_not()
        while self.accept_kw("and"):
            left = L.BinaryExpr(left, L.Operator.AND, self.parse_not())
        return left

    def parse_not(self) -> L.Expr:
        if self.accept_kw("not"):
            return L.Not(self.parse_not())
        return self.parse_comparison()

    _CMP_OPS = {
        "=": L.Operator.EQ,
        "<>": L.Operator.NEQ,
        "!=": L.Operator.NEQ,
        "<": L.Operator.LT,
        "<=": L.Operator.LTEQ,
        ">": L.Operator.GT,
        ">=": L.Operator.GTEQ,
    }

    def parse_comparison(self) -> L.Expr:
        left = self.parse_additive()
        while True:
            op = self.accept_op("=", "<>", "!=", "<", "<=", ">", ">=")
            if op is not None:
                right = self.parse_additive()
                left = L.BinaryExpr(left, self._CMP_OPS[op], right)
                continue
            t = self.peek()
            negated = False
            save = self.i
            if t.is_kw("not"):
                nxt = self.peek(1)
                if nxt.is_kw("between", "in", "like"):
                    self.next()
                    negated = True
                    t = self.peek()
                else:
                    break
            if t.is_kw("between"):
                self.next()
                low = self.parse_additive()
                self.expect_kw("and")
                high = self.parse_additive()
                left = L.Between(left, low, high, negated)
                continue
            if t.is_kw("like"):
                self.next()
                pat = self.next()
                if pat.kind != Tok.STRING:
                    raise SqlError("LIKE requires a string literal pattern")
                left = L.Like(left, pat.value, negated)
                continue
            if t.is_kw("in"):
                self.next()
                self.expect_punct("(")
                if self.peek().is_kw("select"):
                    q = self.parse_query()
                    self.expect_punct(")")
                    left = ast.InSubquery(left, q, negated)
                else:
                    vals = [self.parse_expr()]
                    while self.accept_punct(","):
                        vals.append(self.parse_expr())
                    self.expect_punct(")")
                    left = L.InList(left, tuple(vals), negated)
                continue
            if t.is_kw("is"):
                self.next()
                if self.accept_kw("not"):
                    self.expect_kw("null")
                    left = L.IsNotNull(left)
                else:
                    self.expect_kw("null")
                    left = L.IsNull(left)
                continue
            self.i = save
            break
        return left

    def parse_additive(self) -> L.Expr:
        left = self.parse_multiplicative()
        while True:
            op = self.accept_op("+", "-")
            if op is None:
                return left
            right = self.parse_multiplicative()
            left = L.BinaryExpr(
                left,
                L.Operator.PLUS if op == "+" else L.Operator.MINUS,
                right,
            )

    def parse_multiplicative(self) -> L.Expr:
        left = self.parse_unary()
        while True:
            op = self.accept_op("*", "/", "%")
            if op is None:
                return left
            right = self.parse_unary()
            ops = {
                "*": L.Operator.MULTIPLY,
                "/": L.Operator.DIVIDE,
                "%": L.Operator.MODULO,
            }
            left = L.BinaryExpr(left, ops[op], right)

    def parse_unary(self) -> L.Expr:
        op = self.accept_op("-", "+")
        if op == "-":
            e = self.parse_unary()
            if isinstance(e, L.Literal) and isinstance(e.value, (int, float)):
                return L.Literal(-e.value, e.dtype)
            return L.Negative(e)
        if op == "+":
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> L.Expr:
        t = self.peek()
        if t.kind == Tok.NUMBER:
            self.next()
            if "." in t.value or "e" in t.value or "E" in t.value:
                return L.Literal(float(t.value), DataType.FLOAT64)
            v = int(t.value)
            return L.Literal(v, DataType.INT64)
        if t.kind == Tok.STRING:
            self.next()
            return L.Literal(t.value, DataType.STRING)
        if t.is_kw("true"):
            self.next()
            return L.Literal(True, DataType.BOOL)
        if t.is_kw("false"):
            self.next()
            return L.Literal(False, DataType.BOOL)
        if t.is_kw("null"):
            self.next()
            return L.Literal(None, DataType.NULL)
        if t.is_kw("date"):
            # DATE '1994-01-01' (if not followed by a string, treat as ident)
            if self.peek(1).kind == Tok.STRING:
                self.next()
                s = self.next().value
                d = datetime.date.fromisoformat(s)
                return L.Literal.infer(d)
        if t.is_kw("timestamp") and self.peek(1).kind == Tok.STRING:
            self.next()
            s = self.next().value
            dt = datetime.datetime.fromisoformat(s)
            return L.Literal.infer(dt)
        if t.is_kw("interval"):
            self.next()
            return self.parse_interval()
        if t.is_kw("case"):
            self.next()
            return self.parse_case()
        if t.is_kw("cast"):
            self.next()
            self.expect_punct("(")
            e = self.parse_expr()
            self.expect_kw("as")
            dtype = self.parse_type_name()
            self.expect_punct(")")
            return L.Cast(e, dtype)
        if t.is_kw("extract"):
            self.next()
            self.expect_punct("(")
            part_tok = self.next()
            part = part_tok.value.lower()
            if part not in ("year", "month", "day"):
                raise SqlError(f"EXTRACT({part}) not supported")
            self.expect_kw("from")
            e = self.parse_expr()
            self.expect_punct(")")
            return L.ScalarFunction(f"extract_{part}", (e,))
        if t.is_kw("substring"):
            self.next()
            self.expect_punct("(")
            e = self.parse_expr()
            if self.accept_kw("from"):
                start = self.parse_expr()
                length = self.parse_expr() if self.accept_kw("for") else None
            else:
                self.expect_punct(",")
                start = self.parse_expr()
                length = self.parse_expr() if self.accept_punct(",") else None
            self.expect_punct(")")
            args = (e, start) if length is None else (e, start, length)
            return L.ScalarFunction("substr", args)
        if t.is_kw("exists"):
            self.next()
            self.expect_punct("(")
            q = self.parse_query()
            self.expect_punct(")")
            return ast.Exists(q, negated=False)
        if t.kind == Tok.PUNCT and t.value == "(":
            self.next()
            if self.peek().is_kw("select"):
                q = self.parse_query()
                self.expect_punct(")")
                return ast.ScalarSubquery(q)
            e = self.parse_expr()
            self.expect_punct(")")
            return e
        if t.kind == Tok.IDENT or t.kind == Tok.KEYWORD:
            # function call or (qualified) column
            if (
                self.peek(1).kind == Tok.PUNCT
                and self.peek(1).value == "("
                and (t.kind == Tok.IDENT)
            ):
                return self.parse_function_call()
            name = self.expect_ident()
            if self.accept_punct("."):
                name = f"{name}.{self.expect_ident()}"
            return L.Column(name)
        raise SqlError(f"unexpected token {t.value!r} at offset {t.pos}")

    def parse_interval(self) -> L.IntervalLiteral:
        t = self.next()
        if t.kind != Tok.STRING:
            raise SqlError("INTERVAL requires a quoted quantity")
        qty_str = t.value.strip()
        unit_tok = self.next()
        unit = unit_tok.value.lower().rstrip("s")
        try:
            qty = int(qty_str)
        except ValueError:
            # forms like INTERVAL '3 months'
            parts = qty_str.split()
            if len(parts) == 2:
                qty = int(parts[0])
                unit = parts[1].lower().rstrip("s")
                self.i -= 1  # unit token was not part of the interval
            else:
                raise SqlError(f"cannot parse interval {qty_str!r}")
        if unit == "day":
            return L.IntervalLiteral(days=qty)
        if unit == "month":
            return L.IntervalLiteral(months=qty)
        if unit == "year":
            return L.IntervalLiteral(months=12 * qty)
        if unit == "week":
            return L.IntervalLiteral(days=7 * qty)
        raise SqlError(f"unsupported interval unit {unit!r}")

    def parse_case(self) -> L.Case:
        base: L.Expr | None = None
        if not self.peek().is_kw("when"):
            base = self.parse_expr()
        branches: list[tuple[L.Expr, L.Expr]] = []
        while self.accept_kw("when"):
            cond = self.parse_expr()
            if base is not None:
                cond = L.BinaryExpr(base, L.Operator.EQ, cond)
            self.expect_kw("then")
            val = self.parse_expr()
            branches.append((cond, val))
        otherwise = None
        if self.accept_kw("else"):
            otherwise = self.parse_expr()
        self.expect_kw("end")
        if not branches:
            raise SqlError("CASE requires at least one WHEN branch")
        return L.Case(tuple(branches), otherwise)

    def parse_function_call(self) -> L.Expr:
        name = self.next().value.lower()
        self.expect_punct("(")
        # DataFusion-compatible aliases
        name = {"stddev_samp": "stddev", "var_samp": "variance"}.get(
            name, name
        )
        if name in _AGG_NAMES:
            distinct = self.accept_kw("distinct")
            if self.peek().kind == Tok.OP and self.peek().value == "*":
                self.next()
                arg: L.Expr = L.Wildcard()
            else:
                arg = self.parse_expr()
            arg2 = None
            if self.accept_punct(","):
                if name != "corr":
                    raise SqlError(f"{name}() takes one argument")
                arg2 = self.parse_expr()
            if name == "corr" and arg2 is None:
                raise SqlError("corr() takes two arguments")
            self.expect_punct(")")
            if self.peek().is_kw("over"):
                # aggregate window: SUM(x) OVER (... [ROWS/RANGE frame])
                if name not in ("sum", "avg", "min", "max", "count"):
                    raise SqlError(
                        f"{name}() is not supported as a window function"
                    )
                if distinct:
                    raise SqlError("DISTINCT windows are not supported")
                warg = None if isinstance(arg, L.Wildcard) else arg
                if name == "count" and warg is None:
                    warg = L.Literal.infer(1)  # COUNT(*) counts frame rows
                elif warg is None:
                    raise SqlError(f"{name}(*) is not valid")
                return self.parse_over_clause(name, arg=warg)
            return L.AggregateExpr(L.AggFunc(name), arg, distinct, arg2)
        if name in ("lag", "lead"):
            arg = self.parse_expr()
            offset = 1
            if self.accept_punct(","):
                t = self.next()
                if t.kind != Tok.NUMBER:
                    raise SqlError(f"{name}() offset must be a literal int")
                offset = int(t.value)
            self.expect_punct(")")
            return self.parse_over_clause(name, arg=arg, offset=offset)
        if name in ("approx_percentile_cont", "percentile_cont", "median"):
            arg = self.parse_expr()
            if name == "median":
                q = 0.5
            else:
                self.expect_punct(",")
                t = self.next()
                neg = False
                if t.kind == Tok.OP and t.value == "-":
                    neg = True
                    t = self.next()
                if t.kind != Tok.NUMBER:
                    raise SqlError(
                        f"{name}() percentile must be a numeric literal"
                    )
                q = -float(t.value) if neg else float(t.value)
            self.expect_punct(")")
            return L.PercentileExpr(arg, q)
        from ballista_tpu_torch.plugin import global_registry

        if global_registry.get_udaf(name) is not None:
            # registered aggregate UDF: aggregate-shaped call site
            arg = self.parse_expr()
            self.expect_punct(")")
            return L.UdafExpr(name, arg)
        args: list[L.Expr] = []
        if not self.accept_punct(")"):
            args.append(self.parse_expr())
            while self.accept_punct(","):
                args.append(self.parse_expr())
            self.expect_punct(")")
        if name in ("row_number", "rank", "dense_rank") and self.peek().is_kw(
            "over"
        ):
            if args:
                raise SqlError(f"{name}() takes no arguments")
            return self.parse_over_clause(name)
        if name == "substring":
            name = "substr"
        return L.ScalarFunction(name, tuple(args))

    def parse_over_clause(
        self, fname: str, arg: L.Expr | None = None, offset: int = 1
    ) -> L.Expr:
        """``OVER ( [PARTITION BY e, ...] [ORDER BY items]
        [ROWS|RANGE <frame>] )``."""
        self.expect_kw("over")
        self.expect_punct("(")
        partition_by: list[L.Expr] = []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition_by.append(self.parse_expr())
            while self.accept_punct(","):
                partition_by.append(self.parse_expr())
        order_by = [
            (item.expr, item.ascending, item.nulls_first)
            for item in self.parse_order_by()
        ]
        frame = None
        if self.peek().is_kw("rows", "range"):
            units = self.next().value
            if self.accept_kw("between"):
                st, sn = self.parse_frame_bound()
                self.expect_kw("and")
                et, en = self.parse_frame_bound()
            else:  # shorthand: <bound> = BETWEEN <bound> AND CURRENT ROW
                st, sn = self.parse_frame_bound()
                et, en = "cur", 0
            frame = L.WindowFrame(units, st, sn, et, en)
        self.expect_punct(")")
        return L.WindowFunction(
            fname, tuple(partition_by), tuple(order_by), arg=arg,
            frame=frame, offset=offset,
        )

    def parse_frame_bound(self) -> tuple[str, int]:
        if self.accept_kw("unbounded"):
            if self.accept_kw("preceding"):
                return "up", 0
            self.expect_kw("following")
            return "uf", 0
        if self.accept_kw("current"):
            self.expect_kw("row")
            return "cur", 0
        t = self.next()
        if t.kind != Tok.NUMBER:
            raise SqlError(
                f"expected a window frame bound at offset {t.pos}"
            )
        n = int(t.value)
        if self.accept_kw("preceding"):
            return "p", n
        self.expect_kw("following")
        return "f", n
