"""SQL tokenizer.

Hand-rolled (no sqlparser dependency in this environment). Produces a flat
token stream; keywords are case-insensitive, identifiers are lowercased
unless double-quoted, strings use single quotes with ``''`` escape, and both
``--`` and ``/* */`` comments are skipped.
"""

from __future__ import annotations

import dataclasses
from enum import Enum

from ballista_tpu_torch.errors import SqlError


class Tok(Enum):
    KEYWORD = "keyword"
    IDENT = "ident"
    NUMBER = "number"
    STRING = "string"
    OP = "op"
    PUNCT = "punct"
    EOF = "eof"


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "is", "null", "like", "between",
    "case", "when", "then", "else", "end", "cast", "distinct", "join",
    "inner", "left", "right", "full", "outer", "cross", "on", "union", "all",
    "exists", "interval", "date", "timestamp", "extract", "substring",
    "create", "external", "table", "stored", "with", "header", "row",
    "location", "show", "tables", "columns", "asc", "desc", "nulls", "first",
    "last", "true", "false", "explain", "drop", "if", "partitioned",
    "delimiter", "compression", "analyze", "verbose", "for", "year", "month",
    "day", "describe", "insert", "into", "values", "over", "partition",
    "rows", "range", "unbounded", "preceding", "following", "current",
}

_TWO_CHAR_OPS = {"<>", "!=", ">=", "<=", "||"}
_ONE_CHAR_OPS = set("+-*/%=<>")
_PUNCT = set("(),.;")


@dataclasses.dataclass(frozen=True)
class Token:
    kind: Tok
    value: str
    pos: int  # char offset, for error messages

    def is_kw(self, *words: str) -> bool:
        return self.kind == Tok.KEYWORD and self.value in words

    def __repr__(self) -> str:
        return f"{self.kind.value}:{self.value}"


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SqlError(f"unterminated /* comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlError(f"unterminated string literal at {i}")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            toks.append(Token(Tok.STRING, "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlError(f"unterminated quoted identifier at {i}")
            toks.append(Token(Tok.IDENT, sql[i + 1 : j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    nxt = sql[j + 1] if j + 1 < n else ""
                    if nxt.isdigit() or nxt in "+-":
                        seen_exp = True
                        j += 2 if nxt in "+-" else 1
                    else:
                        break
                else:
                    break
            toks.append(Token(Tok.NUMBER, sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j].lower()
            kind = Tok.KEYWORD if word in KEYWORDS else Tok.IDENT
            toks.append(Token(kind, word, i))
            i = j
            continue
        two = sql[i : i + 2]
        if two in _TWO_CHAR_OPS:
            toks.append(Token(Tok.OP, two, i))
            i += 2
            continue
        if c in _ONE_CHAR_OPS:
            toks.append(Token(Tok.OP, c, i))
            i += 1
            continue
        if c in _PUNCT:
            toks.append(Token(Tok.PUNCT, c, i))
            i += 1
            continue
        raise SqlError(f"unexpected character {c!r} at offset {i}")
    toks.append(Token(Tok.EOF, "", n))
    return toks
