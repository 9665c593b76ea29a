"""Query-class fingerprints: one label value per repeated query shape.

The fleet histograms (docs/observability.md) label every latency series
by a *query class* so repeated submissions of the same query shape
aggregate into one distribution instead of one-series-per-job (which
would be unbounded label cardinality and statistically useless). The
class is derived from the canonical signatures the reference's trace
cache keys on (``expr_key``/``schema_key`` of its
``compilecache/tracecache.py``, copied below: the port has no trace cache):
a structural walk of the submitted physical plan — operator types,
canonical schemas, canonical expression keys — hashed to a short stable
token — with literal VALUES normalized to their dtype, so a
parameterized template (``WHERE id = <user>``) is ONE class no matter
how many constants flow through it. Two plans with the same shape (same
SQL resubmitted, the same template with different literals, same plan
built through the DataFrame API) land in the same class; any structural
difference (other columns, another join order) gets its own.

Computed once per submission, BEFORE stage splitting, so no job ids or
shuffle locations (which differ per run) can leak into the fingerprint.
"""

from __future__ import annotations

import hashlib
import logging

log = logging.getLogger(__name__)


def expr_key(e) -> tuple | None:
    """Canonical hashable key for a logical expression (or None).
    ``Expr.__eq__`` is builder sugar, so keys go through the structural
    ``_key()`` the optimizer uses."""
    if e is None:
        return None
    return (type(e).__name__, e._key())


def schema_key(schema) -> tuple:
    """Canonical hashable key for a Schema (name/dtype/nullability)."""
    return tuple((f.name, f.dtype.value, f.nullable) for f in schema)


def plan_class(plan) -> str:
    """8-hex-char class token for a physical plan (stable across
    processes: everything hashed is canonical, nothing is an id)."""
    parts: list[str] = []

    def scrub_literals(k) -> object:
        # literal VALUES are normalized to their dtype: a parameterized
        # workload (WHERE id = <user>, date = <today>) must land in ONE
        # class per template, not one per literal — per-literal classes
        # are unbounded label cardinality that would saturate the
        # scheduler's class cap with a single template and leak
        # never-evicted histogram children on every executor
        if isinstance(k, tuple):
            # nested occurrence (Expr._key's norm): ("expr", "Literal",
            # (value, dtype)); top-level occurrence (expr_key of a bare
            # literal, e.g. SELECT 1): ("Literal", (value, dtype))
            if (
                len(k) == 3
                and k[0] == "expr"
                and k[1] == "Literal"
                and isinstance(k[2], tuple)
                and len(k[2]) == 2
            ):
                return ("expr", "Literal", ("?", k[2][1]))
            if (
                len(k) == 2
                and k[0] == "Literal"
                and isinstance(k[1], tuple)
                and len(k[1]) == 2
            ):
                return ("Literal", ("?", k[1][1]))
            return tuple(scrub_literals(x) for x in k)
        return k

    def one_expr(e) -> object:
        # canonical key where the expr supports it (logical exprs,
        # which the physical operators embed), literal-normalized; the
        # repr fallback covers exotic expr kinds without _key
        try:
            return scrub_literals(expr_key(e))
        except Exception:  # noqa: BLE001 — exprs without _key
            return repr(e)

    def node_sig(node) -> tuple:
        sig: list = [type(node).__name__]
        try:
            sig.append(schema_key(node.schema()))
        except Exception as e:  # noqa: BLE001 — schema-less nodes still
            # classify by type/exprs alone; worth a debug trail though
            log.debug("qclass: %s has no schema key: %s",
                      type(node).__name__, e)
        for attr in ("exprs", "group_exprs", "agg_exprs", "sort_exprs"):
            exprs = getattr(node, attr, None)
            if exprs:
                sig.append(tuple(one_expr(e) for e in exprs))
        pred = getattr(node, "predicate", None)
        if pred is not None:
            sig.append(one_expr(pred))
        return tuple(sig)

    def walk(node, depth: int) -> None:
        parts.append(f"{depth}:{node_sig(node)!r}")
        for child in node.children():
            walk(child, depth + 1)

    try:
        walk(plan, 0)
    except Exception:  # noqa: BLE001 — classification must never fail a
        # submission; an unclassifiable plan aggregates under "unknown"
        return "unknown"
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:8]
