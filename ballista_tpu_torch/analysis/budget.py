"""Shared suppression-budget ledger for every AST analyzer (the port's
copy of ``ballista_tpu/analysis/budget.py``).

This module is the single source of truth: every analyzer's budget lives
in :data:`BUDGETS`, the combined gate (``python -m
ballista_tpu_torch.analysis``) enforces it through :func:`check`, and one
test (tests/test_torch_budget.py) walks :func:`ledger` asserting every
analyzer is within budget — growing any budget means editing this file,
in plain sight of that test.

The reference's ``jaxlint`` entry is ``devlint``'s here: the port
compiles no JAX program, and its device-program lint takes the slot
here and in the gate."""

from __future__ import annotations

# analyzer name (as the combined gate spells it) -> max tree-wide
# ``# <tool>: disable=`` escape hatches. These are ceilings, not targets:
# the current counts are far below them and new suppressions need the
# same justification-in-a-comment discipline as always.
BUDGETS: dict[str, int] = {
    "devlint": 5,
    "racelint": 5,
    "lifelint": 5,
    "eqlint": 5,
    "detlint": 5,
    "stalelint": 5,
    "durlint": 5,
}


def budget_for(analyzer: str) -> int:
    return BUDGETS[analyzer]


def check(analyzer: str, used: int) -> str | None:
    """None when within budget, else the failure message the combined
    gate prints."""
    limit = BUDGETS[analyzer]
    if used > limit:
        return (
            f"suppression budget exceeded: {used} > {limit} "
            "(analysis/budget.py is the single ledger)"
        )
    return None


def ledger() -> dict[str, dict[str, int]]:
    """Live counts next to budgets for every registered analyzer — the
    payload the single budget test and ``--json`` report from."""
    from ballista_tpu_torch.analysis import (
        detlint,
        devlint,
        durlint,
        eqlint,
        lifelint,
        racelint,
        stalelint,
    )

    counts = {
        "devlint": devlint.suppression_count(),
        "racelint": racelint.suppression_count(),
        "lifelint": lifelint.suppression_count(),
        "eqlint": eqlint.suppression_count(),
        "detlint": detlint.suppression_count(),
        "stalelint": stalelint.suppression_count(),
        "durlint": durlint.suppression_count(),
    }
    assert set(counts) == set(BUDGETS), (
        "budget ledger and analyzer set drifted apart"
    )
    return {
        name: {"budget": BUDGETS[name], "used": counts[name]}
        for name in sorted(BUDGETS)
    }
