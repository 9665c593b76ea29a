"""The suppression-budget test of the port
(``ballista_tpu_torch/analysis/budget.py``), the cases of
``tests/test_budget.py``: the shared ledger is the reference's with
``devlint`` in ``jaxlint``'s place, every analyzer is within its budget,
and the live counts are pinned."""

from ballista_tpu.analysis import budget as ref_budget
from ballista_tpu_torch.analysis import budget


def test_budgets_are_the_references_minus_jaxlint():
    """jaxlint's entry is devlint's, at the same budget."""
    want = dict(ref_budget.BUDGETS)
    want["devlint"] = want.pop("jaxlint")
    assert budget.BUDGETS == want


def test_every_analyzer_within_budget():
    ledger = budget.ledger()
    assert set(ledger) == {
        "devlint", "racelint", "lifelint", "eqlint", "detlint",
        "stalelint", "durlint",
    }
    for name, row in ledger.items():
        assert row["used"] <= row["budget"], (
            f"{name}: {row['used']} suppressions > budget {row['budget']}"
        )


def test_current_counts_pinned():
    """The live counts, pinned: a NEW suppression anywhere shows up as a
    diff to this test plus its in-code justification comment."""
    used = {k: v["used"] for k, v in budget.ledger().items()}
    assert used == {
        # syncs by design: the shrink's first-sight count (exec/shrink.py),
        # the mesh layout's live count (parallel/mesh.py) and the mesh
        # stages' one flag read a step (parallel/stage.py)
        "devlint": 3,
        # the documented double-checked fast path in testing/faults.py
        "racelint": 1,
        "lifelint": 0,
        "eqlint": 0,
        "detlint": 0,
        "stalelint": 0,
        "durlint": 0,
    }, used


def test_budgets_are_uniform_and_small():
    assert set(budget.BUDGETS.values()) == {5}


def test_check_message_names_the_ledger():
    assert budget.check("eqlint", 5) is None
    msg = budget.check("eqlint", 6)
    assert msg is not None and "analysis/budget.py" in msg
