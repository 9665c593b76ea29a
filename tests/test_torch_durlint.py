"""durlint + the declared durability registry of the port
(``ballista_tpu_torch/analysis/durlint.py`` over ``analysis/durreg.py``),
the cases of ``tests/test_durlint.py``: the port's scheduler is
durability-clean (zero findings, zero suppressions), every declared state
entry names a real field of the port's scheduler, the inventory in
``ballista_tpu_torch/docs/analysis.md`` cannot drift, and each of the four
rule families rejects its seeded failure shape in a copy of a port module
(a dropped ``save_job``, an undeclared state field, a write-only persisted
key, a lock-free backend write). Every fixture also runs through the
reference's lint under the reference's file name, with the same findings:
the two registries declare the same scheduler."""

import pathlib
import re

import pytest

from ballista_tpu.analysis import durlint as ref_durlint
from ballista_tpu.analysis import durreg as ref_durreg
from ballista_tpu_torch.analysis import durlint as port_durlint
from ballista_tpu_torch.analysis import durreg

_PKG = re.compile(r"\bballista_tpu\b(?!\.proto)")
_PORT_PKG = re.compile(r"\bballista_tpu_torch\b")


def _port(text: str) -> str:
    return _PKG.sub("ballista_tpu_torch", text)


def _ref(text: str) -> str:
    return _PORT_PKG.sub("ballista_tpu", text)


class _HeldAgainstReference:
    """The port's analyzer module. Its ``lint_source`` also runs each
    fixture through the reference's analyzer (under the reference's file
    name) and asserts the same (file, line, rule), with messages equal up
    to the package name."""

    def __init__(self, port, ref):
        self._port, self._ref = port, ref

    def __getattr__(self, name):
        return getattr(self._port, name)

    def lint_source(self, source, *args):
        got = self._port.lint_source(source, *args)
        want = self._ref.lint_source(source, *(_ref(a) for a in args))
        assert [(d.file, d.line, d.rule) for d in got] == [
            (_port(d.file), d.line, d.rule) for d in want
        ]
        assert [d.message for d in got] == [_port(d.message) for d in want]
        return got


durlint = _HeldAgainstReference(port_durlint, ref_durlint)

ROOT = pathlib.Path(__file__).resolve().parents[1]

SERVER = "ballista_tpu_torch/scheduler/server.py"
HISTORY = "ballista_tpu_torch/obs/history.py"
PERSIST = "ballista_tpu_torch/scheduler/persistent_state.py"


def _read(rel: str) -> str:
    return (ROOT / rel).read_text()


def _rules(diags) -> set[str]:
    return {d.rule for d in diags}


def _only(diags, rule: str):
    return [d for d in diags if d.rule == rule]


# ---------------------------------------------------------------------------
# the clean tree
# ---------------------------------------------------------------------------


def test_clean_tree_has_zero_findings():
    files = port_durlint.target_files()
    assert files and all(f.is_relative_to(ROOT / "ballista_tpu_torch") for f in files)
    assert ROOT / SERVER in files and ROOT / HISTORY in files
    diags = durlint.lint_paths()
    assert diags == [], "\n".join(str(d) for d in diags)


def test_zero_suppressions_in_tree():
    assert durlint.suppression_count() == 0


# ---------------------------------------------------------------------------
# registry closure
# ---------------------------------------------------------------------------


def test_every_declared_anchor_resolves():
    problems = durreg.verify_anchors()
    assert problems == [], "\n".join(problems)


def test_registry_closure_over_every_entry():
    """Every StateEntry is structurally complete: unique name, at least
    one anchor, a legal durability class, persisted entries name their
    save/load pair, rebuilt entries their source, ephemeral entries a
    cachereg cross-link or a written justification."""
    names = [e.name for e in durreg.STATE]
    assert len(names) == len(set(names))
    for e in durreg.STATE:
        assert e.anchors, e.name
        assert e.durability in durreg.DURABILITY, e.name
        assert e.contents, e.name
        if e.durability == "persisted":
            assert e.save and e.load, (
                f"{e.name}: persisted entries name their save/load pair"
            )
        elif e.durability == "rebuilt":
            assert e.recovery, f"{e.name}: rebuilt entries name a source"
        else:
            assert e.cache_link or e.recovery, (
                f"{e.name}: ephemeral entries cross-link cachereg or "
                "justify where the durable record lives"
            )
    for c in durreg.CONTRACTS:
        assert c.mutators and c.must_call and c.fields, c.source
    for s in durreg.WRITE_SEAMS:
        assert s.functions and s.reason, s.file


def test_anchor_index_rejects_duplicates():
    idx = durreg.anchor_index()
    declared = sum(len(e.anchors) for e in durreg.STATE)
    assert len(idx) == declared


def test_issue_named_state_is_all_declared():
    """The coverage floor: the state groups recovery is built around
    must each have a registry entry (removing one silently is a test
    diff)."""
    for name in (
        "job-map", "job-record", "completed-locations", "stage-plans",
        "sessions", "executor-metadata", "executor-heartbeats",
        "executor-slots", "stage-state", "result-cache-state",
        "bypass-state",
    ):
        durreg.entry(name)
    with pytest.raises(KeyError):
        durreg.entry("no-such-state")


def test_every_durability_class_is_populated():
    for durability in durreg.DURABILITY:
        assert durreg.entries(durability), durability


def test_docs_inventory_in_sync():
    assert durreg.docs_in_sync() is None
    assert durreg.render_inventory() in _read("ballista_tpu_torch/docs/analysis.md")


def test_registry_names_the_ports_scheduler():
    """The registry is the reference's, re-anchored on the port's tree:
    the same entries, classes and contracts, every anchor under
    ballista_tpu_torch/."""
    def port(s):
        return s.replace("ballista_tpu/", "ballista_tpu_torch/")

    assert [e.name for e in durreg.STATE] == [e.name for e in ref_durreg.STATE]
    assert [e.anchors for e in durreg.STATE] == [
        tuple(port(a) for a in e.anchors) for e in ref_durreg.STATE
    ]
    assert durreg.CONTROL_CLASSES == {port(k): v for k, v in ref_durreg.CONTROL_CLASSES.items()}
    assert [(c.file, c.mutators, c.must_call) for c in durreg.CONTRACTS] == [
        (port(c.file), c.mutators, c.must_call) for c in ref_durreg.CONTRACTS
    ]
    for e in durreg.STATE:
        assert all(a.startswith("ballista_tpu_torch/") for a in e.anchors), e.name


# ---------------------------------------------------------------------------
# rule 1: undeclared-state
# ---------------------------------------------------------------------------


def test_rule1_rejects_undeclared_container_on_server():
    src = _read(SERVER).replace(
        "self.jobs: dict[str, JobInfo] = {}",
        "self.jobs: dict[str, JobInfo] = {}\n"
        "        self._shadow_q = {}",
    )
    diags = _only(durlint.lint_source(src, SERVER), "undeclared-state")
    assert len(diags) == 1, diags
    assert "SchedulerServer._shadow_q" in diags[0].message
    assert "durreg" in diags[0].message


def test_a_seeded_state_field_in_a_tmp_copy_of_the_scheduler_is_found(tmp_path):
    """The lint reads the port's own scheduler: a container added to a
    temp copy of ``scheduler/server.py`` is its one finding there."""
    copy = tmp_path / "server.py"
    copy.write_text(_read(SERVER).replace(
        "self.jobs: dict[str, JobInfo] = {}",
        "self.jobs: dict[str, JobInfo] = {}\n        self._seeded_jobs = {}",
    ))
    diags = port_durlint.lint_source(copy.read_text(), SERVER)
    assert [(d.rule, "SchedulerServer._seeded_jobs" in d.message) for d in diags] == [
        ("undeclared-state", True)
    ]


def test_rule1_rejects_undeclared_jobinfo_field():
    # a NEW dataclass field on the job record is exactly the state a
    # restart silently loses — it must be declared before it exists
    src = _read(SERVER).replace(
        "bypass: bool = False",
        "bypass: bool = False\n    shadow_flag: bool = False",
    )
    diags = _only(durlint.lint_source(src, SERVER), "undeclared-state")
    assert len(diags) == 1, diags
    assert "JobInfo.shadow_flag" in diags[0].message


def test_rule1_ignores_locals_and_undeclared_classes():
    src = (
        "class Helper:\n"
        "    def __init__(self):\n"
        "        self._scratch = {}\n"
        "def f():\n"
        "    temp = {}\n"
        "    return temp\n"
    )
    assert _only(durlint.lint_source(src, SERVER), "undeclared-state") == []


def test_rule1_suppression_honored():
    src = _read(SERVER).replace(
        "self.jobs: dict[str, JobInfo] = {}",
        "self.jobs: dict[str, JobInfo] = {}\n"
        "        self._shadow_q = {}"
        "  # durlint: disable=undeclared-state",
    )
    assert _only(
        durlint.lint_source(src, SERVER), "undeclared-state"
    ) == []


# ---------------------------------------------------------------------------
# rule 2: unpersisted-mutation
# ---------------------------------------------------------------------------


def test_rule2_real_mutators_all_satisfy_contracts():
    diags = _only(
        durlint.lint_source(_read(SERVER), SERVER),
        "unpersisted-mutation",
    )
    assert diags == [], "\n".join(str(d) for d in diags)


def test_rule2_rejects_dropped_save_job():
    # the seeded acceptance shape: a terminal transition that no longer
    # persists — the failed status would exist only in dying memory
    src = _read(SERVER).replace("self.state.save_job(", "self.state.skip_job(")
    assert "self.state.save_job(" not in src
    diags = _only(
        durlint.lint_source(src, SERVER), "unpersisted-mutation"
    )
    assert diags, "dropping save_job must fail the gate"
    flagged = " ".join(d.message for d in diags)
    for mutator in ("_on_job_finished", "_on_job_failed"):
        assert mutator in flagged, flagged


def test_rule2_rejects_renamed_mutator():
    src = _read(SERVER).replace(
        "def _on_job_failed", "def _renamed_on_job_failed"
    )
    diags = _only(
        durlint.lint_source(src, SERVER), "unpersisted-mutation"
    )
    assert any("_on_job_failed" in d.message and "not found" in d.message
               for d in diags), diags


# ---------------------------------------------------------------------------
# rule 3: recovery-gap
# ---------------------------------------------------------------------------


def test_rule3_real_recover_state_loads_every_persisted_entry():
    diags = _only(
        durlint.lint_source(_read(SERVER), SERVER), "recovery-gap"
    )
    assert diags == [], "\n".join(str(d) for d in diags)


def test_rule3_rejects_write_only_sessions():
    # save_session still runs everywhere; only the read-back is gone —
    # the write-only durability shape nothing but a restart test catches
    src = _read(SERVER).replace("self.state.load_sessions()", "dict()")
    assert "load_sessions" not in src
    diags = _only(durlint.lint_source(src, SERVER), "recovery-gap")
    assert len(diags) == 1, diags
    assert "sessions" in diags[0].message
    assert "load_sessions" in diags[0].message


def test_rule3_rejects_missing_recover_state():
    src = _read(SERVER).replace(
        "def _recover_state", "def _restore_state"
    )
    diags = _only(durlint.lint_source(src, SERVER), "recovery-gap")
    assert any("_recover_state not found" in d.message for d in diags)


# ---------------------------------------------------------------------------
# rule 4: unguarded-backend-write
# ---------------------------------------------------------------------------


def test_rule4_real_tree_writes_are_locked_or_seamed():
    for rel in (PERSIST, HISTORY):
        diags = _only(
            durlint.lint_source(_read(rel), rel),
            "unguarded-backend-write",
        )
        assert diags == [], "\n".join(str(d) for d in diags)


def test_rule4_rejects_lock_free_backend_write():
    src = _read(PERSIST) + (
        "\n\ndef rogue(state):\n"
        "    state.backend.put('/k', b'v')\n"
    )
    diags = _only(
        durlint.lint_source(src, PERSIST), "unguarded-backend-write"
    )
    assert len(diags) == 1, diags
    assert "split-brain" in diags[0].message


def test_rule4_accepts_locked_write_rejects_sibling():
    src = (
        "def locked(state):\n"
        "    with state.backend.lock():\n"
        "        state.backend.put('/k', b'v')\n"
        "def bare(state):\n"
        "    state.backend.delete('/k')\n"
    )
    diags = _only(
        durlint.lint_source(src, PERSIST), "unguarded-backend-write"
    )
    assert len(diags) == 1 and diags[0].line == 5, diags


def test_rule4_seeded_history_writer_outside_seam_rejected():
    # history.py's own writers are a DECLARED seam; an undeclared
    # sibling function in the same file still gets flagged
    src = _read(HISTORY) + (
        "\n\ndef sneaky_write(self):\n"
        "    self.backend.put('/ballista/x', b'v')\n"
    )
    diags = _only(
        durlint.lint_source(src, HISTORY), "unguarded-backend-write"
    )
    assert len(diags) == 1, diags


def test_rule4_nested_def_under_lock_is_a_new_frame():
    # a closure defined inside `with lock:` runs LATER, without the
    # lock — lexical nesting must not count as guarding
    src = (
        "def outer(state):\n"
        "    with state.backend.lock():\n"
        "        def later():\n"
        "            state.backend.put('/k', b'v')\n"
        "        return later\n"
    )
    diags = _only(
        durlint.lint_source(src, PERSIST), "unguarded-backend-write"
    )
    assert len(diags) == 1 and diags[0].line == 4, diags


# ---------------------------------------------------------------------------
# gate integration
# ---------------------------------------------------------------------------


def test_combined_gate_runner_green():
    from ballista_tpu_torch.analysis.__main__ import run_durlint

    ok, summary = run_durlint()
    assert ok, summary
    assert "0 findings" in summary
    assert "declared state entries" in summary


def test_durlint_listed_in_gate_matrix(capsys):
    """The port has no CI script of its own: its gate's --list matrix is
    pinned (tests/test_torch_analysis_cli.py) and names durlint."""
    from ballista_tpu_torch.analysis.__main__ import ANALYZERS, main

    assert "durlint" in ANALYZERS
    assert main(["--list"]) == 0
    assert "durlint" in capsys.readouterr().out.split()


def test_diagnostic_str_is_greppable():
    d = durlint.DurDiagnostic(
        "ballista_tpu_torch/x.py", 3, "recovery-gap", "m"
    )
    assert str(d) == "ballista_tpu_torch/x.py:3: recovery-gap: m"


def test_contract_outside_sweep_is_flagged(monkeypatch):
    ghost = durreg.PersistenceContract(
        source="ghost", file="ballista_tpu_torch/analysis/nope.py",
        mutators=("f",), must_call=("save_job",), fields=("job-map",),
    )
    monkeypatch.setattr(
        durreg, "CONTRACTS", durreg.CONTRACTS + (ghost,)
    )
    diags = durlint.lint_paths()
    assert any("outside the" in d.message for d in diags)


def test_suppression_budget_registered():
    from ballista_tpu_torch.analysis import budget

    assert "durlint" in budget.BUDGETS
    assert budget.ledger()["durlint"]["used"] == 0


@pytest.mark.parametrize("rule", sorted(durlint.RULES))
def test_every_rule_documented(rule):
    text = _read("ballista_tpu_torch/docs/analysis.md")
    assert f"`{rule}`" in text
