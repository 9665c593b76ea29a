"""stalelint + the declared cache registry of the port
(``ballista_tpu_torch/analysis/stalelint.py`` over ``analysis/cachereg.py``),
the cases of ``tests/test_stalelint.py``: the port's tree is
coherence-clean (zero findings, zero suppressions), every declared cache
of the port resolves to a real anchor, the inventory in
``ballista_tpu_torch/docs/analysis.md`` cannot drift, and each of the four
rule families rejects its seeded failure shape. Each synthetic fixture
also runs through the reference's lint, with the same findings; the cases
over the port's real modules run the port's lint alone (the two
registries declare different trees)."""

import pathlib
import re

import pytest

from ballista_tpu.analysis import stalelint as ref_stalelint
from ballista_tpu_torch.analysis import cachereg
from ballista_tpu_torch.analysis import stalelint as port_stalelint

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


stalelint = _HeldAgainstReference(port_stalelint, ref_stalelint)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _read(rel: str) -> str:
    return (ROOT / rel).read_text()


def _rules(diags) -> set[str]:
    return {d.rule for d in diags}


# ---------------------------------------------------------------------------
# the clean tree
# ---------------------------------------------------------------------------


def test_clean_tree_has_zero_findings():
    files = port_stalelint.target_files()
    pkg = ROOT / "ballista_tpu_torch"
    assert files and all(f.is_relative_to(pkg) for f in files)
    assert {"ops/cuda_build.py", "ops/partition.py", "exec/scan.py", "exec/shrink.py"} <= {
        f.relative_to(pkg).as_posix() for f in files
    }
    diags = stalelint.lint_paths()
    assert diags == [], "\n".join(str(d) for d in diags)


def test_zero_suppressions_in_tree():
    assert stalelint.suppression_count() == 0


# ---------------------------------------------------------------------------
# registry closure
# ---------------------------------------------------------------------------


def test_every_declared_anchor_resolves():
    problems = cachereg.verify_anchors()
    assert problems == [], "\n".join(problems)


def test_registry_closure_over_every_entry():
    """Every CacheEntry is structurally complete: unique name, at least
    one anchor, legal scope/coherence, snapshot entries declare a seam,
    and every contract references declared caches."""
    names = [e.name for e in cachereg.CACHES]
    assert len(names) == len(set(names))
    for e in cachereg.CACHES:
        assert e.anchors, e.name
        assert e.scope in ("process", "session", "job", "task"), e.name
        assert e.coherence in (
            "versioned", "snapshot", "immutable-keyed",
            "speculative-validated",
        ), e.name
        assert e.keyed_by and e.invalidation, e.name
        if e.coherence == "snapshot":
            assert e.seam, f"{e.name}: snapshot discipline needs a seam"
    for x in cachereg.EXEMPT:
        assert x.reason, x.anchor
    for c in cachereg.CONTRACTS:
        for cache in c.caches:
            cachereg.entry(cache)  # KeyError = undeclared reference


def test_anchor_index_rejects_duplicates():
    idx = cachereg.anchor_index()
    # every cache anchor and every exempt anchor is present exactly once
    declared = sum(len(e.anchors) for e in cachereg.CACHES)
    assert len(idx) == declared + len(cachereg.EXEMPT)


def test_issue_named_caches_are_all_declared():
    """The coverage floor: the caches the engine is built around must
    each have a registry entry (removing one silently is a test diff)."""
    for name in (
        "exec-plan-cache", "plan-hints",
        "aqe-strategy-store", "result-cache", "resolved-plan-bytes",
        "eager-plan-bytes", "push-registry", "flight-pool",
        "capacity-ladder", "executor-plan-cache",
        "executor-job-snapshots", "physical-plan-cache",
        # the port's own: its kernels' state and the learned entries
        "kernel-libraries", "partition-launcher", "launch-shape-memo",
        "dict-hash-cache", "join-build-cache", "scan-device-cache",
        "file-scan-cache", "shrink-capacities", "clustered-aggregate-entries",
        # the reference's trace cache, ported as the shared callable cache
        "trace-cache",
    ):
        cachereg.entry(name)
    assert cachereg.entry("trace-cache").anchors == (
        "ballista_tpu_torch/compilecache/tracecache.py::_CACHE",
    )
    # the reference's jitted programs have no counterpart
    for gone in ("jit-program-memo",):
        with pytest.raises(KeyError):
            cachereg.entry(gone)


def test_the_ports_caches_are_anchored_where_they_live():
    idx = cachereg.anchor_index()
    for anchor, name in (
        ("ballista_tpu_torch/ops/cuda_build.py::_libs", "kernel-libraries"),
        ("ballista_tpu_torch/ops/partition.py::_dict_hash_cache", "dict-hash-cache"),
        ("ballista_tpu_torch/ops/partition.py::_launcher", "partition-launcher"),
        ("ballista_tpu_torch/ops/prefix_sum.py::scratch_words", "launch-shape-memo"),
        ("ballista_tpu_torch/exec/joins.py::HashJoinExec._build_cache", "join-build-cache"),
        ("ballista_tpu_torch/exec/scan.py::MemoryScanExec.device_cache", "scan-device-cache"),
        ("ballista_tpu_torch/exec/shrink.py::maybe_shrink", "shrink-capacities"),
    ):
        assert idx[anchor] == name, anchor
    assert all(a.startswith("ballista_tpu_torch/") for a in idx)
    assert all(c.file.startswith("ballista_tpu_torch/") for c in cachereg.CONTRACTS)


def test_a_seeded_cache_in_a_port_module_is_found(tmp_path):
    """A cache-shaped global appended to a copy of the partition wrapper
    is the lint's one finding there."""
    rel = "ballista_tpu_torch/ops/partition.py"
    copy = tmp_path / "partition.py"
    copy.write_text(_read(rel) + "\n\n_seeded_cache: dict = {}\n")
    diags = port_stalelint.lint_source(copy.read_text(), rel)
    assert [(d.rule, d.line) for d in diags] == [
        ("undeclared-cache", len(copy.read_text().splitlines()))
    ]


def test_docs_inventory_in_sync():
    assert cachereg.docs_in_sync() is None
    assert cachereg.render_inventory() in _read("ballista_tpu_torch/docs/analysis.md")


# ---------------------------------------------------------------------------
# rule 1: undeclared-cache
# ---------------------------------------------------------------------------

_R1_SEED = """
class ProbeExec:
    def __init__(self):
        self._lut_cache = {}
"""


def test_rule1_flags_undeclared_instance_cache():
    diags = stalelint.lint_source(_R1_SEED, "ballista_tpu_torch/exec/probe.py")
    assert _rules(diags) == {"undeclared-cache"}
    assert "ProbeExec._lut_cache" in diags[0].message


def test_rule1_flags_undeclared_module_global_and_lru():
    src = (
        "from functools import lru_cache\n"
        "_RESULT_POOL = {}\n"
        "@lru_cache(maxsize=None)\n"
        "def build_program(sig):\n"
        "    return sig\n"
    )
    diags = stalelint.lint_source(src, "ballista_tpu_torch/ops/probe.py")
    assert len(diags) == 2
    assert _rules(diags) == {"undeclared-cache"}


def test_rule1_accepts_declared_anchor_and_plain_locals():
    # a declared anchor (the real executor plan cache) and a local temp
    # dict inside a function are both legal
    src = (
        "class Executor:\n"
        "    def __init__(self):\n"
        "        self._plan_cache = {}\n"
        "def helper():\n"
        "    scratch_cache = {}\n"
        "    return scratch_cache\n"
    )
    diags = stalelint.lint_source(
        src, "ballista_tpu_torch/executor/executor.py"
    )
    assert diags == []


def test_rule1_suppression_honored_and_counted():
    src = _R1_SEED.replace(
        "self._lut_cache = {}",
        "self._lut_cache = {}  # stalelint: disable=undeclared-cache",
    )
    assert stalelint.lint_source(src, "ballista_tpu_torch/exec/probe.py") == []


# ---------------------------------------------------------------------------
# rule 2: missing-invalidation
# ---------------------------------------------------------------------------


def test_rule2_real_mutators_all_satisfy_contracts():
    for rel in ("ballista_tpu_torch/exec/context.py",
                "ballista_tpu_torch/scheduler/server.py"):
        diags = [
            d for d in port_stalelint.lint_source(_read(rel), rel)
            if d.rule == "missing-invalidation"
        ]
        assert diags == [], "\n".join(str(d) for d in diags)


def test_rule2_rejects_dropped_plan_cache_clear():
    rel = "ballista_tpu_torch/exec/context.py"
    src = _read(rel).replace("self._plan_cache.clear()", "pass")
    assert "self._plan_cache.clear()" not in src
    diags = [
        d for d in port_stalelint.lint_source(src, rel)
        if d.rule == "missing-invalidation"
    ]
    assert diags, "dropping the invalidation call must fail the gate"
    assert any("_plan_cache.clear" in d.message for d in diags)


def test_rule2_rejects_rewrite_keeping_stale_plan_bytes():
    # the scheduler/server.py "resolved bytes never invalidated" hazard,
    # as a machine contract: apply_certified_rewrite must pop both plan-
    # bytes caches for touched stages
    rel = "ballista_tpu_torch/scheduler/server.py"
    src = _read(rel).replace("eager_plan_bytes.pop", "eager_plan_bytes.get")
    diags = [
        d for d in port_stalelint.lint_source(src, rel)
        if d.rule == "missing-invalidation"
    ]
    assert any(
        "apply_certified_rewrite" in d.message
        or "eager_plan_bytes.pop" in d.message
        for d in diags
    ), "\n".join(str(d) for d in diags)


def test_rule2_rejects_renamed_mutator():
    rel = "ballista_tpu_torch/exec/context.py"
    src = _read(rel).replace("def append_table", "def append_rows")
    diags = [
        d for d in port_stalelint.lint_source(src, rel)
        if d.rule == "missing-invalidation"
    ]
    assert any("append_table" in d.message for d in diags)


# ---------------------------------------------------------------------------
# rule 3: snapshot-escape
# ---------------------------------------------------------------------------


def test_rule3_real_executor_is_clean():
    rel = "ballista_tpu_torch/executor/executor.py"
    diags = [
        d for d in port_stalelint.lint_source(_read(rel), rel)
        if d.rule == "snapshot-escape"
    ]
    assert diags == [], "\n".join(str(d) for d in diags)


def test_rule3_rejects_the_q15_shape():
    # the exact pre-fix bug: handing the LIVE executor-lifetime cache to
    # a task attempt instead of the frozen job snapshot
    rel = "ballista_tpu_torch/executor/executor.py"
    src = _read(rel).replace(
        "plan_cache=attempt_cache,", "plan_cache=self._plan_cache,"
    )
    assert "plan_cache=self._plan_cache," in src
    diags = [
        d for d in port_stalelint.lint_source(src, rel)
        if d.rule == "snapshot-escape"
    ]
    assert diags, "the q15 snapshot-escape shape must be rejected"
    assert "q15" in diags[0].message


def test_rule3_rejects_plain_live_read_allows_commit_write():
    src = (
        "class Executor:\n"
        "    def __init__(self):\n"
        "        self._plan_cache = {}\n"
        "    def _job_snapshot(self, job_id):\n"
        "        return dict(self._plan_cache)\n"
        "    def run_task(self, cache):\n"
        "        flag = self._plan_cache.get(('join', 'q3'))\n"  # escape
        "        self._plan_cache.update(cache)\n"  # commit: legal
        "        self._hints.save_if_changed({}, self._plan_cache)\n"
    )
    diags = [
        d for d in stalelint.lint_source(
            src, "ballista_tpu_torch/executor/executor.py"
        )
        if d.rule == "snapshot-escape"
    ]
    assert len(diags) == 1 and diags[0].line == 7, diags


# ---------------------------------------------------------------------------
# rule 4: unvalidated-speculation
# ---------------------------------------------------------------------------

_R4_BAD = """
def learn_strategy(ctx, fp, flags):
    cache = ctx.plan_cache
    cache[fp] = flags
"""

_R4_GOOD = """
def learn_strategy(ctx, fp, flags):
    cache = ctx.plan_cache
    cache[fp] = flags
    ctx.defer_speculation(fp, lambda: flags)
"""


def test_rule4_rejects_bare_speculative_write():
    diags = stalelint.lint_source(_R4_BAD, "ballista_tpu_torch/ops/probe.py")
    assert _rules(diags) == {"unvalidated-speculation"}


def test_rule4_accepts_validated_write():
    assert stalelint.lint_source(
        _R4_GOOD, "ballista_tpu_torch/ops/probe.py"
    ) == []


def test_rule4_skips_the_seam_file_and_non_operator_code():
    # the seam itself (exec/base.py) and scheduler code are out of scope
    for rel in ("ballista_tpu_torch/exec/base.py",
                "ballista_tpu_torch/scheduler/probe.py"):
        assert stalelint.lint_source(_R4_BAD, rel) == []


def test_rule4_real_operator_tree_is_clean():
    for path in (ROOT / "ballista_tpu_torch" / "ops").rglob("*.py"):
        rel = str(path.relative_to(ROOT))
        diags = [
            d for d in port_stalelint.lint_source(path.read_text(), rel)
            if d.rule == "unvalidated-speculation"
        ]
        assert diags == [], "\n".join(str(d) for d in diags)


# ---------------------------------------------------------------------------
# gate integration
# ---------------------------------------------------------------------------


def test_combined_gate_runner_green():
    from ballista_tpu_torch.analysis.__main__ import run_stalelint

    ok, summary = run_stalelint()
    assert ok, summary
    assert "0 findings" in summary


def test_diagnostic_str_is_greppable():
    d = stalelint.StaleDiagnostic(
        "ballista_tpu_torch/x.py", 3, "undeclared-cache", "m"
    )
    assert str(d) == "ballista_tpu_torch/x.py:3: undeclared-cache: m"


def test_contract_outside_sweep_is_flagged(monkeypatch):
    ghost = cachereg.InvalidationContract(
        source="ghost", file="ballista_tpu_torch/analysis/nope.py",
        mutators=("f",), must_call=("g",), caches=("result-cache",),
    )
    monkeypatch.setattr(
        cachereg, "CONTRACTS", cachereg.CONTRACTS + (ghost,)
    )
    diags = stalelint.lint_paths()
    assert any("outside the" in d.message for d in diags)


@pytest.mark.parametrize("rule", sorted(stalelint.RULES))
def test_every_rule_documented(rule):
    text = _read("ballista_tpu_torch/docs/analysis.md")
    assert f"`{rule}`" in text
