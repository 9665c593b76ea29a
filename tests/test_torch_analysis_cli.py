"""The port's combined-gate CLI (``python -m ballista_tpu_torch.analysis``),
the cases of ``tests/test_analysis_cli.py``: its twelve analyzers (the
reference's, with ``devlint`` in ``jaxlint``'s slot) aggregate into ONE
exit code — any analyzer
failing alone fails the run — and ``--skip`` / ``--only`` select
analyzers without disturbing it. The matrix monkeypatches the runners;
the cheap analyzers, and once the whole gate with ``--json``, run for
real. The port has no CI script of its own: the ``--list`` matrix is
pinned here."""

import json
import os
import subprocess
import sys

import pytest

import ballista_tpu.analysis.__main__ as ref_main
import ballista_tpu_torch.analysis.__main__ as amain


def _fake_runners(monkeypatch, failing: str | None):
    for name in amain.ANALYZERS:
        attr = "run_" + name.replace("-", "_")
        if name == "serde-audit":
            attr = "run_serde_audit"

        def make(n=name):
            def run(*a, **k):
                if n == failing:
                    return False, f"{n} seeded failure"
                return True, f"{n} ok"
            return run

        monkeypatch.setattr(amain, attr, make(), raising=True)
    # planlint/compile-vocab take queries and device args through lambdas
    monkeypatch.setattr(
        amain, "run_planlint",
        lambda queries=None, device="cuda": (
            (False, "planlint seeded failure")
            if failing == "planlint" else (True, "planlint ok")
        ),
    )
    monkeypatch.setattr(
        amain, "run_compile_vocab",
        lambda queries=None, device="cuda": (
            (False, "compile-vocab seeded failure")
            if failing == "compile-vocab" else (True, "compile-vocab ok")
        ),
    )


def test_all_green_exits_zero(monkeypatch):
    _fake_runners(monkeypatch, failing=None)
    lines = []
    assert amain.run_all(out=lines.append) == 0
    assert len([ln for ln in lines if ": OK" in ln]) == len(
        amain.ANALYZERS
    )


@pytest.mark.parametrize("victim", amain.ANALYZERS)
def test_each_analyzer_failing_alone_fails_the_run(monkeypatch, victim):
    _fake_runners(monkeypatch, failing=victim)
    lines = []
    assert amain.run_all(out=lines.append) == 1
    joined = "\n".join(lines)
    assert f"{victim}: FAIL" in joined
    assert joined.count(": FAIL") == 1
    assert f"FAILED: {victim}" in joined


def test_skip_and_only_select_analyzers(monkeypatch):
    _fake_runners(monkeypatch, failing="racelint")
    lines = []
    # skipping the failing analyzer turns the run green
    assert amain.run_all(skip=("racelint",), out=lines.append) == 0
    assert "racelint: SKIPPED" in "\n".join(lines)
    lines = []
    # --only an unrelated analyzer never runs the failing one
    assert amain.run_all(only=("lifelint",), out=lines.append) == 0
    joined = "\n".join(lines)
    assert "lifelint: OK" in joined
    assert "racelint: SKIPPED" in joined


def test_analyzer_crash_is_a_fail(monkeypatch):
    _fake_runners(monkeypatch, failing=None)

    def boom():
        raise RuntimeError("analyzer blew up")

    monkeypatch.setattr(amain, "run_lifelint", boom)
    lines = []
    assert amain.run_all(only=("lifelint",), out=lines.append) == 1
    assert "analyzer crashed" in "\n".join(lines)


def test_only_lifelint_runs_for_real():
    lines = []
    assert amain.run_all(only=("lifelint",), out=lines.append) == 0
    line = next(ln for ln in lines if ln.startswith("lifelint:"))
    assert "OK" in line and "0 findings" in line


def test_wire_and_config_analyzers_run_for_real():
    lines = []
    assert amain.run_all(
        only=("proto-drift", "config-registry"), out=lines.append
    ) == 0
    joined = "\n".join(lines)
    assert "proto-drift: OK" in joined and "in sync" in joined
    assert "config-registry: OK" in joined


# ------------------------------------------------------------- the port --


def test_list_is_the_references_matrix_minus_jaxlint(capsys):
    """The reference's matrix with ``jaxlint``'s slot taken by
    ``devlint``."""
    assert amain.main(["--list"]) == 0
    listed = capsys.readouterr().out.split()
    assert listed == [
        "devlint" if n == "jaxlint" else n for n in ref_main.ANALYZERS
    ]
    assert listed == [
        "planlint", "serde-audit", "devlint", "racelint", "compile-vocab",
        "lifelint", "proto-drift", "config-registry", "eqlint", "detlint",
        "stalelint", "durlint",
    ]
    assert amain._SHARED_CORPUS == ref_main._SHARED_CORPUS


def test_whole_gate_json_is_green_on_the_cpu(capsys):
    """The whole gate with three TPC-H queries on the CPU: every analyzer
    green, the suppression ledger within budget, one exit code."""
    rc = amain.main(["--json", "--device", "cpu", "--queries", "1,3,6"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["ok"] and doc["failed"] == [], doc
    assert [a["name"] for a in doc["analyzers"]] == list(amain.ANALYZERS)
    assert all(a["ok"] and a["seconds"] >= 0 for a in doc["analyzers"]), doc
    assert set(doc["suppressions"]) == {
        "devlint", "racelint", "lifelint", "eqlint", "detlint", "stalelint",
        "durlint",
    }
    for name, row in doc["suppressions"].items():
        assert row["used"] <= row["budget"] == 5, (name, row)


def test_default_device_is_cuda_and_refuses_without_a_card():
    """Like every entry point of the port, the gate runs on cuda unless
    asked for the CPU; without a card it exits before any analyzer runs."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False; "
         "from ballista_tpu_torch.analysis.__main__ import main; sys.exit(main([]))"],
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "planlint" not in proc.stdout


def test_write_config_docs_writes_the_ports_own_table(monkeypatch, tmp_path, capsys):
    from ballista_tpu_torch.analysis import configlint

    target = tmp_path / "config.md"
    monkeypatch.setattr(configlint, "docs_path", lambda: target)
    assert amain.main(["--write-config-docs"]) == 0
    assert target.read_text() == configlint.render_config_docs()
    assert str(target) in capsys.readouterr().out
