"""Config-key & env-var registry closure of the port
(``ballista_tpu_torch/analysis/configlint.py`` over ``config._ENTRIES`` and
``config.ENV_REGISTRY``), the cases of ``tests/test_config_registry.py``:
every ``ballista.*`` key literal and ``BALLISTA_*`` env read of the port
resolves to a declared entry (each fixture also through the reference's
lint, with the same findings), and the generated table
``ballista_tpu_torch/docs/config.md`` is pinned, with the reference's key
names and defaults and the ``UNPORTED`` keys marked."""

import logging
import re

_PKG = re.compile(r"\bballista_tpu\b(?!\.proto)")
_PORT_PKG = re.compile(r"\bballista_tpu_torch\b")


def _port(text: str) -> str:
    return _PKG.sub("ballista_tpu_torch", text)


def _ref(text: str) -> str:
    return _PORT_PKG.sub("ballista_tpu", text)


from ballista_tpu.analysis import configlint as ref_configlint
from ballista_tpu_torch import config as cfg
from ballista_tpu_torch.analysis import configlint as port_configlint


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


configlint = _HeldAgainstReference(port_configlint, ref_configlint)


def _rules(src: str):
    return [d.rule for d in configlint.lint_source(src)]


# ------------------------------------------------------------ tier-1 gate --


def test_tree_is_closed_over_the_registries():
    diags, summary = configlint.lint_tree()
    assert diags == [], "\n".join(str(d) for d in diags)
    # the scan saw real traffic (not vacuously green)
    import re

    m = re.match(r"(\d+) config-key literals \+ (\d+) env read", summary)
    assert m and int(m.group(1)) > 0 and int(m.group(2)) > 0, summary


def test_docs_config_md_is_pinned_to_the_registries():
    # the port's table lives in its package; docs/config.md is the reference's
    assert configlint.docs_path() == cfg_docs()
    assert configlint.docs_path().exists(), (
        "ballista_tpu_torch/docs/config.md missing — regenerate with "
        "`python -m ballista_tpu_torch.analysis --write-config-docs`"
    )
    assert configlint.docs_path().read_text() == (
        configlint.render_config_docs()
    ), (
        "docs/config.md is stale vs config.py registries — regenerate "
        "with `python -m ballista_tpu_torch.analysis --write-config-docs`"
    )


def test_generated_docs_cover_both_registries():
    text = configlint.render_config_docs()
    for name in cfg._ENTRIES:
        assert f"`{name}`" in text, name
    for e in cfg.ENV_REGISTRY:
        assert f"`{e.name}`" in text, e.name


# ----------------------------------------------------------- mutations --


def test_unknown_env_read_rejected_and_declared_accepted():
    assert _rules(
        'import os\nx = os.environ.get("BALLISTA_BOGUS_KNOB")\n'
    ) == ["unknown-env"]
    assert _rules(
        'import os\nx = os.environ.get("BALLISTA_TPU_PREWARM", "off")\n'
    ) == []
    # subscript + pop forms are covered too
    assert _rules(
        'import os\nx = os.environ["BALLISTA_NOPE"]\n'
    ) == ["unknown-env"]
    assert _rules(
        'import os\nos.environ.pop("BALLISTA_NOPE2", None)\n'
    ) == ["unknown-env"]


def test_fstring_env_reads_need_a_declared_prefix_family():
    assert _rules(
        "import os\n"
        "def f(name):\n"
        '    return os.environ.get(f"BALLISTA_SCHEDULER_{name}")\n'
    ) == []
    assert _rules(
        "import os\n"
        "def f(name):\n"
        '    return os.environ.get(f"BALLISTA_MYSTERY_{name}")\n'
    ) == ["unknown-env"]


def test_unknown_config_key_literal_rejected():
    assert _rules('k = "ballista.tpu.not_a_key"\n') == [
        "unknown-config-key"
    ]
    assert _rules('k = "ballista.tpu.prewarm"\n') == []
    # internal task props are declared by prefix
    assert _rules('k = "ballista.internal.task_attempt"\n') == []


# ------------------------------------------------------------- runtime --


def test_env_entry_for_exact_and_prefix():
    assert cfg.env_entry_for("BALLISTA_TPU_PREWARM").name == (
        "BALLISTA_TPU_PREWARM"
    )
    assert cfg.env_entry_for("BALLISTA_SCHEDULER_BIND_PORT").name == (
        "BALLISTA_SCHEDULER_*"
    )
    assert cfg.env_entry_for("BALLISTA_TYPO") is None


def test_warn_unknown_env_flags_typod_knobs(monkeypatch, caplog):
    monkeypatch.setenv("BALLISTA_PREWRAM", "on")  # the classic typo
    monkeypatch.setattr(cfg, "_ENV_WARNED", False)
    with caplog.at_level(logging.WARNING, logger="ballista_tpu_torch.config"):
        unknown = cfg.warn_unknown_env()
    assert "BALLISTA_PREWRAM" in unknown
    assert any("BALLISTA_PREWRAM" in r.message for r in caplog.records)


def test_warn_unknown_env_clean_when_all_declared(monkeypatch):
    monkeypatch.delenv("BALLISTA_PREWRAM", raising=False)
    # the test harness's own limit (tests/conftest.py) is no knob of the port
    monkeypatch.delenv("BALLISTA_TEST_TIME_LIMIT_S", raising=False)
    monkeypatch.setattr(cfg, "_ENV_WARNED", False)
    unknown = cfg.warn_unknown_env()
    assert unknown == [], unknown


# ------------------------------------------------------------ the port --


def cfg_docs():
    import pathlib

    import ballista_tpu_torch

    return pathlib.Path(ballista_tpu_torch.__file__).parent / "docs" / "config.md"


def _table(text: str) -> dict[str, tuple[str, str]]:
    """key -> (default, last column) of a generated session-settings table."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"\| `(ballista\.[^`]+)` \| .*? \| `([^`]*)` \| (.*) \|$", line)
        if m:
            out[m.group(1)] = (m.group(2), m.group(3))
    return out


def test_table_has_the_references_keys_and_defaults_with_unported_marked():
    ref = _table((ref_configlint.docs_path()).read_text())
    port = _table(port_configlint.render_config_docs())
    assert ref and set(port) == set(ref)
    assert {k: v[0] for k, v in port.items()} == {k: v[0] for k, v in ref.items()}
    for key, (_, status) in port.items():
        if key in cfg.UNPORTED:
            assert status == f"not ported: {cfg.UNPORTED[key]}", key
        else:
            assert status == "ported", key


def test_env_registry_declares_what_the_port_reads():
    """The reference's variables whose readers the port lacks are left
    out; the durability witness's is in, and so are the prewarm's (the
    mode, the bucket bound and the server ladder, read by
    ``compilecache/prewarm.py``) with the reference's kinds and defaults."""
    from ballista_tpu import config as ref_cfg

    names = {e.name for e in cfg.ENV_REGISTRY}
    for gone in ("BALLISTA_TPU_JAX_CACHE", "BALLISTA_TPU_NO_FUSE",
                 "BALLISTA_TEST_TIME_LIMIT_S"):
        assert gone not in names
    assert "BALLISTA_DUR_WITNESS" in names
    assert cfg.env_entry_for("BALLISTA_DUR_WITNESS").doc == "analysis/durwitness.py"
    for name in ("BALLISTA_TPU_PREWARM", "BALLISTA_TPU_PREWARM_BUCKETS",
                 "BALLISTA_TPU_CAPACITY_BUCKETS"):
        port, ref = cfg.env_entry_for(name), ref_cfg.env_entry_for(name)
        assert (port.kind, port.default) == (ref.kind, ref.default), name
        assert port.doc == "compilecache/prewarm.py"


def test_a_seeded_env_read_in_a_port_module_is_found(tmp_path):
    """The lint reads the port's own modules: an undeclared env read
    appended to a copy of the scheduler's rpc module is its one finding."""
    from ballista_tpu_torch.analysis.configlint import _check_file

    src = (cfg_docs().parents[1] / "scheduler" / "rpc.py").read_text()
    seeded = src + '\n\ndef _seeded():\n    return os.environ.get("BALLISTA_SEEDED_KNOB")\n'
    f = tmp_path / "rpc.py"
    f.write_text(seeded)
    diags = []
    _check_file(f, frozenset(cfg._ENTRIES), cfg.BALLISTA_INTERNAL_PREFIX, cfg.env_entry_for, diags)
    assert [(d.line, d.rule) for d in diags] == [(len(seeded.splitlines()), "unknown-env")]
