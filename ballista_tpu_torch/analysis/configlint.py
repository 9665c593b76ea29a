"""configlint: config-key & env-var registry closure (the port's copy of
``ballista_tpu/analysis/configlint.py``, with its rules).

Two configuration surfaces exist: string-keyed session settings
(``ballista.*``, validated by :class:`~ballista_tpu_torch.config.BallistaConfig`
against its closed entry table ``config._ENTRIES``) and process-scoped
``BALLISTA_*`` environment variables (daemons, debug witnesses, cache
dirs, declared in ``config.ENV_REGISTRY``). A new
``os.environ.get("BALLISTA_…")`` added in a hot fix must not become an
undocumented, untyped, silently-defaulted knob.

configlint closes both, statically:

- every string literal shaped like a config key (``ballista.foo.bar``)
  anywhere in ``ballista_tpu_torch/`` must be a declared key of
  ``config._ENTRIES`` (or the task-scoped ``ballista.internal.`` prefix);
- every ``os.environ`` read/write of a ``BALLISTA_*`` name — literal or
  f-string with a literal prefix — must resolve to exactly one
  ``ENV_REGISTRY`` entry (prefix families like ``BALLISTA_SCHEDULER_*``
  cover the daemons' per-flag overrides);
- ``ballista_tpu_torch/docs/config.md`` is GENERATED from the two
  registries (:func:`render_config_docs`) and :func:`run` pins the
  committed file to the generated content, so the table cannot drift from
  the code. Keys of ``config.UNPORTED`` are marked there with the ROADMAP
  item that ports them.

At runtime, :func:`ballista_tpu_torch.config.warn_unknown_env` (wired into
cluster/daemon start) warns once about set-but-undeclared ``BALLISTA_*``
vars — the typo'd-knob case static analysis cannot see.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

_KEY_RE = re.compile(r"^ballista\.[a-z0-9_]+(\.[a-z0-9_]+)*$")


@dataclasses.dataclass(frozen=True)
class ConfigDiagnostic:
    file: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: {self.rule}: {self.message}"


def _package_files() -> list[pathlib.Path]:
    root = pathlib.Path(__file__).resolve().parent.parent
    return [
        f for f in sorted(root.rglob("*.py"))
        if "proto" not in f.parts  # generated descriptors
    ]


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _env_name_arg(arg: ast.AST) -> tuple[str, bool] | None:
    """(name-or-prefix, is_prefix) for a literal or f-string env name."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, False
    if isinstance(arg, ast.JoinedStr):
        prefix = ""
        for v in arg.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                prefix += v.value
            else:
                break
        return prefix, True
    return None


def _check_file(
    path: pathlib.Path, valid_keys: frozenset, internal_prefix: str,
    env_entry_for, diags: list[ConfigDiagnostic],
    source: str | None = None,
) -> tuple[int, int]:
    src = path.read_text() if source is None else source
    tree = ast.parse(src, filename=str(path))
    is_registry = path.name == "config.py"
    n_keys = n_env = 0
    for node in ast.walk(tree):
        # ---- env reads: os.environ.get/pop/setdefault + subscripts -----
        name_node = None
        if isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            if d.endswith(("environ.get", "environ.pop",
                           "environ.setdefault")) and node.args:
                name_node = node.args[0]
        elif isinstance(node, ast.Subscript):
            d = _dotted(node.value) or ""
            if d.endswith("environ"):
                name_node = node.slice
        if name_node is not None:
            got = _env_name_arg(name_node)
            if got is not None:
                name, is_prefix = got
                if name.startswith("BALLISTA"):
                    n_env += 1
                    if is_prefix:
                        # a computed name needs a declared * family
                        entry = env_entry_for(name + "X")
                        if entry is not None and not entry.name.endswith(
                            "*"
                        ):
                            entry = None
                    else:
                        entry = env_entry_for(name)
                    if entry is None:
                        diags.append(
                            ConfigDiagnostic(
                                str(path), node.lineno, "unknown-env",
                                f"env var {name + ('…' if is_prefix else '')!r}"
                                " read here has no config.ENV_REGISTRY "
                                "entry (type/default/doc) — declare it",
                            )
                        )
            continue
        # ---- config-key literals ---------------------------------------
        if (
            not is_registry
            and isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and _KEY_RE.match(node.value)
        ):
            n_keys += 1
            key = node.value
            if key in valid_keys or key.startswith(internal_prefix) or (
                internal_prefix.startswith(key)
            ):
                continue
            diags.append(
                ConfigDiagnostic(
                    str(path), node.lineno, "unknown-config-key",
                    f"config key literal {key!r} is not a declared "
                    "ConfigEntry (config.py) — unknown keys raise "
                    "ConfigError at runtime",
                )
            )
    return n_keys, n_env


def lint_tree() -> tuple[list[ConfigDiagnostic], str]:
    """Scan the package; returns (diagnostics, summary)."""
    from ballista_tpu_torch import config as cfg

    valid_keys = frozenset(cfg._ENTRIES)
    diags: list[ConfigDiagnostic] = []
    n_keys = n_env = 0
    for f in _package_files():
        k, e = _check_file(
            f, valid_keys, cfg.BALLISTA_INTERNAL_PREFIX,
            cfg.env_entry_for, diags,
        )
        n_keys += k
        n_env += e
    summary = (
        f"{n_keys} config-key literals + {n_env} env read sites resolve "
        f"to {len(valid_keys)} declared keys / "
        f"{len(cfg.ENV_REGISTRY)} env entries"
    )
    return diags, summary


def lint_source(
    source: str, filename: str = "synth.py"
) -> list[ConfigDiagnostic]:
    """Single-source convenience for tests."""
    from ballista_tpu_torch import config as cfg

    diags: list[ConfigDiagnostic] = []
    valid_keys = frozenset(cfg._ENTRIES)
    _check_file(
        pathlib.Path(filename), valid_keys, cfg.BALLISTA_INTERNAL_PREFIX,
        cfg.env_entry_for, diags, source=source,
    )
    return diags


# --------------------------------------------------------------------------
# generated docs
# --------------------------------------------------------------------------

_PARSER_KINDS = {
    "int": "int",
    "float": "float",
    "str": "str",
    "_parse_bool": "bool",
    "_parse_shuffle_compression": "none|lz4|zstd",
    "_parse_prewarm": "off|on|background",
    "_parse_capacity_buckets": "ladder spec",
    "_parse_trace": "off|on|path",
    "_parse_metrics_collector": "shipping|logging",
}


def _md(s: str) -> str:
    return re.sub(r"\s+", " ", s).strip().replace("|", "\\|")


def render_config_docs() -> str:
    """``ballista_tpu_torch/docs/config.md``, generated from the two
    registries. The committed file is pinned to this output by the
    ``config-registry`` analyzer: edit the registries, then regenerate with
    ``python -m ballista_tpu_torch.analysis --write-config-docs``."""
    from ballista_tpu_torch import config as cfg

    out = [
        "# Configuration reference",
        "",
        "<!-- GENERATED by ballista_tpu_torch/analysis/configlint.py —",
        "     do not edit by hand; regenerate with",
        "     `python -m ballista_tpu_torch.analysis --write-config-docs` -->",
        "",
        "Two configuration surfaces: **session settings** travel with "
        "every query, are validated against the closed table below "
        "(unknown keys raise `ConfigError`), and are read through typed "
        "getters on `BallistaConfig`; **environment variables** are "
        "process-scoped (daemon flags, debug witnesses, cache locations) "
        "and are declared in `config.ENV_REGISTRY`. The `config-registry` "
        "analyzer proves every read site in the package resolves to a "
        "declared entry, and `config.warn_unknown_env()` warns at "
        "cluster and daemon start about set-but-undeclared `BALLISTA_*` "
        "names. A key whose feature this engine does not have "
        "(`config.UNPORTED`) keeps its default; any other value raises "
        "`ConfigError` naming the ROADMAP item that ports it.",
        "",
        "## Session settings (`ballista.*`)",
        "",
        "| key | type | default | status |",
        "|---|---|---|---|",
    ]
    for name, (default, parse) in sorted(cfg._ENTRIES.items()):
        kind = _PARSER_KINDS.get(getattr(parse, "__name__", ""), "str")
        default = default if default != "" else "''"
        status = (
            f"not ported: {_md(cfg.UNPORTED[name])}"
            if name in cfg.UNPORTED else "ported"
        )
        out.append(f"| `{name}` | {kind} | `{default}` | {status} |")
    out += [
        "",
        "## Environment variables (`BALLISTA_*`)",
        "",
        "| variable | value | default | description | read by |",
        "|---|---|---|---|---|",
    ]
    for e in cfg.ENV_REGISTRY:
        default = e.default if e.default != "" else "''"
        out.append(
            f"| `{e.name}` | {e.kind} | `{default}` | "
            f"{_md(e.description)} | {e.doc} |"
        )
    out += [
        "",
        "Task-scoped internal props (`ballista.internal.*`) are stamped "
        "by the scheduler onto task definitions and stripped before "
        "session-config validation — they are not settable.",
        "",
    ]
    return "\n".join(out)


def docs_path() -> pathlib.Path:
    """The generated table, inside the package (the repo's
    ``docs/config.md`` is the reference's and is never written here)."""
    return pathlib.Path(__file__).resolve().parents[1] / "docs" / "config.md"


def run() -> tuple[bool, str]:
    """The combined-gate entry point: registry closure over the tree AND
    the generated-docs pin."""
    diags, summary = lint_tree()
    problems = [str(d) for d in diags]
    dp = docs_path()
    if not dp.exists():
        problems.append(
            f"{dp} missing — generate with "
            "`python -m ballista_tpu_torch.analysis --write-config-docs`"
        )
    elif dp.read_text() != render_config_docs():
        problems.append(
            f"{dp} is stale vs the registries — regenerate with "
            "`python -m ballista_tpu_torch.analysis --write-config-docs`"
        )
    if problems:
        return False, "\n".join(problems)
    return True, summary + "; ballista_tpu_torch/docs/config.md in sync"
