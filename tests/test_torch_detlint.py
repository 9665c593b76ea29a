"""detlint of the port (``ballista_tpu_torch/analysis/detlint.py``): the
cases of ``tests/test_detlint.py``, each fixture run through the port's and
the reference's lint with the same findings, over the port's tree.

The one rule text that differs is the exemption of ``undeclared-rng``: the
reference exempts ``jax.random``'s explicit keys, the port a torch draw
that takes an explicit seeded ``torch.Generator``."""

import re

from ballista_tpu.analysis import detlint as ref_detlint
from ballista_tpu_torch.analysis import detlint as port_detlint

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


detlint = _HeldAgainstReference(port_detlint, ref_detlint)


def rules_of(diags):
    return [d.rule for d in diags]


def test_tree_is_clean():
    files = detlint.target_files()
    root = detlint._package_root()
    assert root.name == "ballista_tpu_torch" and all(f.is_relative_to(root) for f in files)
    assert {"ops/partition.py", "exec/joins.py", "scheduler/server.py"} <= {
        f.relative_to(root).as_posix() for f in files
    }
    diags = detlint.lint_paths()
    assert diags == [], "\n".join(str(d) for d in diags)
    assert detlint.suppression_count() == 0


def test_rules_are_the_references():
    assert port_detlint.RULES == ref_detlint.RULES
    assert port_detlint.TARGET_DIRS == ref_detlint.TARGET_DIRS
    assert port_detlint.WALLCLOCK_DIRS == ref_detlint.WALLCLOCK_DIRS


def test_a_seeded_fault_in_a_port_module_is_found(tmp_path):
    """The lint reads the port's own modules: a wall-clock read appended
    to a copy of the partition wrapper is its one finding."""
    src = (detlint._package_root() / "ops" / "partition.py").read_text()
    seeded = src + "\n\ndef _seeded():\n    import time\n    return time.time()\n"
    f = tmp_path / "ops" / "partition.py"
    f.parent.mkdir()
    f.write_text(seeded)
    diags = detlint.lint_paths([f])
    assert rules_of(diags) == ["wallclock-in-dataplane"]
    assert diags[0].line == len(seeded.splitlines())


def test_declared_nondet_sites_pinned():
    sites = detlint.nondet_sites()
    # scheduler placement picks + id minting are the ONLY declared
    # nondeterminism in the tree; anything new must be justified here
    assert sorted({(f.split("/")[-1], why) for f, _, why in sites}) == [
        ("server.py", "id-minting"),
        ("stage_manager.py", "placement"),
    ], sites
    assert len(sites) == 6, sites


def test_unordered_set_iteration_rejected():
    src = (
        "def route(parts):\n"
        "    s = {p for p in parts}\n"
        "    out = []\n"
        "    for p in s:\n"
        "        out.append(p)\n"
        "    return out + list(set(parts))\n"
    )
    diags = detlint.lint_source(src, "ballista_tpu_torch/exec/x.py")
    assert rules_of(diags) == ["unordered-iteration"] * 2


def test_set_typed_attribute_and_annotation_inference():
    src = (
        "class M:\n"
        "    def __init__(self):\n"
        "        self.pending = set()\n"
        "    def drain(self):\n"
        "        return [k for k in self.pending]\n"
        "def parents() -> set[int]:\n"
        "    return set()\n"
        "def walk():\n"
        "    for p in parents():\n"
        "        print(p)\n"
    )
    diags = detlint.lint_source(src, "ballista_tpu_torch/scheduler/x.py")
    assert rules_of(diags) == ["unordered-iteration"] * 2


def test_sorted_wrapping_accepts():
    src = (
        "def route(parts):\n"
        "    s = set(parts)\n"
        "    return [p for p in sorted(s)]\n"
    )
    assert detlint.lint_source(src, "ballista_tpu_torch/exec/x.py") == []


def test_undeclared_rng_rejected_and_nondet_marker_accepts():
    bad = "import random\ndef pick(xs):\n    return random.choice(xs)\n"
    diags = detlint.lint_source(bad, "ballista_tpu_torch/scheduler/x.py")
    assert rules_of(diags) == ["undeclared-rng"]
    ok = (
        "import random\n"
        "def pick(xs):\n"
        "    return random.choice(xs)  # detlint: nondet=placement\n"
    )
    assert detlint.lint_source(ok, "ballista_tpu_torch/scheduler/x.py") == []
    # the exemption, the one rule text that differs: the reference exempts
    # jax.random's explicit keys, the port a draw with a seeded generator
    jx = "import jax\ndef f(k):\n    return jax.random.uniform(k)\n"
    assert ref_detlint.lint_source(jx, "ballista_tpu/ops/x.py") == []
    assert rules_of(port_detlint.lint_source(jx, "ballista_tpu_torch/ops/x.py")) == ["undeclared-rng"]
    seeded = (
        "import torch\n"
        "def f(n, seed):\n"
        "    g = torch.Generator().manual_seed(seed)\n"
        "    return torch.randperm(n, generator=g)\n"
    )
    assert port_detlint.lint_source(seeded, "ballista_tpu_torch/ops/x.py") == []
    unseeded = "import torch\ndef f(n):\n    return torch.randperm(n)\n"
    diags = port_detlint.lint_source(unseeded, "ballista_tpu_torch/ops/x.py")
    assert rules_of(diags) == ["undeclared-rng"] and "torch.randperm" in diags[0].message


def test_wallclock_rejected_in_dataplane_only():
    src = "import time\ndef stamp():\n    return time.time()\n"
    assert rules_of(
        detlint.lint_source(src, "ballista_tpu_torch/exec/x.py")
    ) == ["wallclock-in-dataplane"]
    assert rules_of(
        detlint.lint_source(src, "ballista_tpu_torch/ops/x.py")
    ) == ["wallclock-in-dataplane"]
    # control-plane timestamps (heartbeats, TTLs, deadlines) are fine
    assert detlint.lint_source(src, "ballista_tpu_torch/scheduler/x.py") == []
    # perf_counter (the Metrics timer primitive) is always fine
    pc = "import time\ndef t():\n    return time.perf_counter()\n"
    assert detlint.lint_source(pc, "ballista_tpu_torch/exec/x.py") == []


def test_reduction_order_rejected():
    src = (
        "from concurrent.futures import as_completed\n"
        "def merge(futs):\n"
        "    total = 0.0\n"
        "    for f in as_completed(futs):\n"
        "        total += f.result()\n"
        "    return total\n"
    )
    diags = detlint.lint_source(src, "ballista_tpu_torch/exec/x.py")
    assert rules_of(diags) == ["reduction-order"]


def test_completion_order_rejected():
    src = (
        "from concurrent.futures import as_completed\n"
        "def fetch(futs):\n"
        "    out = []\n"
        "    for f in as_completed(futs):\n"
        "        out.append(f.result())\n"
        "    return out\n"
        "def stream(futs):\n"
        "    for f in as_completed(futs):\n"
        "        yield f.result()\n"
    )
    diags = detlint.lint_source(src, "ballista_tpu_torch/executor/x.py")
    assert rules_of(diags) == ["completion-order"] * 2


def test_index_ordered_loop_accepts():
    # the shipped overlapped-fetch shape: iterate locations IN ORDER,
    # drain each location's own queue — no completion-order dependence
    src = (
        "def merge(queues):\n"
        "    out = []\n"
        "    for q in queues:\n"
        "        while True:\n"
        "            item = q.get()\n"
        "            if item is None:\n"
        "                break\n"
        "            out.append(item)\n"
        "    return out\n"
    )
    assert detlint.lint_source(src, "ballista_tpu_torch/executor/x.py") == []


def test_suppression_scope():
    src = (
        "import random\n"
        "def pick(xs):  # detlint: disable=undeclared-rng\n"
        "    return random.choice(xs)\n"
    )
    assert detlint.lint_source(src, "ballista_tpu_torch/scheduler/x.py") == []
