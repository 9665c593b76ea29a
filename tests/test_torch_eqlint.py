"""eqlint of the port (``ballista_tpu_torch/analysis/eqlint.py``): the
no-uncertified-mutation closure over ``ballista_tpu_torch/``.

The port's tree must be clean with zero suppressions (every structural
plan mutation routes through ``ballista_tpu_torch/rewrite.py`` or
``exec.base.replace_children``), and each case of ``tests/test_eqlint.py``
must give the reference lint's findings: the same rules on the same lines,
with the message naming the port's rewrite module."""

import pytest

from ballista_tpu.analysis import eqlint as ref_eqlint
from ballista_tpu_torch.analysis import eqlint


def rules_of(diags):
    return [d.rule for d in diags]


def lint_both(src: str, filename: str):
    """The port's findings, after holding them against the reference's."""
    got = eqlint.lint_source(src, filename)
    want = ref_eqlint.lint_source(src, filename)
    assert [(d.file, d.line, d.rule) for d in got] == [(d.file, d.line, d.rule) for d in want]
    assert [d.message for d in got] == [
        d.message.replace("ballista_tpu.rewrite", "ballista_tpu_torch.rewrite") for d in want
    ]
    return got


def test_tree_is_clean():
    files = eqlint.target_files()
    names = {f.relative_to(eqlint._package_root()).as_posix() for f in files}
    # the lint surface: the port's plan-building, splitting, serializing
    # and executing modules, the mesh tier's among them
    assert {"exec/joins.py", "exec/mesh.py", "executor/shuffle.py", "scheduler/server.py",
            "scheduler/aqe.py", "client/context.py", "obs/profile.py", "distributed_plan.py",
            "serde.py", "standalone.py", "cli.py", "plugin.py", "parallel/stage.py"} <= names
    diags = eqlint.lint_paths()
    assert diags == [], "\n".join(str(d) for d in diags)
    assert eqlint.suppression_count() == 0


def test_rules_and_fields_are_the_references():
    assert eqlint.RULES == ref_eqlint.RULES
    assert eqlint.CHILD_SLOTS == ref_eqlint.CHILD_SLOTS
    assert eqlint.STRUCT_FIELDS == ref_eqlint.STRUCT_FIELDS
    assert eqlint.SANCTIONED_FILES == ref_eqlint.SANCTIONED_FILES == {"rewrite.py"}
    assert eqlint.SANCTIONED_FUNCTIONS == ref_eqlint.SANCTIONED_FUNCTIONS
    assert eqlint.TARGET_DIRS == ref_eqlint.TARGET_DIRS
    assert eqlint.TARGET_FILES == ref_eqlint.TARGET_FILES


def test_direct_child_slot_write_rejected():
    src = (
        "def resolve(node, other):\n"
        "    node.input = other\n"
        "    node.left, node.right = other, other\n"
    )
    diags = lint_both(src, "scheduler/server.py")
    assert rules_of(diags) == ["uncertified-plan-write"] * 3
    assert "rewrite" in diags[0].message


def test_structural_scalar_write_rejected():
    src = (
        "def adapt(join, writer):\n"
        "    join.join_type = 'left'\n"
        "    join.partition_mode = 'collect'\n"
        "    writer.output_partitions = 8\n"
        "    writer.partition_keys = []\n"
    )
    diags = lint_both(src, "exec/x.py")
    assert rules_of(diags) == ["uncertified-plan-write"] * 4


def test_stage_template_swap_rejected():
    src = (
        "def swap(job, other):\n"
        "    st = job.stages[3]\n"
        "    st.plan = other\n"
        "    job.stages[4].plan = other\n"
    )
    diags = lint_both(src, "scheduler/server.py")
    assert rules_of(diags) == ["uncertified-stage-write"] * 2


def test_constructors_are_sanctioned():
    src = (
        "class FooExec:\n"
        "    def __init__(self, input, exprs):\n"
        "        self.input = input\n"
        "        self.exprs = list(exprs)\n"
    )
    assert lint_both(src, "exec/foo.py") == []
    # dataclass __post_init__ counts as construction too
    src2 = (
        "class Stage:\n"
        "    def __post_init__(self):\n"
        "        self.inputs = []\n"
    )
    assert lint_both(src2, "scheduler/x.py") == []


def test_self_write_outside_init_is_a_finding():
    src = (
        "class FooExec:\n"
        "    def execute(self, p, ctx):\n"
        "        self.input = None\n"
    )
    diags = lint_both(src, "exec/foo.py")
    assert rules_of(diags) == ["uncertified-plan-write"]


def test_sanctioned_sites_pass():
    body = "def f(p, c):\n    p.input = c\n"
    assert lint_both(body, "rewrite.py") == []
    rc = "def replace_children(p, cs):\n    p.left, p.right = cs\n"
    assert lint_both(rc, "exec/base.py") == []
    # the same function name in another file is NOT sanctioned
    assert lint_both(rc, "exec/joins.py") != []


def test_suppression_line_and_def_scope():
    line = (
        "def f(n, o):\n"
        "    n.input = o  # eqlint: disable=uncertified-plan-write\n"
    )
    assert lint_both(line, "exec/x.py") == []
    scoped = (
        "def f(n, o):  # eqlint: disable=all\n"
        "    n.input = o\n"
        "    n.join_type = 1\n"
    )
    assert lint_both(scoped, "exec/x.py") == []


def test_runtime_state_fields_exempt():
    # cost/state mutation is not semantics mutation
    src = (
        "def run(plan, ctx):\n"
        "    plan.metrics = None\n"
        "    plan._cache = (ctx, [])\n"
        "    plan._fn = None\n"
    )
    assert lint_both(src, "exec/x.py") == []


@pytest.mark.parametrize("rel", ["exec/base.py", "distributed_plan.py", "scheduler/server.py"])
def test_a_seeded_write_in_a_port_module_is_found(rel, tmp_path):
    """The lint reads the port's own modules: one structural write
    appended to a copy of each is its one finding."""
    src = (eqlint._package_root() / rel).read_text()
    seeded = src + "\n\ndef _seeded(node, other):\n    node.input = other\n"
    f = tmp_path / rel  # the basename keeps base.py's sanctioned primitive
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(seeded)
    diags = eqlint.lint_paths([f])
    assert rules_of(diags) == ["uncertified-plan-write"]
    assert diags[0].line == len(seeded.splitlines())

