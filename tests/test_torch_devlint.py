"""The port's device-program lint (``ballista_tpu_torch/analysis/devlint.py``)
and the device-program vocabulary it closes (``compilecache/registry.py``
``check_vocabulary``).

The cases of ``tests/test_planlint.py`` in torch idiom: the linter runs
clean over the port's device programs, every rule fires on a synthetic
violation on the line jaxlint's counterpart fires on, non-programs are
not linted, and the ``# devlint: disable=`` escape hatch has the line and
function scopes. Then the port's own: the order-free-sum rule fires on a
float ``index_add_`` and stays quiet on ``.to(torch.int64)``, the port's
known integer sites pass without a suppression, and the vocabulary is
closed in both directions (a seeded unregistered function and a stale
entry are each found in a temp copy of the package)."""

import shutil
import textwrap

import pytest

from ballista_tpu.analysis import jaxlint
from ballista_tpu_torch.analysis import devlint
from ballista_tpu_torch.compilecache import registry

_HEADER = "import torch\nimport numpy as np\n"
_REF_HEADER = "import jax, functools\nimport jax.numpy as jnp\nimport numpy as np\n"


def _lint(body: str, programs=("k",)):
    return devlint.lint_source(_HEADER + textwrap.dedent(body), "synth.py", list(programs))


def _jitted(body: str) -> str:
    """A synthetic port program as the reference's jitted kernel."""
    return body.replace("def k(x: torch.Tensor)", "@jax.jit\n        def k(x)")


def _ref_lines(body: str):
    diags, _ = jaxlint.lint_source(_REF_HEADER + textwrap.dedent(body), "synth.py")
    return [(d.line, d.rule) for d in diags]


# ------------------------------------------------------------ tier-1 gate --


def test_device_programs_lint_clean():
    """The shipped device programs have zero card hazards."""
    diags = devlint.lint_paths()
    assert diags == [], "\n".join(str(d) for d in diags)


def test_rule_catalog_documented():
    assert set(devlint.RULES) == {"host-sync", "dynamic-shape", "order-free-sum"}
    assert all(len(v) > 20 for v in devlint.RULES.values())
    # jaxlint's rules the port keeps; missing-static has no counterpart
    assert set(jaxlint.RULES) - set(devlint.RULES) == {"tracer-branch", "missing-static"}
    assert "missing-static" in devlint.__doc__ and "tracer-branch" in devlint.__doc__


# -------------------------------------------------------------- rules -----


def test_tensor_branch_fires_where_tracer_branch_does():
    body = """
        def k(x: torch.Tensor):
            if x > 0:
                return x
            while x < 3:
                x = x + 1
            return x
        """
    diags, _ = _lint(body)
    assert [d.rule for d in diags] == ["host-sync", "host-sync"]
    assert diags[0].kernel == "k"
    ref = _ref_lines(_jitted(body))
    assert [(d.line + 2, "tracer-branch") for d in diags] == ref


def test_tensor_branch_ignores_host_values_and_structure():
    diags, _ = _lint(
        """
        def k(x: torch.Tensor, mode, opt=None):
            if mode == "sum":          # a host value: fine
                x = x + 1
            if opt is not None:        # structure: fine
                x = x + opt
            if x.dim() > 1:            # metadata: fine
                x = x.sum()
            if x.shape[0] > 4:         # metadata: fine
                x = x[:4]
            return x
        """
    )
    assert diags == []


def test_reduction_branch_fires():
    diags, _ = _lint(
        """
        def k(mask):
            if mask.any():
                return 1
            assert mask.all()
            return 0
        """
    )
    assert [(d.line, d.rule) for d in diags] == [(5, "host-sync"), (7, "host-sync")]


def test_host_sync_fires():
    body = """
        def k(x: torch.Tensor):
            a = x.item()
            b = float(x)
            c = x.cpu()
            d = x.tolist()
            e = x.numpy()
            torch.cuda.synchronize()
            return a + b
        """
    diags, _ = _lint(body)
    assert [d.rule for d in diags] == ["host-sync"] * 6
    # the lines jaxlint's host-sync takes (.item(), float(), np.asarray,
    # device_get) are this one's too
    ref = _ref_lines(
        """
        @jax.jit
        def k(x):
            a = x.item()
            b = float(x)
            c = np.asarray(x)
            d = jax.device_get(x)
            return a + b
        """
    )
    assert [(line - 2, r) for line, r in ref] == [(d.line, d.rule) for d in diags[:4]]


def test_host_sync_spares_numpy_and_python_values():
    diags, _ = _lint(
        """
        def k(x: torch.Tensor, n):
            t = np.asarray([1, 2]).tolist()
            a = np.zeros(3)
            b = a.tolist()
            c = int(n)
            d = int(x.shape[0])
            return t, b, c, d
        """
    )
    assert diags == []


def test_dynamic_shape_fires_and_static_forms_pass():
    body = """
        def k(x: torch.Tensor):
            a = torch.nonzero(x)
            b = torch.where(x > 0)
            return a, b
        """
    diags, _ = _lint(body)
    assert [d.rule for d in diags] == ["dynamic-shape", "dynamic-shape"]
    ref = _ref_lines(_jitted(body).replace("torch.nonzero", "jnp.nonzero").replace("torch.where", "jnp.where"))
    assert [(line - 2, r) for line, r in ref] == [(d.line, d.rule) for d in diags]
    ok, _ = _lint(
        """
        def k(x: torch.Tensor, valid):
            b = torch.where(x > 0, x, 0)   # 3-arg where is shape-stable
            order = torch.argsort(~valid, stable=True)
            return b[order]
        """
    )
    assert ok == []


def test_boolean_mask_indexing_fires():
    diags, _ = _lint(
        """
        def k(x: torch.Tensor, batch):
            a = x[x > 0]
            keep = batch.valid & (x < 3)
            b = x[keep]
            x[~keep] = 0
            c = x.masked_select(keep)
            d = torch.unique(x)
            return a, b, c, d
        """
    )
    assert [(d.line, d.rule) for d in diags] == [
        (5, "dynamic-shape"), (7, "dynamic-shape"), (8, "dynamic-shape"),
        (9, "dynamic-shape"), (10, "dynamic-shape"),
    ]


def test_order_free_sum_fires_on_floats_and_spares_integers():
    diags, _ = _lint(
        """
        def k(idx, vals, flags):
            acc = torch.zeros(8, dtype=torch.float64).index_add_(0, idx, vals)
            s = torch.cumsum(vals, 0)
            t = vals.cumsum(0)
            r = torch.zeros(8, dtype=torch.float64).scatter_reduce_(0, idx, vals, "sum")
            m = torch.zeros(8, dtype=torch.float64).scatter_add_(0, idx, vals)
            return acc, s, t, r, m
        """
    )
    assert [(d.line, d.rule) for d in diags] == [(n, "order-free-sum") for n in (5, 6, 7, 8, 9)]
    ok, _ = _lint(
        """
        def k(idx, vals, flags, changed, batch):
            valid = batch.valid
            a = torch.cumsum(flags.to(torch.int64), 0)
            seg = torch.cumsum(changed.to(torch.int32), 0) - 1
            lengths = torch.zeros(9, dtype=torch.int64)
            lengths = lengths.index_add_(0, seg, torch.ones_like(seg))[:8]
            first = torch.full((9,), 8, dtype=torch.int64)
            first = first.scatter_reduce_(0, idx, vals, reduce="amin")
            c = torch.cumsum(vals, 0, dtype=torch.int64)
            d = torch.cumsum(torch.bincount(idx, minlength=8), 0)
            e = torch.cumsum(valid, 0)
            f = torch.cumsum(torch.where(valid, 1, 0), 0)
            return a, lengths, first, c, d, e, f
        """
    )
    assert ok == [], [str(d) for d in ok]


def test_cpu_only_branches_are_not_linted():
    diags, _ = _lint(
        """
        def k(x: torch.Tensor, idx):
            if x.device.type == "cpu":
                return torch.from_numpy(np.sqrt(x.numpy()))
            if x.device.type != "cpu":
                y = torch.sqrt(x)
            else:
                y = x.numpy()
            return y.cumsum(0)
        """
    )
    assert [(d.line, d.rule) for d in diags] == [(11, "order-free-sum")]


def test_callees_in_the_module_are_linted_and_host_only_ones_are_not():
    src = _HEADER + textwrap.dedent(
        """
        def helper(x: torch.Tensor):
            return x.item()

        def plain(x: torch.Tensor):
            return torch.cumsum(x, 0)

        def k(x: torch.Tensor):
            return helper(x) + plain(x)

        def host(x: torch.Tensor):
            return x.tolist()
        """
    )
    diags, linted = devlint.lint_source(src, "synth.py", ["k"], "m", frozenset({"m.plain"}))
    assert [(d.kernel, d.rule) for d in diags] == [("helper", "host-sync")]
    assert sorted(p.name for p in linted) == ["helper", "k"]


def test_non_programs_not_linted():
    diags, kernels = _lint(
        """
        def host_helper(x: torch.Tensor):
            if x > 0:                 # not a device program: out of scope
                return float(x)
            return x.numpy()
        """,
        programs=(),
    )
    assert diags == [] and kernels == []


# -------------------------------------------------------- suppression -----


def test_suppression_line_and_function_scope():
    diags, _ = _lint(
        """
        def k(x: torch.Tensor):
            if x > 0:  # devlint: disable=host-sync
                return x
            return torch.nonzero(x)
        """
    )
    assert [d.rule for d in diags] == ["dynamic-shape"]
    diags2, _ = _lint(
        """
        def k(x: torch.Tensor):  # devlint: disable=all
            if x > 0:
                return x.item()
            return x
        """
    )
    assert diags2 == []


def test_suppressions_are_few_and_counted():
    assert devlint.suppression_count() == 3
    # syncs by design: the shrink's first-sight count, the mesh layout's
    # live count (it picks the shard capacity) and the mesh stages' one
    # read of their overflow flags a step
    root = devlint._package_root()
    for rel in ("exec/shrink.py", "parallel/mesh.py", "parallel/stage.py"):
        assert (root / rel).read_text().count("# devlint: disable=host-sync") == 1, rel


# ------------------------------------------------------------- the port --


@pytest.mark.parametrize("rel,lines", [
    ("ops/join.py", ("torch.cumsum(changed.to(torch.int64), 0)", "lengths.index_add_(0, seg",
                     'reduce="amin"', "count.index_add_(0, rel")),
    ("ops/aggregate.py", ("torch.cumsum(valid.to(torch.int64), 0)", "torch.cumsum(changed.to(torch.int32), 0)")),
    ("exec/window.py", ("torch.cumsum(changed.to(torch.int32), 0)",
                        "torch.cumsum((part_changed | order_changed).to(torch.int64), 0)")),
    ("exec/percentile.py", ("torch.cumsum(live.to(torch.int64), 0)",)),
])
def test_known_integer_sites_pass_without_a_suppression(rel, lines):
    """Every function of the file linted as a program: the integer sums
    raise no order-free-sum finding and carry no suppression."""
    f = devlint._package_root() / rel
    text = f.read_text()
    diags, _ = devlint.lint_source(text, rel)
    for needle in lines:
        assert needle in text, needle
        line = next(i for i, ln in enumerate(text.splitlines(), 1) if needle in ln)
        assert not [d for d in diags if d.line == line and d.rule == "order-free-sum"], needle
        assert "devlint:" not in text.splitlines()[line - 1]


def test_report_lists_entries_launchers_and_public_functions():
    report = devlint.device_program_report()
    assert {k for k in report if k.startswith("cuda.")} >= {
        "cuda.onehot_sums_f64", "cuda.partition_hash", "cuda.partition_groups", "cuda.prefix_sum_f64",
    }
    assert report["ops.onehot_agg.onehot_sums"]["launches"] == ["cuda.onehot_sums_f64"]
    assert report["ops.partition._launch_hash"]["launches"] == ["cuda.partition_hash"]
    assert report["ops.prefix_sum._launch"]["launches"] == ["cuda.prefix_sum_f64"]
    assert "ops.perm.stable_argsort" in report and "ops.perm._private" not in report
    assert "expr.physical.compile_expr" in report and "exec.shrink.maybe_shrink" in report


def test_vocabulary_closed_over_source_report():
    assert registry.check_vocabulary() == []
    assert not set(registry.PROGRAMS) & set(registry.HOST_ONLY)
    assert all(len(why) > 10 for why in registry.HOST_ONLY.values())


def _package_copy(tmp_path):
    root = tmp_path / "ballista_tpu_torch"
    src = devlint._package_root()
    for sub in ("ops", "csrc", "expr", "exec", "parallel"):
        shutil.copytree(src / sub, root / sub, ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_unregistered_ops_function_is_found(tmp_path):
    root = _package_copy(tmp_path)
    f = root / "ops" / "perm.py"
    f.write_text(f.read_text() + "\n\ndef novel_gather(col, perm):\n    return col[perm]\n")
    problems = registry.check_vocabulary(devlint.device_program_report(root))
    assert len(problems) == 1 and problems[0].startswith("unregistered kernel ops.perm.novel_gather ("), problems


def test_unregistered_kernel_entry_and_launcher_are_found(tmp_path):
    root = _package_copy(tmp_path)
    cu = root / "csrc" / "prefix_sum.cu"
    cu.write_text(cu.read_text() + '\nextern "C" {\nint novel_scan(const double* x) { return 0; }\n}\n')
    f = root / "ops" / "prefix_sum.py"
    f.write_text(f.read_text() + "\n\ndef _novel(lib, x):\n    return lib.novel_scan(x.data_ptr())\n")
    problems = registry.check_vocabulary(devlint.device_program_report(root))
    assert [p.split(" (")[0] for p in problems] == [
        "unregistered kernel cuda.novel_scan", "unregistered kernel ops.prefix_sum._novel",
    ], problems


def test_stale_entry_is_found(tmp_path):
    root = _package_copy(tmp_path)
    f = root / "ops" / "search.py"
    f.write_text(f.read_text().replace("def searchsorted(", "def _searchsorted_gone("))
    problems = registry.check_vocabulary(devlint.device_program_report(root))
    assert problems == [
        "stale registry entry ops.search.searchsorted: kernel no longer in the device program report"
    ], problems
