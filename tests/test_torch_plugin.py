"""UDF and UDAF plugins of the port against the reference's, on the CPU.

Every plugin is written once for each package (torch bodies for the port,
jnp bodies for the reference) and both run over the same numpy-seeded
input: the loader's cases of ``tests/test_plugin_and_utils.py`` on the
port's registry; scalar UDFs in a projection and in a filter; UDAFs with
SUM/COUNT states (``geo_mean``) and with MAX/MIN states (``spread``),
grouped by an int key (the sort path), by a dictionary key (the dense
path) and ungrouped, through ``TorchContext(device="cpu")`` against
``TpuContext`` and through the port's standalone cluster against the
reference's, also by ``functions.udaf`` in the DataFrame builder: keys and
counts exactly, floats within rtol 1e-9. A UDF body that returns a tensor
of another length, or off the batch's device, raises naming the UDF; a
custom ``PhysicalExtensionCodec`` carries an operator through the wire.
Cluster runs and the subprocess each have their own time limit."""

import concurrent.futures
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu.config import BallistaConfig as RefConfig
from ballista_tpu.exec.context import TpuContext
from ballista_tpu.plugin import global_registry as ref_registry
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import ExecutionError, PlanError
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.plugin import MODULE_PREFIX, UdfRegistry, global_registry

ROOT = pathlib.Path(__file__).resolve().parent.parent

CLUSTER_LIMIT_S = 240

PORT_PLUGIN = """
import torch
from ballista_tpu_torch.datatypes import DataType

def register(register_udf, register_udaf):
    register_udf("squareplus", lambda x, y: x * x + y, DataType.FLOAT64,
                 min_args=2, max_args=2)
    register_udf("clamp01", lambda x: torch.clamp(x, 0.0, 1.0), DataType.FLOAT64)
    register_udf("short_udf", lambda x: x[:-1], DataType.FLOAT64)
    register_udf("meta_udf", lambda x: torch.empty_like(x, device="meta"),
                 DataType.FLOAT64)
    register_udf("scalar_udf", lambda x: float(x.sum()), DataType.FLOAT64)
    register_udaf(
        "geo_mean",
        states=[("slog", "sum", lambda x: torch.log(x)), ("n", "count", None)],
        finalize=lambda s, n: torch.exp(s / torch.clamp(n, min=1).to(torch.float64)),
        return_type=DataType.FLOAT64,
    )
    register_udaf(
        "spread",
        states=[("hi", "max", None), ("lo", "min", None), ("n", "count", None)],
        finalize=lambda hi, lo, n: hi - lo,
        return_type=DataType.FLOAT64,
    )
"""

REF_PLUGIN = """
import jax.numpy as jnp
from ballista_tpu.datatypes import DataType

def register(register_udf, register_udaf):
    register_udf("squareplus", lambda x, y: x * x + y, DataType.FLOAT64,
                 min_args=2, max_args=2)
    register_udf("clamp01", lambda x: jnp.clip(x, 0.0, 1.0), DataType.FLOAT64)
    register_udaf(
        "geo_mean",
        states=[("slog", "sum", lambda x: jnp.log(x)), ("n", "count", None)],
        finalize=lambda s, n: jnp.exp(s / jnp.maximum(n, 1).astype(jnp.float64)),
        return_type=DataType.FLOAT64,
    )
    register_udaf(
        "spread",
        states=[("hi", "max", None), ("lo", "min", None), ("n", "count", None)],
        finalize=lambda hi, lo, n: hi - lo,
        return_type=DataType.FLOAT64,
    )
"""


@pytest.fixture(autouse=True)
def clean_registries():
    """Each test loads its own plugins into the process-wide registries."""
    global_registry.clear()
    ref_registry.clear()
    yield
    global_registry.clear()
    ref_registry.clear()


@pytest.fixture
def plugin_dirs(tmp_path):
    """One directory a package, each holding ``fns.py`` (the same stem)."""
    dirs = {}
    for side, src in (("port", PORT_PLUGIN), ("ref", REF_PLUGIN)):
        d = dirs[side] = tmp_path / f"plugins-{side}"
        d.mkdir()
        (d / "fns.py").write_text(textwrap.dedent(src))
    return dirs


def table(n: int = 2000, seed: int = 4) -> pa.Table:
    """An int key g (0-5; every v of g = 5 is null), a string key s, v in
    [0.5, 9) with 10% nulls, w in [0, 2)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 6, n)
    v = rng.uniform(0.5, 9.0, n)
    null = (rng.random(n) < 0.1) | (g == 5)
    return pa.table({
        "g": pa.array(g),
        "s": pa.array([f"k{x % 3}" for x in g]),
        "v": pa.array(v, mask=null),
        "w": pa.array(rng.uniform(0, 2, n)),
    })


def oracle(t: pa.Table, key: str) -> dict:
    """numpy oracle of ``GROUPED`` by ``key``: keys in order, geo_mean and
    spread over each group's non-null v (NaN for a group without one),
    COUNT(*)."""
    keys = np.asarray(t.column(key).to_pylist())
    v = t.column("v").to_numpy(zero_copy_only=False)
    out: dict = {key: [], "gm": [], "sp": [], "c": []}
    for k in np.unique(keys):
        part = v[keys == k]
        live = part[~np.isnan(part)]
        out[key].append(k.item())
        out["gm"].append(np.exp(np.log(live).mean()) if len(live) else np.nan)
        out["sp"].append(live.max() - live.min() if len(live) else np.nan)
        out["c"].append(len(part))
    return out


def contexts(dirs):
    ref = TpuContext(RefConfig().with_setting("ballista.plugin_dir", str(dirs["ref"])))
    port = TorchContext(BallistaConfig({"ballista.plugin_dir": str(dirs["port"])}), device="cpu")
    t = table()
    for c in (ref, port):
        c.register_table("t", t)
    return ref, port, t


def assert_same(got: pa.Table, want: pa.Table, exact=()) -> None:
    """Same columns and rows; ``exact`` columns and every non-float one
    exactly, the other floats within rtol 1e-9 (NaN/null where the other
    has it)."""
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        a = got.column(name).to_numpy(zero_copy_only=False)
        b = want.column(name).to_numpy(zero_copy_only=False)
        if name in exact or not pa.types.is_floating(want.schema.field(name).type):
            assert list(a) == list(b) or np.array_equal(a, b, equal_nan=True), name
        else:
            np.testing.assert_allclose(a.astype(float), b.astype(float), rtol=1e-9, err_msg=name)


GROUPED = (
    "select {key}, geo_mean(v) as gm, spread(v) as sp, count(*) as c "
    "from t group by {key} order by {key}"
)


def within(seconds: float, fn):
    """``fn()`` on a thread; fails the test if it takes over ``seconds``."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return pool.submit(fn).result(timeout=seconds)
    except concurrent.futures.TimeoutError:
        pytest.fail(f"took over {seconds} s")
    finally:
        pool.shutdown(wait=False)


def test_plugin_loader_and_registry(tmp_path):
    """The reference's loader cases on the port's registry: a broken file
    is skipped and retried, ``_``-prefixed files are ignored, names are
    case-insensitive, a clean directory is cached, a missing one is not;
    ``register(register_udf, register_udaf)`` by its parameters, with the
    hidden transforms of a UDAF."""
    (tmp_path / "my_udfs.py").write_text(textwrap.dedent("""
        import torch
        from ballista_tpu_torch.datatypes import DataType

        def register(register_udf):
            register_udf("clamp01", lambda x: torch.clamp(x, 0.0, 1.0),
                         DataType.FLOAT64)
            register_udf("hypot2", lambda x, y: x * x + y * y,
                         DataType.FLOAT64, min_args=2, max_args=2)
        """))
    (tmp_path / "_ignored.py").write_text("raise RuntimeError('never run')")
    (tmp_path / "broken.py").write_text("this is not python !!")

    reg = UdfRegistry()
    loaded = reg.load_dir(str(tmp_path))
    assert loaded == [f"{MODULE_PREFIX}my_udfs"]
    assert reg.names() == ["clamp01", "hypot2"]
    assert reg.get("CLAMP01") is not None and reg.get("hypot2").max_args == 2
    assert reg.load_dir(str(tmp_path)) == [f"{MODULE_PREFIX}my_udfs"]

    clean = tmp_path / "clean"
    clean.mkdir()
    (clean / "ok.py").write_text(
        "def register(register_udf, register_udaf):\n"
        "    register_udf('one', lambda x: x)\n"
        "    register_udaf('tot', [('s', 'sum', lambda x: x * 2), ('n', 'count', None)],\n"
        "                  lambda s, n: s)\n"
    )
    assert reg.load_dir(str(clean)) == [f"{MODULE_PREFIX}ok"]
    assert reg.load_dir(str(clean)) == []
    assert reg.udaf_names() == ["tot"] and reg.get_udaf("TOT").states == (("s", "sum", True), ("n", "count", False))
    assert "__udaf_tot_s" in reg.names()
    with pytest.raises(PlanError, match="bad op 'avg'"):
        reg.register_udaf("bad", [("s", "avg", None)], lambda s: s)

    missing = tmp_path / "not-yet"
    assert reg.load_dir(str(missing)) == []
    missing.mkdir()
    (missing / "late.py").write_text("def register(register_udf):\n    register_udf('late', lambda x: x)\n")
    assert reg.load_dir(str(missing)) == [f"{MODULE_PREFIX}late"]


def test_both_packages_load_one_stem_side_by_side(plugin_dirs, monkeypatch):
    """Both packages' ``fns.py`` load in one process, each under its own
    module name, and neither replaces the other's; the lookups keep the
    reference's messages; ``$BALLISTA_PLUGIN_DIR`` counts."""
    from ballista_tpu import plugin as ref_plugin
    from ballista_tpu_torch import plugin

    monkeypatch.delenv(plugin.PLUGIN_DIR_ENV, raising=False)
    assert ref_plugin.load_plugins(str(plugin_dirs["ref"])) == ["ballista_plugin_fns"]
    monkeypatch.setenv(plugin.PLUGIN_DIR_ENV, str(plugin_dirs["port"]))
    assert plugin.load_plugins() == [f"{MODULE_PREFIX}fns"]
    assert "torch" in vars(sys.modules[f"{MODULE_PREFIX}fns"])
    assert "jnp" in vars(sys.modules["ballista_plugin_fns"])
    assert global_registry.get("geo_mean") is None and global_registry.get_udaf("geo_mean") is not None
    for name in ("nosuch",):
        for look in ("lookup_udf", "lookup_udaf"):
            with pytest.raises(PlanError) as got:
                getattr(plugin, look)(name)
            with pytest.raises(Exception) as want:
                getattr(ref_plugin, look)(name)
            assert str(got.value) == str(want.value)


def test_udf_in_sql(plugin_dirs):
    """A two-argument UDF in a projection and a UDF in a filter, against
    the reference; an unknown name fails with the reference's message."""
    ref, port, _ = contexts(plugin_dirs)
    for sql in (
        "select squareplus(v, w) as s, clamp01(w) as c from t order by s",
        "select g, w from t where clamp01(w - 0.5) < 1 and squareplus(w, 1) > 2 order by w",
        "select g, sum(squareplus(w, v)) as q from t group by g order by g",
    ):
        assert_same(port.sql(sql).collect(), ref.sql(sql).collect())
    with pytest.raises(PlanError) as got:
        port.sql("select nosuchfn(v) from t").collect()
    with pytest.raises(Exception) as want:
        ref.sql("select nosuchfn(v) from t").collect()
    assert str(got.value) == str(want.value) and "nosuchfn" in str(got.value)


@pytest.mark.parametrize("key", ["g", "s"])
def test_udaf_in_sql(plugin_dirs, key):
    """geo_mean (SUM and COUNT states) and spread (MAX, MIN and COUNT
    states) by an int key (sort path) and a string key (dense path),
    against the reference and a numpy oracle; a group whose values are
    all null finalizes to NULL."""
    ref, port, t = contexts(plugin_dirs)
    sql = GROUPED.format(key=key)
    got, want = port.sql(sql).collect(), ref.sql(sql).collect()
    assert_same(got, want, exact=("sp",))
    o = oracle(t, key)
    assert got.column(key).to_pylist() == o[key]
    assert got.column("c").to_pylist() == o["c"]
    np.testing.assert_allclose(got.column("gm").to_numpy(zero_copy_only=False).astype(float), o["gm"], rtol=1e-9)
    np.testing.assert_array_equal(got.column("sp").to_numpy(zero_copy_only=False).astype(float), o["sp"])
    if key == "g":
        assert got.column("gm").null_count == got.column("sp").null_count == 1


def test_ungrouped_udaf(plugin_dirs):
    """An ungrouped UDAF finalizes over the merged states (against a
    numpy oracle: the reference's scalar final keeps the first state)."""
    _, port, t = contexts(plugin_dirs)
    got = port.sql("select geo_mean(v) as gm, spread(v) as sp from t").collect()
    v = t.column("v").drop_null().to_numpy()
    np.testing.assert_allclose(got.column("gm").to_pylist(), [np.exp(np.log(v).mean())], rtol=1e-9)
    assert got.column("sp").to_pylist() == [v.max() - v.min()]


def test_udf_that_breaks_the_contract_raises_naming_it(plugin_dirs):
    """A body must return one value a row, on the batch's device: another
    length, another device or a Python number raises ``ExecutionError``
    naming the UDF (nothing is copied or broadcast)."""
    _, port, _ = contexts(plugin_dirs)
    for name, what in (("short_udf", r"a tensor of shape \(\d+,\) on cpu"), ("meta_udf", "a tensor .* on meta"), ("scalar_udf", "float")):
        with pytest.raises(ExecutionError, match=f"UDF '{name}' returned {what}"):
            port.sql(f"select {name}(v) from t").collect()


def test_udaf_in_sql_distributed(plugin_dirs):
    """The port's standalone cluster against the reference's, the plugin
    directory a session setting: the partial, merge and final split at
    K = 4 by both keys, a UDF in the filter, and ``functions.udaf`` in the
    DataFrame builder; the port's cluster also equals its local context
    (sort-path sums by the same fixed order)."""
    from ballista_tpu import functions as RF
    from ballista_tpu.client.context import BallistaContext as RefClient
    from ballista_tpu_torch import functions as F
    from ballista_tpu_torch.client.context import BallistaContext

    t = table()
    s = {"ballista.shuffle.partitions": "4"}
    _, local, _ = contexts(plugin_dirs)
    sqls = [GROUPED.format(key=k) for k in ("g", "s")] + [
        "select g, geo_mean(v) as gm, sum(squareplus(w, v)) as q from t "
        "where clamp01(w - 0.5) < 1 group by g order by g"
    ]

    def run(side):
        if side == "ref":
            ctx = RefClient.standalone(RefConfig({**s, "ballista.plugin_dir": str(plugin_dirs["ref"])}))
        else:
            ctx = BallistaContext.standalone(
                BallistaConfig({**s, "ballista.plugin_dir": str(plugin_dirs["port"])}), device="cpu"
            )
        try:
            ctx.register_table("t", t)
            out = [ctx.sql(q).collect() for q in sqls]
            fn = RF if side == "ref" else F
            out.append(ctx.table("t").aggregate(["g"], [fn.udaf("geo_mean", "v").alias("gm")]).sort("g").collect())
            return out
        finally:
            ctx.close()

    got = within(CLUSTER_LIMIT_S, lambda: run("port"))
    want = within(CLUSTER_LIMIT_S, lambda: run("ref"))
    for g, w in zip(got, want):
        assert_same(g, w, exact=("sp",) if "sp" in w.column_names else ())
    for g, q in zip(got, sqls):
        assert_same(g, local.sql(q).collect(), exact=("sp",) if "sp" in g.column_names else ())


def test_udf_in_sql_subprocess(plugin_dirs):
    """A fresh process whose only plugins come from ``$BALLISTA_PLUGIN_DIR``
    plans and runs a UDF and a UDAF on the port (its own time limit)."""
    script = textwrap.dedent("""
        import numpy as np
        import pyarrow as pa
        from ballista_tpu_torch.exec.context import TorchContext

        ctx = TorchContext(device="cpu")
        ctx.register_table("t", pa.table({"a": [1.0, 2.0, 3.0], "b": [10.0, 20.0, 30.0], "g": [1, 1, 2]}))
        res = ctx.sql("select squareplus(a, b) as s from t order by s").collect()
        np.testing.assert_allclose(res.column("s").to_pylist(), [11.0, 24.0, 39.0])
        res = ctx.sql("select g, geo_mean(b) as gm from t group by g order by g").collect()
        np.testing.assert_allclose(res.column("gm").to_pylist(), [np.sqrt(200.0), 30.0], rtol=1e-12)
        print("UDF-SQL-OK")
        """)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "BALLISTA_PLUGIN_DIR": str(plugin_dirs["port"])}
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    assert "UDF-SQL-OK" in proc.stdout


def test_cli_lists_the_loaded_functions(plugin_dirs):
    """The shell's function list names the loaded UDFs (the UDAFs' hidden
    transforms among them) as the reference's does."""
    from ballista_tpu import cli as ref_cli
    from ballista_tpu_torch import cli

    contexts(plugin_dirs)
    port_only = {"short_udf", "meta_udf", "scalar_udf"}
    got = [x for x in cli.list_functions().splitlines() if x not in port_only]
    assert got == ref_cli.list_functions().splitlines()
    assert "__udaf_geo_mean_slog" in got and "squareplus" in got


def test_extension_codec_carries_an_operator(plugin_dirs):
    """A custom ``PhysicalExtensionCodec``: an operator the built-in serde
    does not know (a UDF-backed projection) crosses the wire as an
    extension node with its input, and the decoded plan runs to the same
    rows as the plan that was encoded."""
    from ballista_tpu_torch.columnar.arrow_interop import batch_to_arrow
    from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, execute_to_batches
    from ballista_tpu_torch.exec.pipeline import ProjectionExec
    from ballista_tpu_torch.expr import logical as L
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.serde import BallistaCodec, PhysicalExtensionCodec

    _, port, _ = contexts(plugin_dirs)

    class UdfProjectionExec(ExecutionPlan):
        """SELECT <udf>(v) AS r over its input."""

        def __init__(self, udf: str, input: ExecutionPlan):
            super().__init__()
            self.udf, self.input = udf, input
            self._proj = ProjectionExec(input, [L.Alias(L.ScalarFunction(udf, (L.Column("v"),)), "r")])

        def schema(self):
            return self._proj.schema()

        def children(self):
            return [self.input]

        def output_partitioning(self):
            return self._proj.output_partitioning()

        def execute(self, partition, ctx):
            return self._proj.execute(partition, ctx)

    class Codec(PhysicalExtensionCodec):
        name = "udf-projection"

        def try_encode(self, plan):
            return plan.udf.encode() if isinstance(plan, UdfProjectionExec) else None

        def try_decode(self, payload, inputs):
            return UdfProjectionExec(payload.decode(), inputs[0])

    plan = UdfProjectionExec("clamp01", port.create_physical_plan(port.sql_to_logical("select v from t")))
    codec = BallistaCodec(provider=port, extension=Codec())
    wire = codec.physical_to_proto(plan).SerializeToString()
    node = pb.PhysicalPlanNode.FromString(wire)
    assert node.extension.codec == "udf-projection" and node.extension.payload == b"clamp01"
    back = codec.physical_from_proto(node)
    assert codec.physical_to_proto(back).SerializeToString() == wire

    def rows(p):
        batches = execute_to_batches(p, TaskContext(device="cpu"))
        return pa.Table.from_batches([batch_to_arrow(b) for b in batches])

    assert rows(back).num_rows == 2000 and rows(back).equals(rows(plan))
