"""SQL on the mesh tier of the port, held against the reference: the ten
cases of ``tests/test_mesh_sql.py``.

One subprocess with the reference's 8-device virtual CPU mesh
(``CPU_MESH_ENV``) runs every case at once and writes each query's plan
``display()``, its result (Arrow IPC) and the shard each key of its mesh
aggregates and joins landed on. The port runs the same data (made by
the same code from the same seed) on a mesh of 8 shards on the CPU
(``BALLISTA_TPU_MESH_SHARDS=8``). Each case checks that the port plans the
reference's mesh operators with an equal ``display()``, routes every key
to the reference's shard, and holds its result to the reference's mesh
result and to the in-process reference's collect result (one device, so
no mesh): exact keys and counts, floats to rtol 1e-9, as the reference's
mesh tests hold theirs. Row order within
ties of a sort key is not compared, as the reference's tests do not. A
last case runs two mesh queries from two threads on one context.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.ipc as paipc
import pytest

from tests.torch_mesh_ref import run_reference

# (case, table-building code over ``rng`` = default_rng(11), queries,
# check): the data and queries of tests/test_mesh_sql.py, case for case
CASES = [
    ("groupby", """
n = 20000
t = pa.table({"k": pa.array(rng.integers(0, 500, n)),
              "v": pa.array(rng.uniform(0, 10, n)),
              "w": pa.array(rng.integers(1, 9, n))})
tables = {"t": t}
""", ["SELECT k, SUM(v) AS s, AVG(v) AS a, MAX(w) AS m, COUNT(*) AS c FROM t GROUP BY k ORDER BY k"],
     "frame"),
    ("join_groupby", """
n, nd = 30000, 400
fact = pa.table({"fk": pa.array(rng.integers(0, nd + 50, n)),
                 "v": pa.array(rng.uniform(0, 10, n))})
dim = pa.table({"id": pa.array(np.arange(nd, dtype=np.int64)),
                "grp": pa.array((np.arange(nd) % 23).astype(np.int64))})
tables = {"fact": fact, "dim": dim}
""", ["SELECT grp, SUM(v) AS s, COUNT(*) AS c FROM fact JOIN dim ON fk = id GROUP BY grp ORDER BY grp"],
     "frame"),
    ("expansion_join", """
n_l, n_r = 5000, 3000
left = pa.table({"k": pa.array(rng.integers(0, 200, n_l)),
                 "a": pa.array(rng.uniform(0, 1, n_l))})
right = pa.table({"k2": pa.array(rng.integers(0, 200, n_r)),
                  "b": pa.array(rng.uniform(0, 1, n_r))})
tables = {"l": left, "r": right}
""", ["SELECT SUM(a + b) AS s, COUNT(*) AS c FROM l JOIN r ON k = k2"], "frame"),
    ("semi_anti_left", """
n, nd = 8000, 97
fact = pa.table({"fk": pa.array(rng.integers(0, nd * 2, n)),
                 "v": pa.array(rng.uniform(0, 1, n))})
dim = pa.table({"id": pa.array(np.arange(nd, dtype=np.int64)),
                "name": pa.array([f"n{i}" for i in range(nd)])})
tables = {"fact": fact, "dim": dim}
""", [
        "SELECT COUNT(*) AS c FROM fact WHERE fk IN (SELECT id FROM dim)",
        "SELECT COUNT(*) AS c FROM fact WHERE fk NOT IN (SELECT id FROM dim)",
        "SELECT COUNT(*) AS c, COUNT(name) AS cn FROM fact LEFT JOIN dim ON fk = id",
    ], "frame"),
    ("string_key_groupby", """
n = 9000
cats = [f"cat{i}" for i in range(37)]
t = pa.table({"c": pa.array([cats[i % 37] for i in rng.integers(0, 37, n)]),
              "v": pa.array(rng.uniform(0, 5, n))})
tables = {"t": t}
""", ["SELECT c, SUM(v) AS s FROM t GROUP BY c ORDER BY c"], "frame"),
    ("order_by_limit", """
n = 40000
t = pa.table({"k": pa.array(rng.integers(0, 1000, n)),
              "v": pa.array(rng.uniform(0, 100, n)),
              "d": pa.array(rng.integers(0, 3650, n).astype(np.int32))})
tables = {"t": t}
""", [
        "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY s DESC, k ASC LIMIT 7",
        "SELECT k, v FROM t ORDER BY v DESC LIMIT 5 OFFSET 3",
    ], "topk"),
    ("sample_sort", """
n = 5000
t = pa.table({"k": rng.integers(0, 40, n),
              "g": rng.integers(0, 7, n),
              "v": np.round(rng.uniform(-100, 100, n), 2)})
tables = {"t": t}
""", ["SELECT k, g, v FROM t ORDER BY v DESC, k ASC, g ASC"], "frame"),
    ("ranking_window", """
n = 5000
t = pa.table({"k": rng.integers(0, 40, n),
              "g": rng.integers(0, 7, n),
              "v": np.round(rng.uniform(-100, 100, n), 2)})
tables = {"t": t}
""", [
        "SELECT k, g, v, row_number() OVER (PARTITION BY g ORDER BY v DESC) AS rn, "
        "rank() OVER (PARTITION BY g ORDER BY v DESC) AS rk FROM t"
    ], "rank"),
    ("frame_window", """
n = 5000
t = pa.table({"k": rng.integers(0, 40, n),
              "g": rng.integers(0, 7, n),
              "v": np.round(rng.uniform(-100, 100, n), 2)})
tables = {"t": t}
""", [
        "SELECT k, g, v, SUM(v) OVER (PARTITION BY g ORDER BY v "
        "ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS cs FROM t"
    ], "cumsum"),
    ("window_fallback", """
n = 400
t = pa.table({"v": np.round(rng.uniform(-10, 10, n), 2)})
tables = {"t": t}
""", ["SELECT v, row_number() OVER (ORDER BY v) AS rn FROM t"], "rn_order"),
    # not a case of tests/test_mesh_sql.py: the money sums of ROADMAP
    # queue 3's logged divergence (test_mesh_money_sums_agree_with_the_exact_sums)
    ("money_sums", """
n = 20000
t = pa.table({"k": pa.array(rng.integers(0, 50, n)),
              "m": pa.array(rng.integers(1, 10**7, n) / 100)})
tables = {"t": t}
""", ["SELECT k, SUM(m) AS s FROM t GROUP BY k ORDER BY k"], "frame"),
]
CASE_IDS = [c[0] for c in CASES]
# the mesh operators each case's plans must hold (and, for the fallback,
# must not)
WANT_OPS = {
    "groupby": ["MeshAggregateExec"],
    "join_groupby": ["MeshJoinExec", "MeshAggregateExec"],
    "expansion_join": ["MeshJoinExec"],
    "semi_anti_left": ["MeshJoinExec"],
    "string_key_groupby": ["MeshAggregateExec"],
    "order_by_limit": ["MeshSortExec(ici-all_gather"],
    "sample_sort": ["MeshSortExec(ici-sample-sort)"],
    "ranking_window": ["MeshWindowExec"],
    "frame_window": ["MeshWindowExec"],
    "window_fallback": [],
    "money_sums": ["MeshAggregateExec"],
}

# Routing: the shard each group key of a mesh aggregate's output and each
# join key of a mesh join's output lands on, recorded by wrapping the
# runner's methods (run alike in the reference's subprocess and here)
ROUTING = r"""
def record_routing(runner_cls, as_numpy, routes):
    def keys_to_shards(op, res, ks):
        cols = [as_numpy(res.columns[i]) for i in ks]
        names = [res.schema.fields[i].name for i in ks]
        valid = as_numpy(res.valid)
        cap = len(valid) // 8
        seen = routes.setdefault(op, {})
        for d in range(8):
            sl = slice(d * cap, (d + 1) * cap)
            vals = [c[sl][valid[sl]].tolist() for c in cols]
            for j, n in enumerate(names):
                dic = res.dictionaries.get(n)
                if dic is not None:
                    vals[j] = [dic.values[v] for v in vals[j]]
            for key in zip(*vals):
                seen.setdefault(repr(key), set()).add(d)

    agg, join = runner_cls.aggregate, runner_cls.join

    def aggregate(self, batch, key_idxs, *a, **k):
        res = agg(self, batch, key_idxs, *a, **k)
        keys_to_shards("aggregate", res, range(len(key_idxs)))
        return res

    def join_(self, left, right, left_keys, *a, **k):
        res = join(self, left, right, left_keys, *a, **k)
        keys_to_shards("join", res, left_keys)
        return res

    runner_cls.aggregate, runner_cls.join = aggregate, join_
    return lambda: (setattr(runner_cls, "aggregate", agg), setattr(runner_cls, "join", join))
"""

REF_SCRIPT = ROUTING + r"""
import json, pathlib, sys
import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc
import jax

from ballista_tpu.exec.context import TpuContext
from ballista_tpu.parallel.stage import MeshStageRunner

assert len(jax.devices()) == 8, jax.devices()
out = pathlib.Path(sys.argv[1])
cases = json.loads(pathlib.Path(sys.argv[2]).read_text())
displays, routing = {}, {}
for name, code, queries, _ in cases:
    routes = {}
    undo = record_routing(MeshStageRunner, np.asarray, routes)
    ns = {"np": np, "pa": pa, "rng": np.random.default_rng(11)}
    exec(code, ns)
    ctx = TpuContext()
    assert ctx.mesh_runtime() is not None, "mesh tier should be active"
    for tname, t in ns["tables"].items():
        ctx.register_table(tname, t)
    for i, q in enumerate(queries):
        displays[f"{name}-{i}"] = ctx.create_physical_plan(ctx.sql_to_logical(q)).display()
        tab = ctx.sql(q).collect()
        with paipc.new_file(str(out / f"{name}-{i}.arrow"), tab.schema) as w:
            w.write_table(tab)
    undo()
    routing[name] = {op: {k: sorted(v) for k, v in m.items()} for op, m in routes.items()}
(out / "displays.json").write_text(json.dumps(displays))
(out / "routing.json").write_text(json.dumps(routing))
print("REF-MESH-SQL-OK")
"""


def _tables(code: str) -> dict:
    ns = {"np": np, "pa": pa, "rng": np.random.default_rng(11)}
    exec(code, ns)
    return ns["tables"]



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several test files at once."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

@pytest.fixture(scope="module")
def ref_mesh(tmp_path_factory):
    """The reference's displays and mesh results of every case, from one
    8-device subprocess."""
    out = tmp_path_factory.mktemp("ref_mesh_sql")
    (out / "cases.json").write_text(json.dumps(CASES))
    run_reference(REF_SCRIPT, str(out), str(out / "cases.json"))
    displays = json.loads((out / "displays.json").read_text())
    results = {
        key: paipc.open_file(str(out / f"{key}.arrow")).read_all() for key in displays
    }
    return displays, results, json.loads((out / "routing.json").read_text())


@pytest.fixture
def mesh_env(monkeypatch):
    monkeypatch.setenv("BALLISTA_TPU_MESH_SHARDS", "8")


def _port_ctx(tables: dict):
    from ballista_tpu_torch.exec.context import TorchContext

    ctx = TorchContext(device="cpu")
    assert ctx.mesh_runtime() is not None and ctx.mesh_runtime().mesh.n_dev == 8
    for name, t in tables.items():
        ctx.register_table(name, t)
    return ctx


def _ref_collect(tables: dict, q: str) -> pa.Table:
    from ballista_tpu.exec.context import TpuContext

    ctx = TpuContext()
    for name, t in tables.items():
        ctx.register_table(name, t)
    return ctx.sql(q).collect()


def _assert_same(got: pd.DataFrame, want: pd.DataFrame) -> None:
    """Equal columns: floats to rtol 1e-9, everything else exact."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want), (len(got), len(want))
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(float), w.astype(float), rtol=1e-9, err_msg=c)
        else:
            assert g.tolist() == w.tolist(), c


def _check(kind: str, i: int, got: pa.Table, want: pa.Table) -> None:
    g, w = got.to_pandas(), want.to_pandas()
    if kind == "topk" and i == 1:
        # ties of v leave k open: the reference's test compares v
        np.testing.assert_allclose(g.v.values, w.v.values, rtol=1e-12)
        return
    if kind == "rank":
        # rank is deterministic; row_number's order within peer ties is not
        key = ["g", "v", "k", "rn"]
        g = g.sort_values(key).reset_index(drop=True)
        w = w.sort_values(key).reset_index(drop=True)
        _assert_same(g[["k", "g", "v", "rk"]], w[["k", "g", "v", "rk"]])
        assert sorted(g.rn) == sorted(w.rn)
        return
    if kind == "cumsum":
        # the running sum at each peer group's END row is deterministic
        m = g.groupby(["g", "v"])["cs"].max().reset_index()
        me = w.groupby(["g", "v"])["cs"].max().reset_index()
        _assert_same(m, me)
        return
    if kind == "rn_order":
        g, w = g.sort_values("rn"), w.sort_values("rn")
        assert g.rn.tolist() == w.rn.tolist()
        _assert_same(g[["v"]].reset_index(drop=True), w[["v"]].reset_index(drop=True))
        return
    _assert_same(g, w)


@pytest.mark.parametrize("case", CASE_IDS)
def test_mesh_sql_case(case, ref_mesh, mesh_env):
    """The port plans the reference's mesh operators with an equal
    ``display()``, its result equals the reference's mesh result and its
    collect result, and every group key of its mesh aggregates and join
    key of its mesh joins lands on the shard the reference's lands on."""
    from ballista_tpu_torch.parallel.stage import MeshStageRunner

    displays, results, routing = ref_mesh
    _, code, queries, kind = CASES[CASE_IDS.index(case)]
    tables = _tables(code)
    ctx = _port_ctx(tables)
    ns: dict = {}
    exec(ROUTING, ns)
    routes: dict = {}
    undo = ns["record_routing"](MeshStageRunner, lambda t: t.numpy(), routes)
    try:
        _check_case(case, ctx, queries, kind, tables, displays, results)
    finally:
        undo()
    got = {op: {k: sorted(v) for k, v in m.items()} for op, m in routes.items()}
    assert got == routing[case]
    assert all(len(v) == 1 for m in got.values() for v in m.values())


def _check_case(case, ctx, queries, kind, tables, displays, results) -> None:
    for i, q in enumerate(queries):
        disp = ctx.create_physical_plan(ctx.sql_to_logical(q)).display()
        assert disp == displays[f"{case}-{i}"], f"{disp}\n--- reference ---\n{displays[case + f'-{i}']}"
        for op in WANT_OPS[case]:
            assert op in disp, disp
        if case == "window_fallback":
            assert "MeshWindowExec" not in disp and "WindowExec" in disp, disp
        if kind in ("topk", "frame") and "ORDER BY" in q:
            assert "CoalescePartitionsExec" not in disp, disp
        got = ctx.sql(q).collect()
        _check(kind, i, got, results[f"{case}-{i}"])
        _check(kind, i, got, _ref_collect(tables, q))


def test_two_threads_share_one_mesh_context(mesh_env):
    """Two mesh queries from two threads at once on one context (the
    runner holds no lock: its exchange has no rendezvous) give the results
    each gives alone."""
    tables = {**_tables(CASES[1][1]), **{"t": _tables(CASES[6][1])["t"]}}
    ctx = _port_ctx(tables)
    qs = [CASES[1][2][0], CASES[6][2][0], "SELECT g, COUNT(*) AS c FROM t GROUP BY g ORDER BY g"]
    alone = [ctx.sql(q).collect() for q in qs]
    got: dict = {}
    errors: list = []

    def run(j: int) -> None:
        try:
            for r in range(2):
                got[(j, r)] = ctx.sql(qs[j % len(qs)]).collect()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(j,)) for j in range(2 * len(qs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    assert len(got) == 2 * len(qs) * 2
    for (j, _r), tab in got.items():
        _check("frame", 0, tab, alone[j % len(qs)])


def test_mesh_money_sums_agree_with_the_exact_sums(ref_mesh, mesh_env, monkeypatch):
    """ROADMAP queue 3, a logged divergence: the mesh aggregate sums a
    money column as floats (per-shard partials merged in bucket order), in
    the reference too (its mesh operator calls the runner, outside the
    decimal-scaled sums), where collect mode sums it exactly. The mesh
    sums agree with collect mode's exact sums and with the reference's
    mesh to rtol 1e-9; two mesh runs are bit-identical."""
    from ballista_tpu_torch.exec.context import TorchContext

    _, code, (q,), _ = CASES[CASE_IDS.index("money_sums")]
    tables = _tables(code)
    ctx = _port_ctx(tables)
    mesh_runs = [ctx.sql(q).collect() for _ in range(2)]
    assert mesh_runs[0].equals(mesh_runs[1])
    monkeypatch.delenv("BALLISTA_TPU_MESH_SHARDS")
    local = TorchContext(device="cpu")
    local.register_table("t", tables["t"])
    exact = local.sql(q).collect()
    assert "Mesh" not in local.create_physical_plan(local.sql_to_logical(q)).display()
    _check("frame", 0, mesh_runs[0], exact)
    _check("frame", 0, mesh_runs[0], ref_mesh[1]["money_sums-0"])
