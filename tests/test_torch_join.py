"""The port's join kernels and HashJoinExec against the reference's on the
same numpy input: ``build_side``, ``probe_side``, ``probe_counts`` and
``expand_join`` in each pack mode (exact, exact2, hash), with duplicate,
null and contiguous keys and with the direct-address table; then INNER,
LEFT, RIGHT, SEMI and ANTI joins through SQL against ``TpuContext``.
Everything exact: joins move rows, they do not add."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu.columnar.batch import DeviceBatch as RefBatch
from ballista_tpu.columnar.batch import round_capacity
from ballista_tpu.datatypes import DataType as RefType, Field as RefField, Schema as RefSchema
from ballista_tpu.exec.context import TpuContext
from ballista_tpu.ops import join as ref_join
from ballista_tpu_torch.columnar.batch import DeviceBatch as PortBatch
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.ops import join as port_join

I32_MAX = np.iinfo(np.int32).max


def both_batches(names, types, arrays, nulls, valid, cap):
    """The same padded batch in both packages (``valid`` over the full
    capacity)."""
    ref = RefBatch.from_host(
        RefSchema([RefField(n, RefType(t)) for n, t in zip(names, types)]),
        arrays, nulls=nulls, capacity=cap,
    ).with_valid(jnp.asarray(valid))
    port = PortBatch.from_host(
        Schema([Field(n, DataType(t)) for n, t in zip(names, types)]),
        arrays, nulls=nulls, capacity=cap, device="cpu",
    ).with_valid(torch.from_numpy(valid))
    return ref, port


def key_columns(mode: str, n: int, rng, unique: bool, contiguous: bool = False):
    """(names, types, arrays) of the key columns of one side."""
    if mode == "exact":
        if contiguous:
            k = rng.permutation(np.arange(1, n + 1)).astype(np.int64)
        elif unique:
            k = rng.choice(np.arange(-5 * n, 5 * n), n, replace=False).astype(np.int64)
        else:
            k = rng.integers(0, n // 3, n).astype(np.int64)
        return ["k"], ["int64"], [k]
    if mode == "exact2":
        if contiguous:
            a = rng.permutation(np.arange(1, n + 1)).astype(np.int64)
        elif unique:
            a = rng.choice(np.arange(0, 5 * n), n, replace=False).astype(np.int64)
        else:
            a = rng.integers(0, n // 3, n).astype(np.int64)
        b = rng.integers(0, 25, n).astype(np.int32)
        return ["k", "k2"], ["int64", "int32"], [a, b]
    # hash: a float key and a signed int. No -0.0 here: the reference's
    # jitted hash folds ``x + 0.0`` away, so its -0.0 hashes apart from
    # +0.0 (ROADMAP queue 3); test_negative_zero_keys_match covers the port
    vals = np.array([0.0, 1.5, -2.25, 3.0, 7.5, 1e10])
    if unique:
        f = (rng.permutation(n) * 0.5 + 0.25).astype(np.float64)
        i = rng.integers(-3, 3, n).astype(np.int64)
    else:
        f = rng.choice(vals, n)
        i = rng.integers(-2, 2, n).astype(np.int64)
    return ["k", "k2"], ["float64", "int64"], [f, i]


def side(mode, n, cap, seed, unique, contiguous=False, null_frac=0.1, live_frac=0.9):
    rng = np.random.default_rng(seed)
    names, types, arrays = key_columns(mode, n, rng, unique, contiguous)
    names = names + ["v", "w"]
    types = types + ["int64", "float64"]
    arrays = arrays + [np.arange(n, dtype=np.int64) * 10 + seed, rng.normal(size=n)]
    nulls = [rng.random(n) < null_frac if i == 0 and null_frac else None for i in range(len(names))]
    nulls[-1] = rng.random(n) < 0.2
    valid = np.zeros(cap, dtype=bool)
    valid[:n] = rng.random(n) < live_frac
    return both_batches(names, types, arrays, nulls, valid, cap), len(names) - 2


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_batches_equal(got, want):
    gv, wv = np_of(got.valid), np_of(want.valid)
    assert np.array_equal(gv, wv)
    assert [f.name for f in got.schema] == [f.name for f in want.schema]
    for g, w in zip(got.columns, want.columns):
        g, w = np_of(g)[gv], np_of(w)[wv]
        assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f")
    for g, w in zip(got.nulls, want.nulls):
        assert (g is None) == (w is None)
        if g is not None:
            assert np.array_equal(np_of(g)[gv], np_of(w)[wv])


def builds(mode, n, cap, seed, unique, contiguous=False, null_frac=0.1):
    # a contiguous build has every key live
    live_frac = 1.0 if contiguous else 0.9
    (rb, pb), nk = side(mode, n, cap, seed, unique, contiguous, null_frac, live_frac)
    keys = list(range(nk))
    return ref_join.build_side(rb, keys), port_join.build_side(pb, keys), keys


@pytest.mark.parametrize("mode", ["exact", "exact2", "hash"])
@pytest.mark.parametrize(
    "shape", ["unique", "dups", "contiguous", "no_nulls"]
)
def test_build_side_matches_reference(mode, shape):
    contiguous = shape == "contiguous"
    want, got, _ = builds(
        mode, 1500, 2048, 3, unique=shape != "dups", contiguous=contiguous,
        null_frac=0.0 if shape in ("contiguous", "no_nulls") else 0.1,
    )
    assert got.mode == want.mode == mode
    for f in ("n", "has_dups", "run_overflow", "lo", "contiguous", "hi"):
        assert int(np_of(getattr(got, f))) == int(np_of(getattr(want, f))), f
    assert np.array_equal(np_of(got.keys), np_of(want.keys))
    assert_batches_equal(got.batch, want.batch)
    assert got.flags() == tuple(
        int(np_of(getattr(want, f))) if f in ("lo", "hi") else bool(np_of(getattr(want, f)))
        for f in ("has_dups", "run_overflow", "contiguous", "lo", "hi")
    )
    if contiguous and mode != "hash":
        assert got.flags()[2]


@pytest.mark.parametrize("kind", ["INNER", "LEFT", "SEMI", "ANTI"])
@pytest.mark.parametrize(
    "mode,path",
    [("exact", "search"), ("exact", "contiguous"), ("exact", "lut"),
     ("exact2", "search"), ("exact2", "contiguous"), ("hash", "search")],
)
def test_probe_side_matches_reference(mode, path, kind):
    contiguous = path == "contiguous"
    want_bt, got_bt, keys = builds(
        mode, 900, 1024, 5, unique=True, contiguous=contiguous,
        null_frac=0.0 if contiguous else 0.1,
    )
    if path == "lut":
        lo, hi = got_bt.flags()[3:5]
        size = round_capacity(hi - lo + 1)
        ref_join.attach_lut(want_bt, size)
        port_join.attach_lut(got_bt, size)
        assert not bool(port_join.lut_stale(got_bt, size))
        assert np.array_equal(np_of(got_bt.lut2), np_of(want_bt.lut2))
    (rp, pp), _ = side(mode, 1800, 2048, 6, unique=False)
    # half of the probe keys are taken from the build side, so most match
    rng = np.random.default_rng(7)
    take = rng.random(2048) < 0.5
    src = rng.integers(0, 900, 2048)
    rcols = list(rp.columns)
    pcols = list(pp.columns)
    for i in keys:
        bcol = np.asarray(want_bt.batch.columns[i])
        mixed = np.where(take, bcol[src], np.asarray(rp.columns[i]))
        rcols[i] = jnp.asarray(mixed)
        pcols[i] = torch.from_numpy(mixed.copy())
    rp = RefBatch(rp.schema, tuple(rcols), rp.valid, rp.nulls, rp.dictionaries)
    pp = PortBatch(pp.schema, tuple(pcols), pp.valid, pp.nulls, pp.dictionaries)
    want = ref_join.probe_side(want_bt, rp, keys, ref_join.JoinSide[kind], contiguous=contiguous)
    got = port_join.probe_side(got_bt, pp, keys, port_join.JoinSide[kind], contiguous=contiguous)
    assert_batches_equal(got, want)
    assert np_of(got.valid).sum() > 0


@pytest.mark.parametrize("kind", ["INNER", "LEFT"])
@pytest.mark.parametrize("mode,lut", [("exact", False), ("exact", True), ("exact2", False), ("hash", False)])
def test_probe_counts_and_expand_join_match_reference(mode, lut, kind):
    want_bt, got_bt, keys = builds(mode, 600, 1024, 11, unique=False)
    if lut:
        lo, hi = got_bt.flags()[3:5]
        size = round_capacity(hi - lo + 1)
        ref_join.attach_lut(want_bt, size)
        port_join.attach_lut(got_bt, size)
    (rp, pp), _ = side(mode, 700, 1024, 12, unique=False)
    wf, wc, wl = ref_join.probe_counts(want_bt, rp, keys)
    gf, gc, gl = port_join.probe_counts(got_bt, pp, keys)
    assert np.array_equal(np_of(gl), np_of(wl))
    assert np.array_equal(np_of(gc), np_of(wc))
    matched = np_of(wc) > 0
    assert np.array_equal(np_of(gf)[matched], np_of(wf)[matched])
    if kind == "LEFT":
        w_eff = jnp.where(rp.valid, jnp.maximum(wc, 1), 0)
        g_eff = torch.where(pp.valid, gc.clamp(min=1), 0)
    else:
        w_eff, g_eff = wc, gc
    total = int(np_of(g_eff).sum())
    assert total == int(np_of(w_eff).sum()) and total > 0
    out_cap = round_capacity(total)
    wb, wi, wk, wr = ref_join.expand_join(want_bt, rp, wf, wc, w_eff, out_cap, ref_join.JoinSide[kind])
    gb, gi, gk, gr = port_join.expand_join(got_bt, pp, gf, gc, g_eff, out_cap, port_join.JoinSide[kind])
    assert_batches_equal(gb, wb)
    live = np_of(wb.valid)
    for g, w in ((gi, wi), (gk, wk), (gr, wr)):
        assert np.array_equal(np_of(g)[live], np_of(w)[live])


def test_negative_zero_keys_match():
    # SQL: -0.0 = +0.0, so a hash-packed probe of -0.0 finds a +0.0 build key
    (_, pb), _ = side("hash", 64, 2048, 21, unique=True, null_frac=0.0, live_frac=1.0)
    pb.columns[0][:4] = torch.tensor([0.0, 1.5, 2.5, 3.5], dtype=torch.float64)
    pb.columns[1][:4] = 0
    bt = port_join.build_side(pb, [0, 1])
    assert bt.mode == "hash"
    probe = PortBatch.from_host(
        Schema([Field("k", DataType("float64")), Field("k2", DataType("int64"))]),
        [np.array([-0.0, 1.5]), np.array([0, 0])], device="cpu",
    )
    out = port_join.probe_side(bt, probe, [0, 1], port_join.JoinSide.SEMI)
    assert out.valid[:2].tolist() == [True, True]


# -- HashJoinExec through SQL ------------------------------------------------


def tables(seed: int = 0):
    rng = np.random.default_rng(seed)
    na, nb = 900, 700
    a_k = rng.integers(0, 400, na).astype(np.int64)
    b_k = rng.integers(0, 400, nb).astype(np.int64)
    a = pa.table({
        "a_k": pa.array(a_k, mask=rng.random(na) < 0.05),
        "a_u": pa.array(rng.permutation(na).astype(np.int64)),
        "a_k2": pa.array(rng.integers(0, 6, na).astype(np.int32)),
        "a_s": pa.array([f"s{i}" for i in rng.integers(0, 30, na)]),
        "a_v": pa.array(np.round(rng.normal(0, 100, na), 2)),
    })
    b = pa.table({
        "b_k": pa.array(b_k, mask=rng.random(nb) < 0.05),
        "b_u": pa.array(rng.permutation(nb).astype(np.int64)),
        "b_k2": pa.array(rng.integers(0, 6, nb).astype(np.int32)),
        "b_s": pa.array([f"s{i}" for i in rng.integers(10, 50, nb)]),
        "b_v": pa.array(np.round(rng.normal(0, 100, nb), 2)),
    })
    return a, b


JOIN_SQL = {
    # unique right side: build right, probe the left batches
    "inner_unique_right": "select a_k, a_v, b_u, b_v from a join b on a_u = b_u",
    # duplicate right keys, unique left: flip, stream the right side
    "inner_flip": "select a_u, a_v, b_k, b_v from a join b on a_u = b_k",
    # duplicates on both sides: the m:n expansion
    "inner_many_to_many": "select a_k, a_v, b_k, b_v from a join b on a_k = b_k",
    # two int keys (exact2 packing)
    "inner_two_keys": "select a_k, a_k2, b_v from a join b on a_k = b_k and a_k2 = b_k2",
    # string keys: dictionaries unified across sides
    "inner_string_keys": "select a_s, a_v, b_v from a join b on a_s = b_s",
    "left": "select a_k, a_v, b_v from a left join b on a_u = b_u",
    "left_many": "select a_k, a_v, b_k, b_v from a left join b on a_k = b_k",
    "right": "select a_k, b_k, b_v from a right join b on a_u = b_u",
    "semi": "select a_k, a_v from a where a_k in (select b_k from b)",
    "semi_exists": "select a_u, a_s from a where exists (select * from b where b_s = a_s)",
    "anti": "select a_k, a_v from a where not exists (select * from b where b_k = a_k)",
    "join_then_group": (
        "select a_k2, count(*) as c, sum(b_v) as s from a join b on a_k = b_k "
        "group by a_k2 order by a_k2"
    ),
    "distinct": "select distinct a_k2, a_s from a order by a_k2, a_s",
    # residual filters, on the probe path (unique build) and on the
    # expansion path (duplicated build; SEMI and ANTI with a filter are not
    # deduplicated)
    "inner_filter_probe": "select a_k, a_v, b_u, b_v from a join b on a_u = b_u and a_v < b_v",
    "inner_filter_flip": "select a_u, a_v, b_k, b_v from a join b on a_u = b_k and a_v < b_v",
    "inner_filter_expand": (
        "select a_k, a_v, b_k, b_v from a join b on a_k = b_k and a_v > b_v"
    ),
    "left_filter_probe": "select a_k, a_v, b_v from a left join b on a_u = b_u and b_v > 0",
    "left_filter_expand": (
        "select a_k, a_v, b_k, b_v from a left join b on a_k = b_k and a_v < b_v"
    ),
    "semi_filter_probe": (
        "select a_u, a_v from a where exists "
        "(select * from b where b_u = a_u and b_v > a_v)"
    ),
    "semi_filter_expand": (
        "select a_k, a_v from a where exists "
        "(select * from b where b_k = a_k and b_v > a_v)"
    ),
    "anti_filter_probe": (
        "select a_u, a_v from a where not exists "
        "(select * from b where b_u = a_u and b_v < a_v)"
    ),
    "anti_filter_expand": (
        "select a_k, a_v from a where not exists "
        "(select * from b where b_k = a_k and b_v > a_v)"
    ),
    # a scalar subquery: a cross join with its one-row result
    "cross_one_row": "select a_k, a_v from a where a_v > (select avg(b_v) from b)",
    # positional union: b's columns take a's names, dictionaries follow
    "union_all": "select a_k, a_s from a union all select b_k, b_s from b",
    # FULL: LEFT union the padded ANTI, with and without a residual filter
    "full": "select a_u, a_v, b_u, b_v from a full join b on a_u = b_u",
    "full_filter": (
        "select a_k, a_v, b_k, b_v from a full outer join b on a_k = b_k and a_v < b_v"
    ),
    "literals_only": "select 1 + 2 as x",
}


@pytest.mark.parametrize("case", list(JOIN_SQL))
def test_hash_join_exec_matches_reference(case):
    a, b = tables()
    ref = TpuContext()
    port = TorchContext(BallistaConfig({"ballista.tpu.batch_rows": "256"}), device="cpu")
    for ctx in (ref, port):
        ctx.register_table("a", a)
        ctx.register_table("b", b)
    sql = JOIN_SQL[case]
    assert (
        port.create_physical_plan(port.sql_to_logical(sql)).display()
        == ref.create_physical_plan(ref.sql_to_logical(sql)).display()
    )
    want = ref.sql(sql).collect()
    for _ in range(2):  # cold, then warm on the learned build strategies
        got = port.sql(sql).collect()
        assert got.schema.equals(want.schema)
        assert got.num_rows == want.num_rows > 0
        assert_tables_match(got, want)


def assert_tables_match(got: pa.Table, want: pa.Table) -> None:
    """Row for row: floats within rtol 1e-9 (sums), everything else exact."""
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        if pa.types.is_floating(w.type):
            assert g.null_count == w.null_count and np.array_equal(
                g.is_null().to_numpy(zero_copy_only=False),
                w.is_null().to_numpy(zero_copy_only=False),
            )
            np.testing.assert_allclose(
                g.fill_null(0.0).to_numpy(), w.fill_null(0.0).to_numpy(), rtol=1e-9,
                err_msg=name,
            )
        else:
            assert g.to_pylist() == w.to_pylist(), name


def test_join_expansion_overflow_retries():
    # four output rows per probe row are not enough for this m:n join: the
    # run fails its deferred check, and the retry gives the full result
    ref = TpuContext()
    port = TorchContext(device="cpu")
    for ctx in (ref, port):
        ctx.register_table("a", pa.table({"a_k": pa.array(np.array([7, 3, 7] * 10, dtype=np.int64))}))
        ctx.register_table("b", pa.table({"b_k": pa.array(np.full(5000, 7, dtype=np.int64))}))
    sql = "select a_k, b_k from a join b on a_k = b_k"
    want = ref.sql(sql).collect()
    df = port.sql(sql)
    got = df.collect()
    assert got.num_rows == want.num_rows > 4 * 2048
    assert df.stats.get("capacity_retries", 0) >= 1
    assert got.to_pylist() == want.to_pylist()


def test_join_expansion_capacity_is_its_own(monkeypatch):
    # the m:n expansion sizes its output from join_expansion and its own
    # retries only: a context whose aggregates grew their capacity does
    # not resize it, and its overflow does not grow the aggregates'
    from ballista_tpu_torch.exec import joins as port_joins

    caps = []
    real = port_joins.expand_join

    def spy(bt, probe, first, count, eff, out_cap, kind):
        caps.append(out_cap)
        return real(bt, probe, first, count, eff, out_cap, kind)

    monkeypatch.setattr(port_joins, "expand_join", spy)
    a, b = tables()
    port = TorchContext(BallistaConfig({"ballista.tpu.batch_rows": "256"}), device="cpu")
    port.register_table("a", a)
    port.register_table("b", b)
    port._capacity_hint["agg_capacity"] = 1 << 22
    got = port.sql(JOIN_SQL["inner_many_to_many"]).collect()
    assert got.num_rows > 0 and caps
    assert max(caps) < 1 << 22
    assert "site_capacity" not in port._capacity_hint

    caps.clear()
    port = TorchContext(device="cpu")
    port.register_table("a", pa.table({"a_k": pa.array(np.array([7, 3, 7] * 10, dtype=np.int64))}))
    port.register_table("b", pa.table({"b_k": pa.array(np.full(5000, 7, dtype=np.int64))}))
    df = port.sql("select a_k, b_k from a join b on a_k = b_k")
    assert df.collect().num_rows == 20 * 5000
    assert df.stats == {"capacity_retries": 1}
    assert caps[-1] == round_capacity(20 * 5000)
    assert "agg_capacity" not in port._capacity_hint
    assert list(port._capacity_hint["site_capacity"].values()) == [caps[-1]]


def test_cross_join_needs_a_one_row_side():
    from ballista_tpu.errors import ExecutionError as RefExecutionError
    from ballista_tpu_torch.errors import ExecutionError

    a, b = tables()
    ref, port = TpuContext(), TorchContext(device="cpu")
    for ctx in (ref, port):
        ctx.register_table("a", a)
        ctx.register_table("b", b)
    sql = "select a_k, b_k from a cross join b"
    with pytest.raises(RefExecutionError):
        ref.sql(sql).collect()
    with pytest.raises(ExecutionError, match="1-row broadcast side"):
        port.sql(sql).collect()


def test_cross_join_columns_are_contiguous():
    # the broadcast row must not reach the kernels as a stride-0 view
    from ballista_tpu_torch.exec.joins import CrossJoinExec
    from ballista_tpu_torch.exec.base import TaskContext

    a, b = tables()
    port = TorchContext(device="cpu")
    port.register_table("a", a)
    port.register_table("b", b)
    plan = port.create_physical_plan(
        port.sql_to_logical("select a_k from a where a_v > (select avg(b_v) from b)")
    )
    cross = plan
    while not isinstance(cross, CrossJoinExec):
        cross = cross.children()[0]
    ctx = TaskContext(device="cpu")
    out = next(iter(cross.execute(0, ctx)))
    assert all(c.is_contiguous() and c.stride() == (1,) for c in out.columns)
