"""The port's mesh tier (``ballista_tpu_torch/parallel``) on the CPU: the
cases of ``tests/test_parallel.py`` and more, on a mesh of 8 shards.

The reference's cases: every row is routed once by the exchange, the
repartitioned aggregate, the partitioned join (INNER, SEMI, ANTI, LEFT)
and the dry run (in process, on ``device="cpu"``). Added: the fused
exchange against the reference's ``bucket_rows`` on each shard followed
by the all-to-all, the overflow flags, the mesh's device spellings, each join pack mode with m:n expansion, the residual
filter and the capacity retries, the top-k, the sample sort under skew
with its retry and its ``CapacityError`` past ``MAX_MESH_RETRIES``, the
window, the layout checks, and the scheduler's fused mesh stage.

Routing is parity: one subprocess with the reference's 8-device virtual
CPU mesh runs its exchange, aggregates and join on the same data (made by
the same code from the same seed) and writes the keys each device holds;
every shard of the port must hold the same keys.
"""

from __future__ import annotations

import json

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from ballista_tpu_torch.columnar.arrow_interop import batch_from_arrow, batch_to_arrow
from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.errors import CapacityError, ExecutionError
from ballista_tpu_torch.ops.aggregate import AggOp
from ballista_tpu_torch.ops.hashing import hash_columns
from ballista_tpu_torch.ops.join import JoinSide, _choose_pack_mode
from ballista_tpu_torch.ops.sort import SortKey
from ballista_tpu_torch.parallel import (
    MeshStageRunner,
    is_row_sharded,
    make_mesh,
    shard_batch,
    unshard_batch,
)
from ballista_tpu_torch.parallel import stage
from ballista_tpu_torch.parallel.collective import exchange_by_key, exchange_by_pid
from ballista_tpu_torch.parallel.mesh import SHARD_AXIS, check_layout
from tests.torch_mesh_ref import run_reference

N = 8

# the inputs of the routing cases, as code over ``rng`` (default_rng(13),
# the seed of tests/test_parallel.py), run alike by the reference's
# subprocess and by the port
DATA = {
    "exchange": """
n = 4000
t = pa.table({"k": pa.array(rng.integers(0, 101, n)),
              "v": pa.array(np.arange(n, dtype=np.int64))})
""",
    "aggregate": """
n = 6000
t = pa.table({"k": pa.array(rng.integers(0, 53, n)),
              "v": pa.array(rng.uniform(0, 10, n)),
              "w": pa.array(rng.integers(1, 5, n))})
""",
    "aggregate_str": """
n = 5000
cats = [f"cat{i}" for i in range(37)]
t = pa.table({"c": pa.array([cats[i] for i in rng.integers(0, 37, n)]),
              "v": pa.array(rng.uniform(0, 5, n))})
""",
    "join": """
n, nd = 4000, 29
fact = pa.table({"k": pa.array(rng.integers(0, nd + 10, n)),
                 "v": pa.array(rng.uniform(0, 1, n))})
dim = pa.table({"k2": pa.array(np.arange(nd, dtype=np.int64)),
                "name": pa.array([f"g{i}" for i in range(nd)])})
""",
    "join2": """
n = 3000
fact = pa.table({"a": pa.array(rng.integers(0, 12, n)),
                 "b": pa.array(rng.integers(0, 9, n)),
                 "v": pa.array(rng.uniform(0, 1, n))})
dim = pa.table({"a2": pa.array(np.repeat(np.arange(10), 8)),
                "b2": pa.array(np.tile(np.arange(8), 10)),
                "w": pa.array(np.arange(80, dtype=np.int64))})
""",
}

REF_SCRIPT = r"""
import json, pathlib, sys
import numpy as np
import pyarrow as pa
import jax
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from ballista_tpu.columnar.arrow_interop import batch_from_arrow
from ballista_tpu.ops.aggregate import AggOp
from ballista_tpu.ops.join import JoinSide
from ballista_tpu.parallel import MeshStageRunner, make_mesh, shard_batch
from ballista_tpu.parallel.collective import exchange_by_key
from ballista_tpu.parallel.mesh import SHARD_AXIS

assert len(jax.devices()) == 8, jax.devices()
mesh = make_mesh(8)
runner = MeshStageRunner(mesh)
data = json.loads(pathlib.Path(sys.argv[2]).read_text())


def tables(name):
    ns = {"np": np, "pa": pa, "rng": np.random.default_rng(13)}
    exec(data[name], ns)
    return ns


def per_device(cols, valid, decode=None):
    cols = [np.asarray(c) for c in cols]
    v = np.asarray(valid)
    cap = len(v) // 8
    out = []
    for d in range(8):
        sl = slice(d * cap, (d + 1) * cap)
        rows = zip(*[c[sl][v[sl]].tolist() for c in cols])
        out.append(sorted({tuple(decode(x) if decode else x for x in r) for r in rows}))
    return out


got = {}
sb = shard_batch(mesh, batch_from_arrow(tables("exchange")["t"]))
cap_local = sb.capacity // 8


def f(cols, valid):
    c, _, v, ovf = exchange_by_key(cols, (None, None), valid, (0,), SHARD_AXIS, 8, cap_local)
    return c, v, ovf.reshape(1)


sm = jax.jit(shard_map(
    f, mesh=mesh,
    in_specs=((P(SHARD_AXIS), P(SHARD_AXIS)), P(SHARD_AXIS)),
    out_specs=((P(SHARD_AXIS), P(SHARD_AXIS)), P(SHARD_AXIS), P(SHARD_AXIS)),
    check_rep=False,
))
(k2, v2), valid2, ovf = sm(sb.columns, sb.valid)
got["exchange"] = per_device([k2], valid2)

sb = shard_batch(mesh, batch_from_arrow(tables("aggregate")["t"]))
res = runner.aggregate(sb, [0], [1, 2, 1], [AggOp.SUM, AggOp.MAX, AggOp.COUNT], capacity=128)
got["aggregate"] = per_device([res.columns[0]], res.valid)

sb = shard_batch(mesh, batch_from_arrow(tables("aggregate_str")["t"]))
res = runner.aggregate(sb, [0], [1], [AggOp.SUM], capacity=128)
d = res.dictionaries[res.schema.fields[0].name].values
got["aggregate_str"] = per_device([res.columns[0]], res.valid, decode=lambda c: d[c])

ns = tables("join")
out = runner.join(shard_batch(mesh, batch_from_arrow(ns["fact"])),
                  shard_batch(mesh, batch_from_arrow(ns["dim"])), [0], [0], JoinSide.INNER)
got["join"] = per_device([out.columns[0]], out.valid)

ns = tables("join2")
out = runner.join(shard_batch(mesh, batch_from_arrow(ns["fact"])),
                  shard_batch(mesh, batch_from_arrow(ns["dim"])), [0, 1], [0, 1], JoinSide.INNER)
got["join2"] = per_device([out.columns[0], out.columns[1]], out.valid)
pathlib.Path(sys.argv[1]).write_text(json.dumps(got))
print("REF-PARALLEL-OK")
"""


def _data(name: str) -> dict:
    ns = {"np": np, "pa": pa, "rng": np.random.default_rng(13)}
    exec(DATA[name], ns)
    return ns


def _per_shard(cols, valid, decode=None) -> list:
    cols = [c.numpy() for c in cols]
    v = valid.numpy()
    cap = len(v) // N
    out = []
    for d in range(N):
        sl = slice(d * cap, (d + 1) * cap)
        rows = zip(*[c[sl][v[sl]].tolist() for c in cols])
        out.append(sorted({tuple(decode(x) if decode else x for x in r) for r in rows}))
    return out


def _as_lists(shards: list) -> list:
    return [[list(r) for r in s] for s in shards]



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several test files at once."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

@pytest.fixture(scope="module")
def ref_routing(tmp_path_factory):
    """The keys each device of the reference's 8-device mesh holds after
    its exchange, aggregates and joins, from one subprocess."""
    out = tmp_path_factory.mktemp("ref_parallel")
    (out / "data.json").write_text(json.dumps(DATA))
    run_reference(REF_SCRIPT, str(out / "got.json"), str(out / "data.json"))
    return json.loads((out / "got.json").read_text())


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N, device="cpu")


@pytest.fixture(scope="module")
def runner(mesh):
    return MeshStageRunner(mesh)


def _sharded(mesh, table: pa.Table, **kw) -> DeviceBatch:
    return shard_batch(mesh, batch_from_arrow(table, device="cpu"), **kw)


def _frame(batch: DeviceBatch) -> pd.DataFrame:
    return batch_to_arrow(unshard_batch(batch)).to_pandas()


# -- the mesh and the layout ---------------------------------------------------


def test_make_mesh_shards_on_one_device(monkeypatch):
    monkeypatch.delenv("BALLISTA_TPU_MESH_SHARDS", raising=False)
    assert make_mesh(device="cpu").n_dev == 1
    monkeypatch.setenv("BALLISTA_TPU_MESH_SHARDS", "4")
    m = make_mesh(device="cpu")
    assert m.n_dev == 4 and m.devices == (torch.device("cpu"),) * 4
    assert make_mesh(8, device=["cpu"] * 8).n_dev == 8
    monkeypatch.setenv("BALLISTA_TPU_MESH_SHARDS", "two")
    with pytest.raises(ValueError, match="BALLISTA_TPU_MESH_SHARDS"):
        make_mesh(device="cpu")


@pytest.mark.parametrize(
    "current, spellings, card",
    [
        (0, ["cuda:0", "cuda"], 0),
        (1, ["cuda:1", "cuda"], 1),
        (1, ["cuda:0", "cuda"], None),
        (0, ["cuda:0", "cuda:1"], None),
    ],
)
def test_make_mesh_compares_cards_by_index(monkeypatch, current, spellings, card):
    """A list of devices names one card only when every spelling resolves
    to the same index (a bare ``cuda`` is the current card); otherwise the
    mesh is refused. The card is faked: only names are compared."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    if card is None:
        with pytest.raises(ExecutionError, match="several cards"):
            make_mesh(device=spellings)
    else:
        m = make_mesh(device=spellings)
        assert m.n_dev == len(spellings) and m.device == torch.device("cuda", card)


def test_shard_batch_lays_live_rows_round_robin(mesh):
    """Live row i goes to shard i % N at position i // N (the reference's
    ``live[d::N]``); dead rows are dropped; the capacity rule is
    ``round_capacity(ceil(n / N))``."""
    n = 3001
    b = batch_from_arrow(pa.table({"x": np.arange(n, dtype=np.int64)}), device="cpu")
    b = b.with_valid(b.valid & (b.columns[0] % 3 != 0))
    live = np.arange(n)[np.arange(n) % 3 != 0]
    sb = shard_batch(mesh, b)
    assert sb.shards == N and sb.capacity == N * 2048 and is_row_sharded(sb, mesh)
    x, v = sb.columns[0].numpy(), sb.valid.numpy()
    for d in range(N):
        blk = slice(d * 2048, (d + 1) * 2048)
        want = live[d::N]
        assert x[blk][v[blk]].tolist() == want.tolist()
        assert v[blk].tolist() == [True] * len(want) + [False] * (2048 - len(want))
    assert not is_row_sharded(unshard_batch(sb), mesh)
    assert unshard_batch(sb).columns[0] is sb.columns[0]  # no data moves
    # the mark survives row-preserving rebuilds only
    assert sb.with_valid(sb.valid).shards == N
    assert sb.with_columns(sb.schema, sb.columns).shards == N
    assert sb.head(2048).shards is None


def test_layout_is_checked(mesh, runner):
    b = batch_from_arrow(pa.table({"k": np.arange(10, dtype=np.int64)}), device="cpu", capacity=2050)
    with pytest.raises(ExecutionError, match="block layout"):
        check_layout(b, N)
    for call in (
        lambda: runner.aggregate(b, [0], [0], [AggOp.COUNT], capacity=64),
        lambda: runner.sort_full(b, [SortKey(0)]),
        lambda: runner.topk(b, [SortKey(0)], 3),
        lambda: runner.join(b, b, [0], [0]),
    ):
        with pytest.raises(ExecutionError, match="block layout"):
            call()
    sb = _sharded(mesh, pa.table({"k": np.arange(10, dtype=np.int64)}))
    sb4 = DeviceBatch(sb.schema, sb.columns, sb.valid, sb.nulls, sb.dictionaries, shards=4)
    with pytest.raises(ExecutionError, match="shards=4"):
        check_layout(sb4, N)


# -- the exchange --------------------------------------------------------------


def test_exchange_routes_every_row_once(mesh, ref_routing):
    """Every row arrives exactly once, on the shard hash(k) % 8 names, and
    every shard holds the keys the reference's device holds."""
    t = _data("exchange")["t"]
    n = t.num_rows
    sb = _sharded(mesh, t)
    cap_local = sb.capacity // N
    (k2, v2), _, valid2, ovf = exchange_by_key(
        sb.columns, sb.nulls, sb.valid, (0,), SHARD_AXIS, N, cap_local
    )
    assert not ovf.any()
    assert sorted(v2[valid2].tolist()) == list(range(n))
    pid = (hash_columns([k2]).numpy().view(np.uint64) % np.uint64(N)).astype(int)
    dev = np.arange(len(valid2)) // (len(valid2) // N)
    assert np.all(pid[valid2.numpy()] == dev[valid2.numpy()])
    assert _as_lists(_per_shard([k2], valid2)) == ref_routing["exchange"]


def _nullable_input(mesh):
    rng = np.random.default_rng(5)
    n = 5000
    k = rng.integers(0, 41, n)
    t = pa.table({
        "k": pa.array(k, mask=rng.uniform(size=n) < 0.1),
        "v": pa.array(np.arange(n, dtype=np.int64)),
        "f": pa.array(rng.uniform(size=n), mask=rng.uniform(size=n) < 0.2),
    })
    sb = _sharded(mesh, t)
    return sb, sb.valid & (sb.columns[1] % 7 != 0)  # some dead rows too


def _reference_exchange(sb, valid, pid, bucket_cap):
    """The reference's exchange on the same shards: its ``bucket_rows``
    (``bucket_rows_by_pid`` when ``pid`` is given) on each shard's block,
    in process, then the all-to-all (block ``d`` gets bucket ``d`` of every
    shard, in shard order). Returns (cols, nulls, valid, overflow) as
    global torch tensors."""
    import jax.numpy as jnp

    from ballista_tpu.parallel import collective as ref

    cap = sb.capacity // N

    def block(t, s):
        return None if t is None else jnp.asarray(t[s * cap:(s + 1) * cap].numpy())

    shards = []
    for s in range(N):
        cols = tuple(block(c, s) for c in sb.columns)
        nulls = tuple(block(m, s) for m in sb.nulls)
        if pid is None:
            shards.append(ref.bucket_rows(cols, nulls, block(valid, s), (0,), N, bucket_cap))
        else:
            shards.append(ref.bucket_rows_by_pid(cols, nulls, block(valid, s), block(pid, s), N, bucket_cap))

    def all_to_all(xs):
        x = np.stack([np.asarray(x) for x in xs]).reshape(N, N, bucket_cap)
        return torch.from_numpy(x.transpose(1, 0, 2).reshape(-1).copy())

    n_cols = len(sb.columns)
    cols = tuple(all_to_all([sh[0][j] for sh in shards]) for j in range(n_cols))
    nulls = tuple(
        None if sb.nulls[j] is None else all_to_all([sh[1][j] for sh in shards])
        for j in range(n_cols)
    )
    return cols, nulls, all_to_all([sh[2] for sh in shards]), torch.tensor([bool(sh[3]) for sh in shards])


@pytest.mark.parametrize("bucket_cap", [2048, 64])
def test_fused_exchange_is_the_references_bucket_then_all_to_all(mesh, bucket_cap):
    """``exchange_by_key`` (one permutation) equals the reference's
    ``bucket_rows`` on each shard followed by the all-to-all: valid and
    overflow, columns and null masks at every live slot, at a bucket
    capacity that fits and at one that overflows; the same for
    ``exchange_by_pid`` against ``bucket_rows_by_pid`` on the
    caller-computed ids of the sample sort."""
    sb, valid = _nullable_input(mesh)
    fused = exchange_by_key(sb.columns, sb.nulls, valid, (0,), SHARD_AXIS, N, bucket_cap)
    pid = torch.where(valid, sb.columns[1] % (N + 2), N).to(torch.int32)  # ids past N drop
    fused_pid = exchange_by_pid(sb.columns, sb.nulls, valid, pid, N, bucket_cap)
    for a, b in (
        (fused, _reference_exchange(sb, valid, None, bucket_cap)),
        (fused_pid, _reference_exchange(sb, valid, pid, bucket_cap)),
    ):
        live = a[2]
        assert torch.equal(live, b[2]) and torch.equal(a[3], b[3])
        for x, y in zip(a[0], b[0]):
            assert torch.equal(x[live], y[live])
        for x, y in zip(a[1], b[1]):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x[live], y[live])
    assert bool(fused[3].any()) == (bucket_cap == 64)
    if bucket_cap == 2048:
        assert int(fused[2].sum()) == int(valid.sum())


def test_exchange_overflow_keeps_the_first_rows(mesh):
    """A row ranked past ``bucket_cap`` in its bucket is dropped and sets
    its source shard's flag; the rows that stay are the first ones in row
    order; dead rows never arrive."""
    t = pa.table({"k": np.zeros(4000, dtype=np.int64), "v": np.arange(4000, dtype=np.int64)})
    sb = _sharded(mesh, t)  # 500 rows a shard, all bound for one shard
    cols, _, valid, ovf = exchange_by_key(sb.columns, sb.nulls, sb.valid, (0,), SHARD_AXIS, N, 100)
    assert ovf.tolist() == [True] * N
    v = cols[1][valid].numpy()
    assert len(v) == N * 100
    per_src = sb.columns[1].view(N, -1)[:, :100]  # each shard's first 100 rows
    assert sorted(v.tolist()) == sorted(per_src.reshape(-1).tolist())


# -- the stages ----------------------------------------------------------------


def test_mesh_repartitioned_aggregate(mesh, runner, ref_routing):
    t = _data("aggregate")["t"]
    res = runner.aggregate(
        _sharded(mesh, t), [0], [1, 2, 1], [AggOp.SUM, AggOp.MAX, AggOp.COUNT], capacity=128
    )
    assert res.shards == N
    out = _frame(res)
    out = out.sort_values(out.columns[0]).reset_index(drop=True)
    want = t.to_pandas().groupby("k").agg(s=("v", "sum"), m=("w", "max"), c=("v", "count")).reset_index()
    np.testing.assert_array_equal(out.iloc[:, 0], want.k)
    np.testing.assert_allclose(out.iloc[:, 1], want.s, rtol=1e-9)
    np.testing.assert_array_equal(out.iloc[:, 2], want.m)
    np.testing.assert_array_equal(out.iloc[:, 3], want.c)
    assert _as_lists(_per_shard([res.columns[0]], res.valid)) == ref_routing["aggregate"]


def test_mesh_aggregate_routes_string_keys_by_code(mesh, runner, ref_routing):
    """A STRING group key routes by its dictionary code, as the
    reference's mesh routes it: every shard holds the reference's
    values."""
    t = _data("aggregate_str")["t"]
    res = runner.aggregate(_sharded(mesh, t), [0], [1], [AggOp.SUM], capacity=128)
    d = res.dictionaries[res.schema.fields[0].name].values
    got = _per_shard([res.columns[0]], res.valid, decode=lambda c: d[c])
    assert _as_lists(got) == ref_routing["aggregate_str"]
    out = _frame(res).sort_values("c").reset_index(drop=True)
    want = t.to_pandas().groupby("c").v.sum().reset_index()
    assert out.c.tolist() == want.c.tolist()
    np.testing.assert_allclose(out.iloc[:, 1], want.v, rtol=1e-9)


def test_mesh_aggregate_grows_its_group_capacity(mesh, runner, monkeypatch):
    """A group overflow retries with the required capacity; past
    ``MAX_MESH_RETRIES`` it raises ``CapacityError`` with ``required``."""
    t = _data("aggregate")["t"]
    before = stage.retries
    res = runner.aggregate(_sharded(mesh, t), [0], [2], [AggOp.COUNT], capacity=4)
    assert stage.retries > before
    out = _frame(res)
    assert sorted(out.iloc[:, 0]) == list(range(53)) and out.iloc[:, 1].sum() == t.num_rows
    monkeypatch.setattr(stage, "MAX_MESH_RETRIES", 1)
    with pytest.raises(CapacityError, match="group capacity") as ei:
        runner.aggregate(_sharded(mesh, t), [0], [2], [AggOp.COUNT], capacity=4)
    assert ei.value.required >= 53 // N


def test_mesh_partitioned_join(mesh, runner, ref_routing):
    ns = _data("join")
    fact, dim, nd = ns["fact"], ns["dim"], ns["nd"]
    sf, sd = _sharded(mesh, fact), _sharded(mesh, dim)
    fdf, ddf = fact.to_pandas(), dim.to_pandas()

    inner = runner.join(sf, sd, [0], [0], JoinSide.INNER)
    assert _as_lists(_per_shard([inner.columns[0]], inner.valid)) == ref_routing["join"]
    inner = _frame(inner)
    want = fdf.merge(ddf, left_on="k", right_on="k2")
    assert len(inner) == len(want)
    np.testing.assert_allclose(sorted(inner.v), sorted(want.v), rtol=1e-12)
    assert sorted(zip(inner.k, inner.name)) == sorted(zip(want.k, want.name))

    semi = _frame(runner.join(sf, sd, [0], [0], JoinSide.SEMI))
    assert len(semi) == (fdf.k < nd).sum()
    anti = _frame(runner.join(sf, sd, [0], [0], JoinSide.ANTI))
    assert len(anti) == (fdf.k >= nd).sum()
    left = _frame(runner.join(sf, sd, [0], [0], JoinSide.LEFT))
    assert len(left) == len(fdf)
    assert left.name.isna().sum() == (fdf.k >= nd).sum()


def _pairs(mode: str):
    """(left, right, key columns) whose build side packs in ``mode``, with
    duplicate keys on both sides (m:n expansion)."""
    rng = np.random.default_rng(17)
    n_l, n_r = 3000, 700
    if mode == "exact":
        lk, rk = {"a": rng.integers(0, 150, n_l)}, {"a2": rng.integers(0, 150, n_r)}
    elif mode == "exact2":
        lk = {"a": rng.integers(0, 20, n_l), "b": rng.integers(0, 9, n_l)}
        rk = {"a2": rng.integers(0, 20, n_r), "b2": rng.integers(0, 9, n_r)}
    else:  # a float key hashes; a run of equal hashes stays within the
        # probe window (ops/join.COLLISION_WINDOW), so two of each key
        lk = {"a": rng.integers(0, 400, n_l) / 4.0}
        rk = {"a2": rng.permutation(np.repeat(np.arange(n_r // 2), 2)) / 4.0}
    left = pa.table({**lk, "v": rng.uniform(size=n_l)})
    right = pa.table({**rk, "w": rng.uniform(size=n_r)})
    return left, right, list(lk), list(rk)


@pytest.mark.parametrize("mode", ["exact", "exact2", "hash"])
def test_mesh_join_pack_modes(mesh, runner, mode, monkeypatch):
    """Each pack mode of the build side, with duplicate keys on both sides:
    INNER (the m:n expansion, through an expansion-capacity retry: the
    first step is given 64 output rows a shard), LEFT, SEMI and ANTI
    against pandas."""
    left, right, lk, rk = _pairs(mode)
    sl, sr = _sharded(mesh, left), _sharded(mesh, right)
    keys = list(range(len(lk)))
    assert _choose_pack_mode(sr, keys) == mode
    ldf, rdf = left.to_pandas(), right.to_pandas()
    m = ldf.merge(rdf, left_on=lk, right_on=rk)
    before = stage.retries
    real_step, out_caps = stage.join_step, []

    def small_first_step(*args):
        args = list(args)
        if not out_caps:
            args[8] = 64  # out_cap
        out_caps.append(args[8])
        return real_step(*args)

    monkeypatch.setattr(stage, "join_step", small_first_step)
    inner = _frame(runner.join(sl, sr, keys, keys, JoinSide.INNER))
    monkeypatch.setattr(stage, "join_step", real_step)
    # the expansion outgrew 64 rows a shard and the step ran again
    assert stage.retries > before and out_caps[0] == 64 and out_caps[-1] > 64
    assert len(inner) == len(m)
    np.testing.assert_allclose(sorted(inner.v * 1000 + inner.w), sorted(m.v * 1000 + m.w), rtol=1e-12)
    hit = ldf.set_index(lk).index.isin(rdf.set_index(rk).index)
    left_out = _frame(runner.join(sl, sr, keys, keys, JoinSide.LEFT))
    assert len(left_out) == len(m) + (~hit).sum()
    assert left_out.w.isna().sum() == (~hit).sum()
    assert len(_frame(runner.join(sl, sr, keys, keys, JoinSide.SEMI))) == hit.sum()
    assert len(_frame(runner.join(sl, sr, keys, keys, JoinSide.ANTI))) == (~hit).sum()


def test_mesh_join_two_int_keys_route_like_the_reference(mesh, runner, ref_routing):
    ns = _data("join2")
    out = runner.join(_sharded(mesh, ns["fact"]), _sharded(mesh, ns["dim"]), [0, 1], [0, 1])
    got = _per_shard([out.columns[0], out.columns[1]], out.valid)
    assert _as_lists(got) == ref_routing["join2"]


def test_mesh_join_residual_filter_and_shared_dictionaries(mesh, runner):
    left, right, _, _ = _pairs("exact")
    sl, sr = _sharded(mesh, left), _sharded(mesh, right)

    def fn(b: DeviceBatch) -> torch.Tensor:  # v < w over the joined shard
        return b.columns[1] < b.columns[3]

    got = _frame(runner.join(sl, sr, [0], [0], JoinSide.INNER, filter_fn=fn))
    m = left.to_pandas().merge(right.to_pandas(), left_on="a", right_on="a2")
    m = m[m.v < m.w]
    assert len(got) == len(m)
    np.testing.assert_allclose(sorted(got.v + got.w), sorted(m.v + m.w), rtol=1e-12)
    a = _sharded(mesh, pa.table({"s": ["x", "y", "z"]}))
    b = _sharded(mesh, pa.table({"s": ["y", "w"]}))
    with pytest.raises(ExecutionError, match="shared dictionary"):
        runner.join(a, b, [0], [0])


def test_mesh_topk(mesh, runner):
    rng = np.random.default_rng(3)
    n = 9000
    t = pa.table({"k": rng.integers(0, 50, n), "v": np.round(rng.uniform(0, 100, n), 1)})
    out = runner.topk(_sharded(mesh, t), [SortKey(1, ascending=False), SortKey(0)], 25)
    assert out.shards is None and out.capacity == 25
    got = _frame(out)
    want = t.to_pandas().sort_values(["v", "k"], ascending=[False, True]).head(25)
    assert got.v.tolist() == want.v.tolist() and got.k.tolist() == want.k.tolist()


def test_mesh_sample_sort_under_skew(mesh, runner, monkeypatch):
    """Few distinct primary keys overflow the first bucket capacity; the
    retry grows it and the result is the total order. Past
    ``MAX_MESH_RETRIES`` the overflow raises ``CapacityError``."""
    rng = np.random.default_rng(9)
    n = 40_000
    k = np.where(rng.uniform(size=n) < 0.9, 7, rng.integers(0, 1000, n))
    t = pa.table({"k": k, "g": rng.integers(0, 5, n), "v": np.arange(n, dtype=np.int64)})
    sb = _sharded(mesh, t)
    before = stage.retries
    out = runner.sort_full(sb, [SortKey(0), SortKey(2, ascending=False)])
    assert stage.retries > before and out.shards == N
    got = _frame(out)
    want = t.to_pandas().sort_values(["k", "v"], ascending=[True, False])
    assert got.k.tolist() == want.k.tolist() and got.v.tolist() == want.v.tolist()
    monkeypatch.setattr(stage, "MAX_MESH_RETRIES", 1)
    with pytest.raises(CapacityError, match="mesh sort bucket overflow") as ei:
        runner.sort_full(sb, [SortKey(0)])
    assert ei.value.required == sb.capacity  # the per-shard rows, over every shard


def test_mesh_sample_sort_nulls_and_desc(mesh, runner):
    rng = np.random.default_rng(4)
    n = 6000
    v = rng.uniform(-1, 1, n)
    t = pa.table({"v": pa.array(v, mask=rng.uniform(size=n) < 0.1), "i": np.arange(n)})
    for asc, nf in ((True, False), (False, True), (True, True)):
        out = _frame(runner.sort_full(_sharded(mesh, t), [SortKey(0, asc, nf)]))
        want = t.to_pandas().sort_values("v", ascending=asc, na_position="first" if nf else "last")
        np.testing.assert_array_equal(out.v.to_numpy(), want.v.to_numpy())


def test_mesh_window(mesh, runner):
    """The window stage: rows exchanged by the PARTITION BY key, then the
    local window operator's computation on each shard, equal to the local
    operator over all rows."""
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.exec.window import WindowExec

    rng = np.random.default_rng(8)
    n = 5000
    t = pa.table({"g": rng.integers(0, 30, n), "v": rng.permutation(n).astype(np.float64)})
    ctx = TorchContext(device="cpu")
    ctx.register_table("t", t)
    sql = "SELECT g, v, rank() OVER (PARTITION BY g ORDER BY v) AS r FROM t"
    logical = ctx.sql_to_logical(sql)
    want = ctx.sql(sql).collect().to_pandas().sort_values("v").reset_index(drop=True)
    win = next(p for p in _walk(ctx.create_physical_plan(logical)) if isinstance(p, WindowExec))
    sb = _sharded(mesh, t)

    def local_fn(cols, nulls, valid):
        shard = DeviceBatch(sb.schema, tuple(cols), valid, tuple(nulls), sb.dictionaries)
        return win.append_window_columns(shard)

    cols, _, valid = runner.window(sb, [0], local_fn)
    got = pd.DataFrame({"g": cols[0][valid].numpy(), "v": cols[1][valid].numpy(), "r": cols[2][valid].numpy()})
    got = got.sort_values("v").reset_index(drop=True)
    assert got.g.tolist() == want.g.tolist() and got.r.tolist() == want.r.tolist()


def _walk(p):
    yield p
    for c in p.children():
        yield from _walk(c)


# -- the dry run and the scheduler path ----------------------------------------


def test_dryrun_in_process():
    """The dry run on 8 CPU shards: the context's plan and the standalone
    cluster's stage plans route through the mesh operators, the executor
    runs them, and both results equal the numpy oracle."""
    import os

    from ballista_tpu_torch.parallel import dryrun

    before = os.environ.get("BALLISTA_TPU_MESH_SHARDS")
    dryrun.run(8, device="cpu")
    assert os.environ.get("BALLISTA_TPU_MESH_SHARDS") == before


def test_mesh_capable_executor_gets_a_fused_mesh_stage(monkeypatch):
    """An executor that advertises 8 shards gets the join and aggregate
    chain fused into one mesh stage (no hash repartition between them);
    with collective shuffle off the same query splits at the reference's
    exchanges."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig

    monkeypatch.setenv("BALLISTA_TPU_MESH_SHARDS", "8")
    ns = _data("join")
    sql = "SELECT name, COUNT(*) AS c FROM fact JOIN dim ON k = k2 GROUP BY name"
    want = ns["fact"].to_pandas().merge(ns["dim"].to_pandas(), left_on="k", right_on="k2")
    want = want.groupby("name").size()
    n_stages = {}
    for on in ("true", "false"):
        dctx = BallistaContext.standalone(
            BallistaConfig({"ballista.tpu.collective_shuffle": on}), device="cpu"
        )
        try:
            sched = dctx._standalone_cluster.scheduler
            assert all(em.specification.n_devices == 8 for em in sched.executor_manager.all_executors())
            dctx.register_table("fact", ns["fact"])
            dctx.register_table("dim", ns["dim"])
            got = dctx.sql(sql).collect().to_pandas().set_index("name").c.sort_index()
            assert got.to_dict() == want.sort_index().to_dict()
            (job,) = sched.jobs.values()
            disp = "\n".join(s.plan.display() for s in job.stages.values())
            n_stages[on] = len(job.stages)
            if on == "true":
                assert "MeshJoinExec" in disp and "MeshAggregateExec" in disp, disp
                assert "HashRepartitionExec" not in disp and "ShuffleReaderExec" not in disp, disp
            else:
                assert "Mesh" not in disp, disp
        finally:
            dctx.close()
    assert n_stages["true"] < n_stages["false"], n_stages
