"""The result cache's version-source matrix on the port, the cases of
``tests/test_cache_coherence.py``'s key-flip section: every table-mutation
path of ``TorchContext`` flips ``result_cache_key`` so that a stale payload
can never be served by key, a session-setting change flips it too, and
with no mutation the key stays (else the cache never hits). The rows of
``append_table``'s rejections are the reference's.

A memory table's data version is its registration generation, drawn from
a process-wide counter at every registration: registering the very same
object again flips the key, and a table dropped and replaced by another of
the same row count never shares the old key, where an ``id()``-based key
could (the freed table's address can be reused: the reference's
``drop-reregister`` case is a known failure for that reason). The
property is asserted here, not held against the reference."""

import pyarrow as pa
import pytest

from ballista_tpu.exec.context import TpuContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.scheduler.result_cache import ResultCache, result_cache_key

ROWS = {"a": [1, 2, 3], "b": [1.0, 2.0, 3.0]}


def _ctx():
    ctx = TorchContext(device="cpu")
    ctx.register_table("t", pa.table(ROWS))
    return ctx


def _key(ctx, cfg=None, sql="select sum(a) as s from t"):
    return result_cache_key(optimize(ctx.sql_to_logical(sql)), cfg or BallistaConfig(), ctx)


def _same_object_again(ctx):
    ctx.register_table("t", ctx.tables["t"].kw["table"])


def _drop_and_same_object(ctx):
    t = ctx.tables["t"].kw["table"]
    ctx.deregister_table("t")
    ctx.register_table("t", t)


@pytest.mark.parametrize(
    "mutate",
    [
        pytest.param(lambda ctx: ctx.register_table("t", pa.table({"a": [9], "b": [9.0]})), id="register-replace"),
        pytest.param(lambda ctx: ctx.append_table("t", pa.table({"a": [4], "b": [4.0]})), id="append"),
        pytest.param(
            lambda ctx: (ctx.deregister_table("t"), ctx.register_table("t", pa.table(ROWS))),
            id="drop-reregister",
        ),
        pytest.param(_same_object_again, id="same-object-reregister"),
        pytest.param(_drop_and_same_object, id="drop-same-object"),
    ],
)
def test_every_table_mutation_flips_the_key(mutate):
    ctx = _ctx()
    cache = ResultCache(capacity_bytes=1 << 20)
    old_key = _key(ctx)
    assert old_key is not None
    cache.put(old_key, b"stale-payload")
    mutate(ctx)
    new_key = _key(ctx)
    assert new_key is not None and new_key != old_key
    # the stale payload is dead by key: the lookup after the mutation can
    # never see it
    assert cache.get(new_key) is None


def test_drop_and_replace_never_reuses_a_key():
    """50 rounds of drop and register with different rows of the same row
    count: 50 distinct keys (an ``id()``-based key repeated in about one
    round in 20), and no round's lookup sees another round's payload."""
    ctx = _ctx()
    cache = ResultCache(capacity_bytes=1 << 20)
    keys = []
    for i in range(50):
        ctx.deregister_table("t")
        ctx.register_table("t", pa.table({"a": [i, i + 1, i + 2], "b": [1.0, 2.0, 3.0]}))
        k = _key(ctx)
        assert cache.get(k) is None, f"round {i} found an earlier round's payload"
        cache.put(k, f"round-{i}".encode())
        keys.append(k)
    assert len(set(keys)) == 50


def test_session_setting_change_flips_the_key():
    ctx = _ctx()
    cache = ResultCache(capacity_bytes=1 << 20)
    cfg = BallistaConfig()
    old_key = _key(ctx, cfg)
    cache.put(old_key, b"stale-payload")
    new_key = _key(ctx, BallistaConfig({"ballista.shuffle.partitions": "7"}))
    assert new_key != old_key
    assert cache.get(new_key) is None


def test_no_mutation_preserves_the_key():
    # the property is iff-shaped: the key must be stable when nothing
    # changed, else the cache never hits at all
    ctx = _ctx()
    assert _key(ctx) == _key(ctx)
    ctx.sql("select sum(a) as s from t").collect()  # a run changes no version
    assert _key(ctx) == _key(ctx, sql="select  sum(a)  as s  from t")


def test_plan_cache_follows_the_data_version():
    """The physical-plan cache keys on the same data version: the same
    object registered again plans afresh, and the new plan serves the
    rows."""
    ctx = _ctx()
    sql = "select sum(a) as s from t"
    assert ctx.sql(sql).collect().column("s").to_pylist() == [6]
    first = ctx._data_version()
    _same_object_again(ctx)
    assert ctx._data_version() != first and not ctx._physical_cache
    assert ctx.sql(sql).collect().column("s").to_pylist() == [6]
    assert len(ctx._physical_cache) == 1


def test_append_table_appends_and_queries_see_new_rows():
    ref, port = TpuContext(), _ctx()
    ref.register_table("t", pa.table(ROWS))
    for c in (ref, port):
        c.append_table("t", pa.table({"a": [10], "b": [10.0]}))
    sql = "select sum(a) as s, count(*) as n from t"
    got = port.sql(sql).collect()
    assert got.equals(ref.sql(sql).collect())
    assert got.column("s").to_pylist() == [16]


def test_append_table_rejects_unknown_and_schema_mismatch():
    ctx = _ctx()
    with pytest.raises(PlanError, match="not a registered memory table"):
        ctx.append_table("nope", pa.table({"a": [1]}))
    with pytest.raises(PlanError, match="schema mismatch"):
        ctx.append_table("t", pa.table({"z": ["wrong"]}))
    # a rejected append leaves the table and its key as they were
    before = _key(ctx)
    with pytest.raises(PlanError):
        ctx.append_table("t", pa.table({"z": ["wrong"]}))
    assert _key(ctx) == before
