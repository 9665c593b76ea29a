"""The capacity ladder (``columnar/batch.py``: ``CapacityLadder``,
``set_capacity_buckets``, ``round_capacity``) against the reference's, on
the CPU: the ladder cases of ``tests/test_compile_cache.py`` through both
packages. Both parse, round and reject the same specs and sizes the same
way (bucket sizes exact, the same error messages), a batch built under a
custom ladder has the reference's capacity, an adaptive retry snaps to the
ladder, and a context installs its session's ladder for the process."""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu.columnar import batch as ref_batch
from ballista_tpu_torch.columnar import batch
from ballista_tpu_torch.columnar.batch import (
    MIN_CAPACITY,
    CapacityLadder,
    DeviceBatch,
    capacity_ladder,
    round_capacity,
    set_capacity_buckets,
)
from ballista_tpu_torch.datatypes import DataType, Field, Schema

SPECS = ["", "2048:2", "2048:4", "4096", "2048,10000,100000", "2048,6144", "10000,2048", "3000:3"]
BAD = ["0", "2048:1", "4", "-1,2048", "1024:2", "x", "16,2048", "2048:x"]
SIZES = [0, 1, 2047, 2048, 2049, 4096, 4097, 6144, 6145, 10000, 10001, 100000, 100001, 150000, 1 << 20, (1 << 20) + 1]


@pytest.fixture
def restore_ladder():
    """Installing a ladder is process-wide: restore both packages'."""
    specs = capacity_ladder().spec(), ref_batch.capacity_ladder().spec()
    yield
    set_capacity_buckets(specs[0])
    ref_batch.set_capacity_buckets(specs[1])


def test_default_ladder_matches_historical_pow2():
    lad = CapacityLadder()
    assert lad.spec() == ref_batch.CapacityLadder().spec() == "2048:2"
    assert lad.round(0) == lad.round(1) == lad.round(MIN_CAPACITY) == MIN_CAPACITY
    assert lad.round(MIN_CAPACITY + 1) == 2 * MIN_CAPACITY
    assert lad.round(1 << 20) == 1 << 20
    assert lad.round((1 << 20) + 1) == 1 << 21


def test_geometric_ladder_boundaries():
    lad, ref = CapacityLadder(min_cap=1000, ratio=4), ref_batch.CapacityLadder(min_cap=1000, ratio=4)
    for n in (0, 1000, 1001, 4000, 4001, 16001):
        assert lad.round(n) == ref.round(n), n
    assert lad.round(4001) == 16000
    assert lad.buckets_upto(5000) == ref.buckets_upto(5000) == (1000, 4000, 16000)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_and_round_match_reference(spec):
    lad, ref = CapacityLadder.parse(spec), ref_batch.CapacityLadder.parse(spec)
    assert lad.spec() == ref.spec()
    assert [lad.round(n) for n in SIZES] == [ref.round(n) for n in SIZES]
    for n in (1, 5000, 150000, 1 << 20):
        assert lad.buckets_upto(n) == ref.buckets_upto(n), n


@pytest.mark.parametrize("spec", BAD)
def test_ladder_parse_rejects_malformed_specs(spec):
    """Both packages refuse the spec with the same message, and both
    configs refuse the key with it."""
    from ballista_tpu.config import BallistaConfig as RefConfig
    from ballista_tpu_torch.config import BallistaConfig

    with pytest.raises(ValueError) as want:
        ref_batch.CapacityLadder.parse(spec)
    with pytest.raises(ValueError) as got:
        CapacityLadder.parse(spec)
    assert str(got.value) == str(want.value)
    with pytest.raises(Exception) as want:
        RefConfig({"ballista.tpu.capacity_buckets": spec})
    with pytest.raises(Exception) as got:
        BallistaConfig({"ballista.tpu.capacity_buckets": spec})
    assert str(got.value) == str(want.value)


def test_set_capacity_buckets_governs_round_capacity(restore_ladder):
    for pkg in (batch, ref_batch):
        pkg.set_capacity_buckets("2048:4")
    assert round_capacity(2049) == ref_batch.round_capacity(2049) == 8192
    assert round_capacity(8193) == ref_batch.round_capacity(8193) == 32768
    for pkg in (batch, ref_batch):
        pkg.set_capacity_buckets("")  # empty spec = default ladder
    assert round_capacity(2049) == ref_batch.round_capacity(2049) == 4096


def test_flip_after_install_is_logged(restore_ladder, caplog):
    set_capacity_buckets("2048:4")
    caplog.clear()
    with caplog.at_level("WARNING", logger=batch.__name__):
        set_capacity_buckets("2048:8")
        set_capacity_buckets("2048:8")  # unchanged: no second warning
    assert [r.getMessage() for r in caplog.records] == [
        "capacity ladder changed 2048:4 -> 2048:8; mixed-ladder sessions on one "
        "executor re-learn their capacities"
    ]


def test_device_batch_under_custom_ladder(restore_ladder):
    """Empty batches keep their STRING dictionaries, and ``from_host`` pads
    to the reference's capacity at a non-pow2 bucket."""
    from ballista_tpu.datatypes import DataType as RDT
    from ballista_tpu.datatypes import Field as RF
    from ballista_tpu.datatypes import Schema as RS

    for pkg in (batch, ref_batch):
        pkg.set_capacity_buckets("2048,6144")
    schema = Schema([Field("k", DataType.INT64), Field("s", DataType.STRING)])
    b = DeviceBatch.empty(schema, capacity=round_capacity(5000), device="cpu")
    want = ref_batch.DeviceBatch.empty(
        RS([RF("k", RDT.INT64), RF("s", RDT.STRING)]), capacity=ref_batch.round_capacity(5000)
    )
    assert b.capacity == want.capacity == 6144
    assert "s" in b.dictionaries and len(b.dictionaries["s"].values) == 0
    assert int(b.count_valid()) == 0
    x = np.arange(3000, dtype=np.int64)
    b2 = DeviceBatch.from_host(Schema([Field("x", DataType.INT64)]), [x], 3000, device="cpu")
    w2 = ref_batch.DeviceBatch.from_host(RS([RF("x", RDT.INT64)]), [x], 3000)
    assert b2.capacity == w2.capacity == 6144
    assert int(b2.count_valid()) == int(w2.count_valid()) == 3000


def test_adaptive_capacity_retry_snaps_to_ladder(restore_ladder):
    """``run_with_capacity_retry``'s grown capacity rounds through the
    ladder, to the reference's bucket."""
    from ballista_tpu.config import BallistaConfig as RefConfig
    from ballista_tpu.errors import CapacityError as RefCapacityError
    from ballista_tpu.exec.base import run_with_capacity_retry as ref_retry
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.errors import CapacityError
    from ballista_tpu_torch.exec.base import run_with_capacity_retry

    for pkg in (batch, ref_batch):
        pkg.set_capacity_buckets("2048:4")
    seen = {"port": [], "ref": []}

    def body(side, err):
        def run(ctx):
            seen[side].append(ctx.agg_capacity_override or 0)
            if len(seen[side]) < 2:
                raise err("grow", required=100_000)
            return "ok"
        return run

    assert run_with_capacity_retry(BallistaConfig(), body("port", CapacityError), device="cpu") == "ok"
    assert ref_retry(RefConfig(), body("ref", RefCapacityError)) == "ok"
    assert seen["port"] == seen["ref"]
    assert seen["port"][1] in capacity_ladder().buckets_upto(seen["port"][1])
    assert seen["port"][1] == 131072


def test_context_installs_the_session_ladder(restore_ladder):
    """``TorchContext`` installs ``ballista.tpu.capacity_buckets`` as
    ``TpuContext`` does, and a query under a coarse ladder equals the
    reference's under the same ladder."""
    from ballista_tpu.config import BallistaConfig as RefConfig
    from ballista_tpu.exec.context import TpuContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.context import TorchContext
    from test_torch_tpch import cmp

    settings = {"ballista.tpu.capacity_buckets": "2048:8"}
    ref = TpuContext(RefConfig(settings))
    port = TorchContext(BallistaConfig(settings), device="cpu")
    assert capacity_ladder().spec() == ref_batch.capacity_ladder().spec() == "2048:8"
    rng = np.random.default_rng(7)
    t = pa.table({"k": pa.array(rng.integers(0, 300, 20_000)), "v": pa.array(rng.integers(0, 1000, 20_000))})
    sql = "SELECT k, COUNT(*) AS n, SUM(v) AS s FROM t GROUP BY k ORDER BY k"
    for c in (ref, port):
        c.register_table("t", t)
    got, want = port.sql(sql).collect(), ref.sql(sql).collect()
    assert got.equals(want)
    cmp(got.to_pandas(), want.to_pandas())
