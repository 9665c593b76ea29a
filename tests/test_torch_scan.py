"""File scans of the port (``ballista_tpu_torch/exec/scan.py``) against
the reference's on the same files: CSV parsed once, Parquet row-group
pruning (never losing a row, off by config), the pruning evaluator over a
table of predicates, INT64 narrowing from file statistics, the streamed
path at prefetch depths 0 and 1, mtime invalidation of the scan cache,
the device of an empty partition, and Avro (the cases of
``test_scan_hygiene.py``, ``test_avro.py`` and
``test_out_of_core.py::test_prefetch_streamed_scan_bit_exact``, through
both packages)."""

import datetime
import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as papq
import pytest
import torch

from ballista_tpu import avro as ref_avro
from ballista_tpu.config import BallistaConfig as RefConfig
from ballista_tpu.exec import scan as ref_scan
from ballista_tpu.exec.base import plan_counters as ref_counters
from ballista_tpu.exec.context import TpuContext
from ballista_tpu_torch import avro
from ballista_tpu_torch.columnar.arrow_interop import batch_to_arrow, schema_from_arrow
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.exec import scan
from ballista_tpu_torch.exec.base import TaskContext, plan_counters
from ballista_tpu_torch.exec.context import TorchContext


def contexts(settings: dict | None = None):
    settings = settings or {}
    return TpuContext(RefConfig(settings)), TorchContext(BallistaConfig(settings), device="cpu")


def find(plan, cls):
    if isinstance(plan, cls):
        return plan
    for c in plan.children():
        s = find(c, cls)
        if s is not None:
            return s
    return None


def test_csv_scan_parses_file_once(tmp_path, monkeypatch):
    n = 10_000
    t = pa.table(
        {
            "a": pa.array(np.arange(n, dtype=np.int64)),
            "b": pa.array(np.random.default_rng(0).uniform(0, 1, n)),
        }
    )
    path = tmp_path / "t.csv"
    pacsv.write_csv(t, path)
    calls = {"n": 0}
    orig = pacsv.read_csv

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(pacsv, "read_csv", counting)
    s = scan.CsvScanExec(str(path), schema_from_arrow(t.schema), partitions=4)
    got = [batch_to_arrow(b) for p in range(4) for b in s.execute(p, TaskContext(device="cpu"))]
    assert calls["n"] == 1, f"CSV parsed {calls['n']} times for 4 partitions"
    assert pa.Table.from_batches(got).equals(t)


@pytest.fixture(scope="module")
def sorted_parquet(tmp_path_factory):
    n = 50_000
    t = pa.table(
        {
            "k": pa.array(np.arange(n, dtype=np.int64)),  # sorted
            "v": pa.array(np.random.default_rng(1).uniform(0, 1, n)),
        }
    )
    path = tmp_path_factory.mktemp("pq") / "t.parquet"
    papq.write_table(t, path, row_group_size=5_000)  # 10 row groups
    return str(path), t


def test_parquet_row_group_pruning(sorted_parquet):
    path, t = sorted_parquet
    sql = "SELECT COUNT(*) AS c, SUM(v) AS s FROM t WHERE k >= 45000"
    ref, port = contexts()
    for c in (ref, port):
        c.register_parquet("t", path)
    want = ref.sql(sql).collect()
    got, phys = port.sql(sql).collect_with_plan()
    assert got.equals(want)
    assert got.column("c").to_pylist() == [5_000]
    np.testing.assert_allclose(got.column("s")[0].as_py(), t.to_pandas().query("k >= 45000").v.sum(), rtol=1e-9)
    assert plan_counters(phys, ["row_groups_pruned"])["row_groups_pruned"] == 9
    s = find(phys, scan.ParquetScanExec)
    assert s.predicates and s.describe() == find(
        ref.create_physical_plan(ref.sql_to_logical(sql)), ref_scan.ParquetScanExec
    ).describe()


def test_pruning_never_loses_rows(sorted_parquet):
    """A predicate the statistics cannot decide keeps every group."""
    path, t = sorted_parquet
    ref, port = contexts()
    for c in (ref, port):
        c.register_parquet("t", path)
    sql = "SELECT COUNT(*) AS c FROM t WHERE v < 0.25 OR k < 10"
    got, phys = port.sql(sql).collect_with_plan()
    assert got.equals(ref.sql(sql).collect())
    df = t.to_pandas()
    assert got.column("c").to_pylist() == [int(((df.v < 0.25) | (df.k < 10)).sum())]
    assert plan_counters(phys, ["row_groups_pruned"])["row_groups_pruned"] == 0


def test_pruning_disabled_by_config(sorted_parquet):
    path, _ = sorted_parquet
    ref, port = contexts({"ballista.parquet.pruning": "false"})
    for c in (ref, port):
        c.register_parquet("t", path)
    sql = "SELECT COUNT(*) AS c FROM t WHERE k >= 45000"
    got, phys = port.sql(sql).collect_with_plan()
    assert got.equals(ref.sql(sql).collect())
    s = find(phys, scan.ParquetScanExec)
    assert s._kept_groups == list(range(10))  # every group read
    assert plan_counters(phys, ["row_groups_pruned"])["row_groups_pruned"] == 0


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


PREDICATES = [
    "a = 5", "a <> 5", "a < 5", "a <= 5", "a > 5", "a >= 5", "5 < a", "5 >= a", "12 = a",
    "a BETWEEN 3 AND 7", "a BETWEEN 20 AND 30", "a NOT BETWEEN 3 AND 7", "a NOT BETWEEN -5 AND 50",
    "a IN (1, 9, 20)", "a IN (20, 30)", "a NOT IN (1, 2)",
    "a > 3 AND s = 'x'", "a > 100 OR s < 'b'", "a > 100 OR s > 'j'",
    "a = NULL", "a > NULL", "NULL < a",
    "d >= DATE '1995-01-01'", "d < DATE '1994-06-01'", "d BETWEEN DATE '1993-01-01' AND DATE '1993-12-31'",
    "s = 'm'", "s > 'zz'", "s <= 'c'", "f < 0.5", "f >= 1.5", "a + 1 > 50",
]
STATS = {
    "spread": {"a": (0, 10), "d": (_days(1994, 1, 1), _days(1994, 12, 31)), "s": ("c", "k"), "f": (1.0, 2.0)},
    "point": {"a": (5, 5), "d": (_days(1995, 1, 1), _days(1995, 1, 1)), "s": ("m", "m"), "f": (0.5, 0.5)},
    "no min/max": {"a": (None, None), "s": (None, None)},
    "none": {},
}


def _predicate(ctx, where: str):
    plan = ctx.sql_to_logical(f"SELECT a FROM t WHERE {where}")
    while type(plan).__name__ != "Filter":
        plan = plan.children()[0]
    return plan.predicate


@pytest.fixture(scope="module")
def predicate_contexts():
    t = pa.table(
        {
            "a": pa.array([1], pa.int64()),
            "d": pa.array([datetime.date(1994, 1, 1)], pa.date32()),
            "s": pa.array(["x"]),
            "f": pa.array([1.0]),
        }
    )
    ref, port = contexts()
    for c in (ref, port):
        c.register_table("t", t)
    return ref, port


@pytest.mark.parametrize("stats", sorted(STATS))
@pytest.mark.parametrize("where", PREDICATES)
def test_predicate_may_match_as_reference(predicate_contexts, where, stats):
    ref, port = predicate_contexts
    col_stats = STATS[stats]
    want = ref_scan._predicate_may_match(_predicate(ref, where), ref.schema_of("t"), col_stats)
    got = scan._predicate_may_match(_predicate(port, where), port.schema_of("t"), col_stats)
    assert got == want


def test_predicate_table_prunes_something(predicate_contexts):
    """The table above is not trivially all True."""
    _, port = predicate_contexts
    pruned = [
        w for w in PREDICATES
        if not scan._predicate_may_match(_predicate(port, w), port.schema_of("t"), STATS["spread"])
    ]
    assert len(pruned) >= 8, pruned


def test_stat_value_normalizes_parquet_statistics():
    """DATE32 statistics come back as dates, strings as str or bytes
    (pyarrow versions differ); each lands in the literal domain."""
    from ballista_tpu_torch.datatypes import DataType

    cases = [
        (datetime.date(1995, 3, 15), DataType.DATE32),
        (datetime.datetime(2020, 1, 1, 12), DataType.TIMESTAMP_US),
        (b"abc", DataType.STRING), (b"\xff\xfe", DataType.STRING), ("abc", DataType.STRING),
        (7, DataType.INT64), (None, DataType.INT64), (2.5, DataType.FLOAT64),
    ]
    for v, dt in cases:
        assert scan._stat_value(v, dt) == ref_scan._stat_value(v, _ref_dt(dt))


def _ref_dt(dt):
    from ballista_tpu.datatypes import DataType as RefDataType

    return RefDataType(dt.value)


def test_narrowing_from_file_statistics(tmp_path):
    """INT64 columns narrow to int32 when every row group's statistics fit;
    a column without statistics stays wide, as in the reference."""
    n = 20_000
    r = np.random.default_rng(5)
    t = pa.table(
        {
            "small": pa.array(r.integers(-1000, 1000, n).astype(np.int64)),
            "big": pa.array(r.integers(0, 1 << 40, n).astype(np.int64)),
            "nostats": pa.array(r.integers(0, 10, n).astype(np.int64)),
            "day": pa.array(r.integers(8000, 9000, n).astype(np.int32)).cast(pa.date32()),
        }
    )
    path = str(tmp_path / "n.parquet")
    papq.write_table(t, path, row_group_size=3_000, write_statistics=["small", "big", "day"])
    tschema = schema_from_arrow(t.schema)
    from ballista_tpu.columnar.arrow_interop import schema_from_arrow as ref_schema

    got = scan.ParquetScanExec(path, tschema)._narrowable_from_stats(papq.ParquetFile(path))
    want = ref_scan.ParquetScanExec(path, ref_schema(t.schema))._narrowable_from_stats(papq.ParquetFile(path))
    assert got == want == frozenset({"small"})
    ref, port = contexts()
    for c in (ref, port):
        c.register_parquet("n", path)
    sql = "SELECT SUM(small) AS a, SUM(big) AS b, SUM(nostats) AS c, MAX(day) AS d FROM n WHERE small > 0"
    assert port.sql(sql).collect().equals(ref.sql(sql).collect())
    batches = list(scan.ParquetScanExec(path, tschema, partitions=2).execute(0, TaskContext(device="cpu")))
    assert [c.dtype for c in batches[0].columns] == [torch.int32, torch.int64, torch.int64, torch.int32]


@pytest.fixture(scope="module")
def fact():
    n = 60_000
    r = np.random.default_rng(11)
    return pa.table(
        {
            "k": pa.array(r.integers(0, 20_000, n).astype(np.int64)),
            "g": pa.array((np.arange(n) % 30_000).astype(np.int64)),
            "v": pa.array(r.integers(-1000, 1000, n).astype(np.int64)),
            "f": pa.array(r.uniform(0, 10, n)),
            # a string key whose values differ between row groups
            "s": pa.array([f"tag{(i // 7_000) * 3 + i % 5}" for i in range(n)]),
        }
    )


AGG_SQL = (
    "SELECT g, count(*) AS c, sum(v) AS sv, min(f) AS mn, max(f) AS mx "
    "FROM fact GROUP BY g ORDER BY g"
)
# projects over 1 MB, so that it streams
STRING_SQL = "SELECT s, count(*) AS c, sum(v) AS sv, sum(k) AS sk, max(f) AS mx FROM fact GROUP BY s ORDER BY s"
STREAM = ("stream_slices", "prefetch_hits", "prefetch_misses")


@pytest.mark.parametrize("sql", [AGG_SQL, STRING_SQL], ids=["int keys", "string keys"])
def test_prefetch_streamed_scan_bit_exact(fact, tmp_path, monkeypatch, sql):
    """The streamed scan (one row group a slice) at prefetch depths 0 and 1
    returns the materialised path's rows bit for bit and the reference's;
    a string key keeps one group across slices (whole-file dictionaries);
    the prefetch counters show the overlap; no device batch is cached."""
    path = str(tmp_path / "fact.parquet")
    papq.write_table(fact, path, row_group_size=4_000)
    monkeypatch.setattr(scan.ParquetScanExec, "STREAM_SLICE_BYTES", 1)
    monkeypatch.setattr(ref_scan.ParquetScanExec, "STREAM_SLICE_BYTES", 1)
    _, whole = contexts({"ballista.shuffle.partitions": "1"})
    whole.register_table("fact", fact)
    want = whole.sql(sql).collect()
    if sql == STRING_SQL:
        assert want.num_rows == len(set(fact.column("s").to_pylist()))
    runs = {}
    for depth in (0, 1):
        settings = {
            "ballista.shuffle.partitions": "1",
            "ballista.tpu.scan_stream_mb": "1",
            "ballista.tpu.prefetch_depth": str(depth),
        }
        ref, port = contexts(settings)
        for c in (ref, port):
            c.register_parquet("fact", path)
        got, phys = port.sql(sql).collect_with_plan()
        c = plan_counters(phys, STREAM)
        assert c["stream_slices"] == 15
        want_prefetch = 0 if depth == 0 else c["stream_slices"]
        assert c["prefetch_hits"] + c["prefetch_misses"] == want_prefetch
        rgot, rphys = ref.sql(sql).collect_with_plan()
        assert ref_counters(rphys, STREAM)["stream_slices"] == c["stream_slices"]
        assert got.equals(want) and got.equals(rgot)
        cache = port.tables["fact"].kw["scan_cache"]
        assert not any(k[0] == "dev" for k in cache if isinstance(k, tuple)), list(cache)
        runs[depth] = got
    assert runs[0].equals(runs[1])


def test_prefetch_slices_order_and_abandon():
    from ballista_tpu_torch.exec.base import Metrics
    from ballista_tpu_torch.exec.pipeline import prefetch_slices

    m = Metrics()
    assert list(prefetch_slices(lambda i: i * i, range(6), 2, m)) == [0, 1, 4, 9, 16, 25]
    assert m.counters.get("prefetch_hits", 0) + m.counters["prefetch_misses"] == 6
    loads = []
    gen = prefetch_slices(lambda i: loads.append(i) or i, range(100), 1)
    assert next(gen) == 0
    gen.close()  # an abandoned consumer stops the worker
    assert len(loads) <= 3


@pytest.mark.parametrize("kind", ["csv", "parquet", "avro"])
def test_rewritten_file_drops_both_cache_tiers(tmp_path, kind):
    """A registered file keeps its parsed table and device batches warm;
    rewriting the file (a new mtime) gives a fresh plan and drops both
    tiers, in the port as in the reference."""
    path = str(tmp_path / f"t.{kind}")

    def write(vals):
        t = pa.table({"x": pa.array(vals, pa.int64())})
        if kind == "csv":
            pacsv.write_csv(t, path)
        elif kind == "parquet":
            papq.write_table(t, path)
        else:
            avro.write_avro(path, t)

    write([1, 2, 3])
    ref, port = contexts()
    for c in (ref, port):
        header = " WITH HEADER ROW" if kind == "csv" else ""
        c.sql(f"CREATE EXTERNAL TABLE t STORED AS {kind.upper()}{header} LOCATION '{path}'")
    sql = "SELECT SUM(x) AS s FROM t"
    assert port.sql(sql).collect().column("s").to_pylist() == [6]
    cache = port.tables["t"].kw["scan_cache"]
    old = {k: v for k, v in cache.items() if isinstance(k, tuple) and k[0] in ("host", "dev")}
    assert any(k[0] == "dev" and v for k, v in old.items())
    dev = next(v for k, v in old.items() if k[0] == "dev")
    assert all(key[-1] == "cpu" for key in dev)  # device caches keyed by device
    assert port.sql(sql).collect().column("s").to_pylist() == [6]  # warm
    st = os.stat(path)
    write([10, 20])
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 5_000_000_000))
    got = port.sql(sql).collect()
    assert got.column("s").to_pylist() == [30]
    assert got.equals(ref.sql(sql).collect())
    # every entry of the old mtime is gone (a key may come back, with new data)
    assert not any(cache.get(k) is v for k, v in old.items())


def test_empty_partition_is_on_the_task_device(tmp_path):
    """A partition left without row groups (two partitions, one group)
    yields an empty batch on the task's device; a registered file's scan
    caches it like any batch, so its dictionaries keep their identity
    from run to run (dictionary merges are memoized by identity)."""
    t = pa.table({"x": pa.array([1, 2, 3], pa.int64()), "s": pa.array(["a", "b", "c"])})
    path = str(tmp_path / "one.parquet")
    papq.write_table(t, path)
    ctx = TaskContext(device="cpu")
    cache: dict = {}
    runs = []
    for _ in range(2):
        s = scan.ParquetScanExec(path, schema_from_arrow(t.schema), partitions=2, scan_cache=cache)
        (b,) = list(s.execute(1, ctx))
        assert b.device == ctx.device and int(b.valid.sum()) == 0
        assert b.dictionaries["s"].values == ()
        assert batch_to_arrow(b).num_rows == 0
        runs.append(b)
    assert runs[0] is runs[1]


@pytest.mark.gpu
def test_file_scans_on_card(tmp_path):
    """On the card: the empty partition and every batch on the card, the
    device cache keyed apart from the CPU's, results equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    t = pa.table({"x": pa.array(np.arange(10_000, dtype=np.int64)), "s": pa.array([f"v{i % 7}" for i in range(10_000)])})
    path = str(tmp_path / "t.parquet")
    papq.write_table(t, path, row_group_size=10_000)
    s = scan.ParquetScanExec(path, schema_from_arrow(t.schema), partitions=2)
    (b,) = list(s.execute(1, TaskContext(device="cuda")))
    assert b.device.type == "cuda"
    cpu, card = TorchContext(device="cpu"), TorchContext(device="cuda")
    sql = "SELECT s, SUM(x) AS v FROM t GROUP BY s ORDER BY s"
    for c in (cpu, card):
        c.register_parquet("t", path)
    want = cpu.sql(sql).collect()
    assert card.sql(sql).collect().equals(want)
    card.tables["t"].kw["scan_cache"] = cpu.tables["t"].kw["scan_cache"]  # shared on purpose
    card._physical_cache.clear()
    assert card.sql(sql).collect().equals(want)
    dev = [d for k, d in cpu.tables["t"].kw["scan_cache"].items() if isinstance(k, tuple) and k[0] == "dev"]
    assert {key[-1] for d in dev for key in d} == {"cpu", str(card.device)}


@pytest.fixture
def sample_table():
    return pa.table(
        {
            "id": pa.array([1, 2, 3, 4], type=pa.int64()),
            "small": pa.array([10, None, 30, 40], type=pa.int32()),
            "price": pa.array([1.5, 2.5, None, 4.0], type=pa.float64()),
            "name": pa.array(["a", "bb", None, "dd"], type=pa.string()),
            "flag": pa.array([True, False, True, None], type=pa.bool_()),
            "day": pa.array(
                [datetime.date(1994, 1, 1), None, datetime.date(1995, 6, 15), datetime.date(1996, 12, 31)],
                type=pa.date32(),
            ),
        }
    )


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_roundtrip_both_ways(tmp_path, sample_table, codec):
    """The port's writer writes the reference's bytes, and each package
    reads the other's files."""
    mine, theirs = str(tmp_path / "port.avro"), str(tmp_path / "ref.avro")
    avro.write_avro(mine, sample_table, codec=codec)
    ref_avro.write_avro(theirs, sample_table, codec=codec)
    for path in (mine, theirs):
        for read in (avro.read_avro, ref_avro.read_avro):
            back = read(path)
            assert back.schema.equals(sample_table.schema)
            assert back.to_pydict() == sample_table.to_pydict()
    assert avro.read_avro_schema(mine).equals(ref_avro.read_avro_schema(theirs))


def test_avro_multi_block_and_timestamps(tmp_path):
    n = 10_000
    t = pa.table(
        {
            "k": pa.array(range(n), type=pa.int64()),
            "v": pa.array([float(i) * 0.5 for i in range(n)]),
            "ts": pa.array([datetime.datetime(2020, 1, 1, 12) + datetime.timedelta(seconds=i) for i in range(n)],
                           type=pa.timestamp("us")),
        }
    )
    path = str(tmp_path / "big.avro")
    avro.write_avro(path, t, block_rows=1024)
    assert avro.read_avro(path).to_pydict() == t.to_pydict()


def test_avro_registration_reads_only_the_header(tmp_path, sample_table, monkeypatch):
    path = str(tmp_path / "t.avro")
    avro.write_avro(path, sample_table)

    def no_data(*a, **kw):
        raise AssertionError("registration decoded data blocks")

    monkeypatch.setattr(avro, "read_avro", no_data)
    port = TorchContext(device="cpu")
    port.register_avro("t", path)
    assert port.schema_of("t") == schema_from_arrow(sample_table.schema)
    monkeypatch.undo()
    ref, port = contexts()
    for c in (ref, port):
        c.register_avro("t", path)
    for sql in (
        "SELECT id, price FROM t WHERE name IS NOT NULL ORDER BY id",
        "SELECT COUNT(*) AS n, SUM(price) AS s, MAX(day) AS d FROM t",
        "SELECT flag, COUNT(small) AS c FROM t GROUP BY flag ORDER BY flag",
    ):
        got = port.sql(sql).collect()
        assert got.equals(ref.sql(sql).collect()), sql
    assert port.sql("SELECT id, price FROM t WHERE name IS NOT NULL ORDER BY id").collect().to_pydict() == {
        "id": [1, 2, 4], "price": [1.5, 2.5, 4.0]
    }
