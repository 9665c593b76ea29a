"""Shuffle files: the port's ``ShuffleWriterExec`` and ``ShuffleReaderExec``
(``ballista_tpu_torch/executor/``) against the reference's, on the CPU.

The writer: one input, made from a seed, goes through both writers; both
write the same relative paths, Arrow schemas and rows in the same order,
file for file, and report the same rows, batches and bytes a file. Cases:
int32, int64, f64 and string keys, nullable keys, invalid rows, K in {1, 4,
7, 64, 1500} (1500 takes the ids-and-argsort route), the three codecs, with
and without coalescing. The reader: the cases of
``tests/test_shuffle_pipeline.py``. Also the configuration keys, and the
paths that raise where the port lacks a feature.

Known reference defects kept out of the parity data: int64 values past
2^53 (the reference's host fetch rounds them) and -0.0 or non-canonical
NaN keys (its jitted routing sends them elsewhere); ROADMAP queue 3."""

import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc
import pytest
import torch

from ballista_tpu.config import _VALID as REF_ENTRIES
from ballista_tpu.config import BallistaConfig as RefConfig
from ballista_tpu.errors import ConfigError as RefConfigError
from ballista_tpu.exec.base import ExecutionPlan as RefPlan
from ballista_tpu.exec.base import TaskContext as RefTaskContext
from ballista_tpu.exec.base import UnknownPartitioning as RefUnknown
from ballista_tpu.executor.reader import ShuffleReaderExec as RefReader
from ballista_tpu.executor.shuffle import ShuffleWriterExec as RefWriter
from ballista_tpu.expr import logical as RL
from ballista_tpu.scheduler_types import PartitionLocation as RefLocation
from ballista_tpu_torch.columnar.arrow_interop import batch_to_arrow
from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.config import _ENTRIES, UNPORTED, BallistaConfig
from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.errors import ConfigError, ExecutionError, ShuffleFetchError
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, run_with_capacity_retry
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.exec.pipeline import FilterExec
from ballista_tpu_torch.executor import shuffle
from ballista_tpu_torch.executor.reader import ShuffleReaderExec, fetch_partition_table
from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec, _IpcAppender
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.ops import partition
from ballista_tpu_torch.scheduler_types import PartitionLocation
from test_torch_spill_groups import both_batches, table

SCHEMA2 = Schema([Field("k", DataType.INT64), Field("v", DataType.FLOAT64)])
ARROW2 = pa.schema([("k", pa.int64()), ("v", pa.float64())])


class _Source(ExecutionPlan):
    """Yields the given batches as input partition 0."""

    def __init__(self, batches, schema):
        super().__init__()
        self.batches, self._schema = batches, schema

    def schema(self):
        return self._schema

    def execute(self, partition, ctx):
        yield from self.batches


class _RefSource(RefPlan):
    def __init__(self, batches, schema):
        super().__init__()
        self.batches, self._schema = batches, schema

    def schema(self):
        return self._schema

    def output_partitioning(self):
        return RefUnknown(1)

    def execute(self, partition, ctx):
        yield from self.batches


def _files(root) -> dict:
    return {
        os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
        for d, _, fs in os.walk(root) for f in fs
    }


def _write_both(tmp_path, cols, k, settings=None, seeds=(0, 1), n=3000):
    """Two batches of ``table(n)`` (a tenth of the rows invalid) through
    both writers; returns (ref metas, port metas)."""
    t = table(n, seed=n + k)
    pairs = [both_batches(t, seed=s) for s in seeds]
    ref_schema = pairs[0][0].schema
    port_schema = pairs[0][1].schema
    rcfg = RefConfig()
    for key, v in (settings or {}).items():
        rcfg = rcfg.with_setting(key, v)
    ref_w = RefWriter("job", 3, _RefSource([r for r, _ in pairs], ref_schema), [RL.Column(c) for c in cols], k)
    port_w = ShuffleWriterExec("job", 3, _Source([p for _, p in pairs], port_schema), [L.Column(c) for c in cols], k)
    want = ref_w.execute_shuffle_write(0, RefTaskContext(config=rcfg, work_dir=str(tmp_path / "ref")))
    got = port_w.execute_shuffle_write(
        0, TaskContext(config=BallistaConfig(settings), device="cpu", work_dir=str(tmp_path / "port"))
    )
    return want, got


def _assert_same_files(tmp_path, want, got):
    assert [(m.partition_id, m.num_rows, m.num_batches, m.num_bytes) for m in got] == [
        (m.partition_id, m.num_rows, m.num_batches, m.num_bytes) for m in want
    ]
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port_files) == sorted(ref_files)
    for rel, path in ref_files.items():
        with paipc.open_file(pa.memory_map(path)) as r:
            w_batches = [r.get_batch(i) for i in range(r.num_record_batches)]
        with paipc.open_file(pa.memory_map(port_files[rel])) as r:
            g_batches = [r.get_batch(i) for i in range(r.num_record_batches)]
        assert len(g_batches) == len(w_batches), rel
        for g, w in zip(g_batches, w_batches):
            assert g.schema.equals(w.schema), rel
            assert g.equals(w), rel


KEYS = {
    "int64": ("k",),
    "int32-nullable": ("b",),
    "f64-nullable": ("f",),
    "string": ("u",),
    "string-nullable": ("s",),
    "int64+string+date": ("k", "s", "d"),
}


@pytest.mark.parametrize("k", [1, 4, 7, 64, 1500])
@pytest.mark.parametrize("keys", list(KEYS))
def test_writer_files_match_reference(tmp_path, keys, k):
    want, got = _write_both(tmp_path, KEYS[keys], k)
    assert sum(m.num_rows for m in got) > 0
    _assert_same_files(tmp_path, want, got)


@pytest.mark.parametrize("target_mb", ["0", "8"])
@pytest.mark.parametrize("codec", ["none", "lz4", "zstd"])
def test_writer_codecs_and_coalescing_match_reference(tmp_path, codec, target_mb):
    settings = {
        "ballista.tpu.shuffle_compression": codec,
        "ballista.tpu.shuffle_target_batch_mb": target_mb,
    }
    want, got = _write_both(tmp_path, ("k", "s"), 7, settings)
    _assert_same_files(tmp_path, want, got)


def test_unpartitioned_writer_matches_reference(tmp_path):
    """No keys: every batch's live rows go to partition 0 as they are."""
    want, got = _write_both(tmp_path, (), 1)
    assert [m.partition_id for m in got] == [0]
    _assert_same_files(tmp_path, want, got)


def test_route_above_1024_equals_the_grouped_route():
    """The ids-and-argsort route, taken above ``MAX_GROUPS`` partitions,
    groups as the kernel's grouped mode does at any K both take."""
    t = table(5003, seed=9)
    _, port = both_batches(t, seed=3)
    idxs = [t.schema.names.index(c) for c in ("k", "s")]
    for k in (1, 7, 64, partition.MAX_GROUPS):
        order, offsets = shuffle.group_rows(port, idxs, k)
        o2, off2 = shuffle.group_rows_by_ids(port, idxs, k)
        assert torch.equal(order.to(torch.int64), o2.to(torch.int64)), k
        assert torch.equal(offsets, off2), k


def test_route_follows_from_k_before_any_launch(monkeypatch):
    """Above ``MAX_GROUPS`` the writer never calls the grouped mode."""
    t = table(2000, seed=4)
    _, port = both_batches(t, seed=4)
    calls = []
    monkeypatch.setattr(
        shuffle, "batch_partition_groups",
        lambda *a, **kw: calls.append(a[2]) or partition.batch_partition_groups(*a, **kw),
    )
    shuffle.group_rows(port, [0], partition.MAX_GROUPS + 1)
    assert calls == []
    shuffle.group_rows(port, [0], partition.MAX_GROUPS)
    assert calls == [partition.MAX_GROUPS]


class _Failing(_Source):
    def __init__(self, batches, schema, fail):
        super().__init__(batches, schema)
        self.fail = fail

    def execute(self, partition, ctx):
        yield from self.batches
        self.fail(ctx)


def _one_batch():
    t = table(1000, seed=2)
    return both_batches(t, seed=2)[1]


def test_failed_attempt_leaves_no_file(tmp_path):
    """A task that fails after writing (an error, or a device check that
    fires at its end) leaves nothing under the work directory."""
    b = _one_batch()

    def boom(ctx):
        raise RuntimeError("boom")

    def check(ctx):
        ctx.defer_check(torch.tensor(True), "a device check fired")

    for fail, err in ((boom, RuntimeError), (check, ExecutionError)):
        w = ShuffleWriterExec("job", 1, _Failing([b], b.schema, fail), [L.Column("k")], 4)
        with pytest.raises(err):
            w.execute_shuffle_write(0, TaskContext(device="cpu", work_dir=str(tmp_path)))
        assert _files(tmp_path) == {}


def test_capacity_retry_rewrites_the_same_paths(tmp_path):
    """An attempt that overflows a capacity is retried by the retry loop;
    the retry writes the same paths and no file of the failed attempt
    stays."""
    b = _one_batch()
    attempts = []

    def overflow_once(ctx):
        attempts.append(ctx.agg_capacity_override)
        if len(attempts) == 1:
            ctx.defer_check(torch.tensor(True), "group capacity overflow", required=torch.tensor(5))

    w = ShuffleWriterExec("job", 1, _Failing([b], b.schema, overflow_once), [L.Column("k")], 64)
    metas = run_with_capacity_retry(
        BallistaConfig(), lambda ctx: w.execute_shuffle_write(0, ctx), device="cpu",
        work_dir=str(tmp_path), job_id="job",
    )
    assert len(attempts) == 2 and attempts[1] is not None
    assert sorted(_files(tmp_path).values()) == sorted(m.path for m in metas)
    assert sum(m.num_rows for m in metas) == int(b.valid.sum())


def test_writer_needs_a_work_dir_and_column_keys():
    b = _one_batch()
    w = ShuffleWriterExec("job", 1, _Source([b], b.schema), [L.Column("k")], 4)
    with pytest.raises(ExecutionError, match="work_dir"):
        w.execute_shuffle_write(0, TaskContext(device="cpu"))


def test_push_shuffle_raises_naming_its_item(tmp_path):
    """Where the reference pushes (a scheduler-connected executor and the
    session's push and eager keys on), the port pushes too: push metas and
    no file; with push off it writes files. (Push shuffle is ported; the
    writer no longer raises.)"""
    from ballista_tpu_torch.executor.push import REGISTRY

    b = _one_batch()
    w = ShuffleWriterExec("job", 1, _Source([b], b.schema), [L.Column("k")], 4)
    ctx = TaskContext(device="cpu", work_dir=str(tmp_path))
    ctx.shuffle_locations = lambda *a: None
    try:
        metas = w.execute_shuffle_write(0, ctx)
        assert metas and all(m.push and not os.path.exists(m.path) for m in metas)
    finally:
        REGISTRY.drop_owner(str(tmp_path))
    ctx.config = BallistaConfig({"ballista.tpu.push_shuffle": "false"})
    metas = w.execute_shuffle_write(0, ctx)
    assert metas and all(not m.push and os.path.exists(m.path) for m in metas)


# -- the reader: tests/test_shuffle_pipeline.py's cases ----------------------


def _write_file(path, start, rows, codec=None, n_batches=1):
    opts = paipc.IpcWriteOptions(compression=codec) if codec else None
    kw = {"options": opts} if opts is not None else {}
    with paipc.new_file(path, ARROW2, **kw) as w:
        for b in range(n_batches):
            lo = start + b * rows
            w.write_batch(pa.record_batch(
                [pa.array(np.arange(lo, lo + rows, dtype=np.int64)),
                 pa.array(np.arange(lo, lo + rows, dtype=np.float64))],
                schema=ARROW2,
            ))


def _loc(path, partition=0, host="127.0.0.1", push=False, port=0):
    return PartitionLocation("job", 1, partition, "e1", host, port, path, push=push)


def _ctx(**settings):
    return TaskContext(config=BallistaConfig(settings), device="cpu")


def _collect_keys(plan, ctx, partition=0):
    out = [b.columns[0][b.valid].numpy() for b in plan.execute(partition, ctx)]
    return np.concatenate(out) if out else np.array([], dtype=np.int64)


def test_mixed_codecs_in_one_partition(tmp_path):
    paths = []
    for i, codec in enumerate((None, "lz4", "zstd")):
        p = str(tmp_path / f"data-{i}.arrow")
        _write_file(p, i * 10, 10, codec=codec)
        paths.append(p)
    keys = _collect_keys(ShuffleReaderExec([[_loc(p) for p in paths]], SCHEMA2), _ctx())
    assert keys.tolist() == list(range(30))
    for i, p in enumerate(paths):
        assert fetch_partition_table(_loc(p)).column("k").to_pylist() == list(range(i * 10, i * 10 + 10))


def test_zero_row_upstream_output(tmp_path):
    empty = str(tmp_path / "data-0.arrow")
    with paipc.new_file(empty, ARROW2):
        pass  # schema-only file, no batches
    nonempty = str(tmp_path / "data-1.arrow")
    _write_file(nonempty, 0, 5)
    plan = ShuffleReaderExec([[_loc(empty), _loc(nonempty)]], SCHEMA2)
    assert _collect_keys(plan, _ctx()).tolist() == [0, 1, 2, 3, 4]
    batches = list(ShuffleReaderExec([[]], SCHEMA2).execute(0, _ctx()))
    assert len(batches) == 1 and int(batches[0].count_valid()) == 0
    assert batches[0].schema == SCHEMA2


def test_empty_batch_string_column_carries_dictionary():
    schema = Schema([Field("name", DataType.STRING)])
    empty = DeviceBatch.empty(schema, device="cpu")
    assert "name" in empty.dictionaries and len(empty.dictionaries["name"]) == 0
    f = FilterExec(
        _Source([empty], schema),
        L.BinaryExpr(L.Column("name"), L.Operator.EQ, L.Literal("x", DataType.STRING)),
    )
    assert sum(int(b.count_valid()) for b in f.execute(0, _ctx())) == 0


def test_appender_zero_writes(tmp_path):
    path = str(tmp_path / "data-9.arrow")
    assert _IpcAppender(path).close() == (0, 0, 0, False)
    assert _IpcAppender(path, options=paipc.IpcWriteOptions(compression="lz4")).close() == (0, 0, 0, False)
    assert not os.path.exists(path)


def _six_files(tmp_path, rows=100, n_batches=3):
    paths = []
    for i in range(6):
        p = str(tmp_path / f"data-{i}.arrow")
        _write_file(p, i * rows * n_batches, rows, n_batches=n_batches)
        paths.append(p)
    return [[_loc(p) for p in paths]]


def test_overlapped_fetch_bit_identical_to_sequential(tmp_path):
    locs = _six_files(tmp_path)
    seq = _collect_keys(ShuffleReaderExec(locs, SCHEMA2), _ctx(**{"ballista.tpu.shuffle_fetch_concurrency": "0"}))
    conc = _collect_keys(ShuffleReaderExec(locs, SCHEMA2), _ctx(**{"ballista.tpu.shuffle_fetch_concurrency": "4"}))
    assert seq.tolist() == conc.tolist() == list(range(1800))
    ref_locs = [[RefLocation(l.job_id, l.stage_id, l.partition, l.executor_id, l.host, l.port, l.path) for l in locs[0]]]
    ref_keys = [
        np.asarray(b.columns[0])[np.asarray(b.valid)]
        for b in RefReader(ref_locs, _ref_schema2()).execute(0, RefTaskContext())
    ]
    assert np.concatenate(ref_keys).tolist() == seq.tolist()


def _ref_schema2():
    from ballista_tpu.datatypes import DataType as RD, Field as RF, Schema as RS

    return RS([RF("k", RD.INT64), RF("v", RD.FLOAT64)])


def test_overlapped_fetch_metrics(tmp_path):
    paths = []
    for i in range(4):
        p = str(tmp_path / f"data-{i}.arrow")
        _write_file(p, i * 10, 10)
        paths.append(p)
    plan = ShuffleReaderExec([[_loc(p) for p in paths]], SCHEMA2)
    _collect_keys(plan, _ctx(**{"ballista.tpu.shuffle_fetch_concurrency": "3"}))
    c = plan.metrics.counters
    assert c["fetched_batches"] == 4 and c["fetched_bytes"] > 0
    assert c.get("fetch_overlap_hits", 0) + c.get("fetch_overlap_misses", 0) >= 4


@pytest.mark.parametrize("conc", ["0", "4"])
def test_corrupt_file_raises_a_non_transient_fetch_error(tmp_path, conc):
    good = str(tmp_path / "data-0.arrow")
    _write_file(good, 0, 10)
    bad = str(tmp_path / "data-1.arrow")
    with open(bad, "wb") as f:
        f.write(b"ARROW1\x00\x00garbage-not-an-ipc-file")
    plan = ShuffleReaderExec([[_loc(good), _loc(bad, partition=0)]], SCHEMA2)
    got = []
    with pytest.raises(ShuffleFetchError) as ei:
        for b in plan.execute(0, _ctx(**{"ballista.tpu.shuffle_fetch_concurrency": conc})):
            got.extend(b.columns[0][b.valid].tolist())
    assert ei.value.transient is False
    assert (ei.value.stage_id, ei.value.executor_id) == (1, "e1")
    assert got in ([], list(range(10)))
    with pytest.raises(ShuffleFetchError):
        fetch_partition_table(_loc(bad))


def test_overlapped_fetch_early_stop_joins_workers(tmp_path):
    locs = _six_files(tmp_path, rows=50, n_batches=4)
    before = {t.name for t in threading.enumerate()}
    it = ShuffleReaderExec(locs, SCHEMA2).execute(0, _ctx(**{"ballista.tpu.batch_rows": "50"}))
    next(it)
    it.close()
    leaked = {t.name for t in threading.enumerate()} - before
    assert not {n for n in leaked if n.startswith("shuffle-fetch")}, leaked


def test_reader_rechunks_without_narrowing(tmp_path):
    """Batches of at most the row budget, int64 kept int64 though every
    value fits int32, on the task's device."""
    locs = _six_files(tmp_path, rows=70, n_batches=2)
    batches = list(ShuffleReaderExec(locs, SCHEMA2).execute(0, _ctx(**{"ballista.tpu.batch_rows": "100"})))
    # two 70-row batches reach the budget, and their 140 rows upload as
    # batches of 100 and 40 (the reference's flush)
    assert [int(b.count_valid()) for b in batches] == [100, 40] * 6
    assert all(b.columns[0].dtype == torch.int64 and b.device.type == "cpu" for b in batches)
    assert pa.Table.from_batches([batch_to_arrow(b) for b in batches]).column("k").to_pylist() == list(range(840))


def test_remote_and_push_locations_raise_naming_their_item(tmp_path):
    """Locations that are not local files go over Flight now (the Flight
    fetch and push shuffle are ported): a file whose producer is
    unreachable, or a push stream that is neither in this process nor on
    disk, is a ShuffleFetchError naming the producer; with the local fast
    path off, a local file is read through its producer's Flight
    service."""
    import socket

    from ballista_tpu_torch.executor.flight_service import start_flight_server

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        closed_port = sock.getsockname()[1]
    ctx = _ctx(**{"ballista.tpu.fetch_retries": "1"})
    for loc in (
        _loc(str(tmp_path / "elsewhere.arrow"), port=closed_port),
        _loc(str(tmp_path / "x.arrow"), port=closed_port, push=True),
    ):
        with pytest.raises(ShuffleFetchError, match=f"127.0.0.1:{closed_port}"):
            list(ShuffleReaderExec([[loc]], SCHEMA2).execute(0, ctx))
        with pytest.raises(ShuffleFetchError, match=f"127.0.0.1:{closed_port}"):
            fetch_partition_table(loc)
    p = str(tmp_path / "data-0.arrow")
    _write_file(p, 0, 3)
    svc, port, t = start_flight_server("127.0.0.1", 0, str(tmp_path))
    try:
        got = list(ShuffleReaderExec([[_loc(p, port=port)]], SCHEMA2).execute(
            0, _ctx(**{"ballista.tpu.shuffle_local_fastpath": "false"})
        ))
        assert got[0].columns[0][got[0].valid].tolist() == [0, 1, 2]
    finally:
        svc.shutdown()
        t.join(timeout=10)


# -- configuration ----------------------------------------------------------

SAMPLES = {
    bool: ["true", "FALSE", "1", "no", "maybe"],
    int: ["0", "17", "-3", "1.5", "x"],
    float: ["0", "2.5", "-1", "nan", "x"],
}


def test_every_reference_key_is_known_with_its_default():
    assert set(_ENTRIES) == set(REF_ENTRIES)
    for key, e in REF_ENTRIES.items():
        assert _ENTRIES[key][0] == e.default, key
        assert _ENTRIES[key][1](e.default) == e.parse(e.default), key


@pytest.mark.parametrize("key", sorted(REF_ENTRIES))
def test_every_reference_key_parses_as_the_reference(key):
    """Defaults and sample values parse to the reference's values, and a
    value the reference refuses the port refuses with the same message."""
    e = REF_ENTRIES[key]
    values = {
        "ballista.tpu.shuffle_compression": ["LZ4", "zstd", "auto", "snappy"],
        "ballista.tpu.prewarm": ["on", "Background", "always"],
        "ballista.tpu.trace": ["OFF", "On", "/tmp/t.jsonl", ""],
        "ballista.tpu.metrics_collector": ["logging", "Shipping", "nope"],
        "ballista.tpu.capacity_buckets": ["4096:4", "2048,8192", "4096", "1024:2", "2048:1", "x", "16,2048"],
    }.get(key)
    if values is None:
        kind = type(e.parse(e.default))
        values = SAMPLES.get(kind, ["", "abc", "/some/dir"])
    for v in [e.default, *values]:
        try:
            want = RefConfig({key: v})._get(key)
        except RefConfigError as err:
            with pytest.raises(ConfigError) as got:
                BallistaConfig({key: v})
            assert str(got.value) == str(err), (key, v)
            continue
        got = BallistaConfig({key: v})._get(key)
        assert got == want or (got != got and want != want), (key, v)  # nan parses to nan
    with pytest.raises(ConfigError, match="unknown configuration key"):
        BallistaConfig({key + ".typo": e.default})


NON_DEFAULT = {
    "ballista.plugin_dir": "/plugins",
    "ballista.with_information_schema": "true",
    "ballista.tpu.capacity_buckets": "4096:2",
    "ballista.parquet.pruning": "false",
    "ballista.tpu.scan_stream_mb": "0",
    "ballista.tpu.prefetch_depth": "0",
    "ballista.tpu.build_cache_mb": "0",
    "ballista.tpu.profile_dir": "/tmp/prof",
    "ballista.tpu.trace": "on",
    "ballista.tpu.prewarm": "on",
    "ballista.tpu.collective_shuffle": "false",
    "ballista.tpu.aqe": "true",
}


# keys whose features have been ported since: the non-default value is
# accepted, as the reference accepts it, and honoured
PORTED_SINCE = {
    "ballista.with_information_schema",
    "ballista.parquet.pruning",
    "ballista.tpu.scan_stream_mb",
    "ballista.tpu.prefetch_depth",
    "ballista.tpu.capacity_buckets",
    "ballista.tpu.aqe",
    "ballista.plugin_dir",
    "ballista.tpu.build_cache_mb",
    "ballista.tpu.profile_dir",
    "ballista.tpu.trace",
    "ballista.tpu.prewarm",
    "ballista.tpu.collective_shuffle",
}


def _file_scan_counters(tmp_path, settings: dict) -> dict:
    """Counters of one query over a sorted 4-row-group Parquet file (1.6 MB
    of int64) that streams one row group a slice above 1 MB."""
    import pyarrow.parquet as papq

    from ballista_tpu_torch.exec.base import plan_counters
    from ballista_tpu_torch.exec.scan import ParquetScanExec

    path = tmp_path / "t.parquet"
    if not path.exists():
        papq.write_table(pa.table({"k": pa.array(np.arange(200_000, dtype=np.int64))}), path, row_group_size=50_000)
    ctx = TorchContext(BallistaConfig({"ballista.shuffle.partitions": "1", **settings}), device="cpu")
    ctx.register_parquet("t", str(path))
    old = ParquetScanExec.STREAM_SLICE_BYTES
    ParquetScanExec.STREAM_SLICE_BYTES = 1
    try:
        got, phys = ctx.sql("SELECT COUNT(*) AS c, SUM(k) AS s FROM t WHERE k < 120000").collect_with_plan()
    finally:
        ParquetScanExec.STREAM_SLICE_BYTES = old
    assert got.column("c").to_pylist() == [120_000]
    return plan_counters(phys, ("row_groups_pruned", "stream_slices", "prefetch_hits", "prefetch_misses"))


def _ref_context(cfg: BallistaConfig):
    from ballista_tpu.exec.context import TpuContext

    return TpuContext(RefConfig(cfg.settings()))


def _honoured(key: str, cfg: BallistaConfig, tmp_path) -> None:
    if key == "ballista.tpu.collective_shuffle":
        # at 8 shards the default plans the mesh operators and false plans
        # the local ones
        sql = "SELECT x, COUNT(*) AS c FROM t GROUP BY x"
        old = os.environ.get("BALLISTA_TPU_MESH_SHARDS")
        os.environ["BALLISTA_TPU_MESH_SHARDS"] = "8"
        try:
            disps = []
            for c in (cfg, BallistaConfig()):
                ctx = TorchContext(c, device="cpu")
                ctx.register_table("t", pa.table({"x": [1, 2, 2, 3]}))
                disps.append(ctx.create_physical_plan(ctx.sql_to_logical(sql)).display())
                assert ctx.sql(sql + " ORDER BY x").collect().to_pydict() == {
                    "x": [1, 2, 3], "c": [1, 2, 1]
                }
        finally:
            if old is None:
                os.environ.pop("BALLISTA_TPU_MESH_SHARDS")
            else:
                os.environ["BALLISTA_TPU_MESH_SHARDS"] = old
        assert "Mesh" not in disps[0] and "HashAggregateExec" in disps[0], disps[0]
        assert "MeshAggregateExec" in disps[1], disps[1]
    elif key == "ballista.tpu.profile_dir":
        # a context takes the key; a task attempt under it writes one
        # TensorBoard trace into the directory (in tmp_path here)
        TorchContext(cfg, device="cpu")
        prof = tmp_path / "prof"
        run_with_capacity_retry(BallistaConfig({key: str(prof)}), lambda ctx: None, device="cpu")
        assert [f.name.endswith(".pt.trace.json") for f in prof.iterdir()] == [True]
    elif key == "ballista.tpu.trace":
        # EXPLAIN ANALYZE records its span on both engines
        from ballista_tpu.obs import trace as ref_trace
        from ballista_tpu_torch.obs import trace

        try:
            names = []
            for c, mod in ((_ref_context(cfg), ref_trace), (TorchContext(cfg, device="cpu"), trace)):
                c.register_table("t", pa.table({"x": [1, 2, 3]}))
                c.sql("EXPLAIN ANALYZE SELECT SUM(x) FROM t").collect()
                names.append(mod.snapshot()[-1].name)
            assert names == ["explain_analyze", "explain_analyze"]
        finally:
            trace.configure("off")
            ref_trace.configure("off")
    elif key == "ballista.tpu.prewarm":
        # the context runs its prewarm on its device (bounded to one bucket)
        from ballista_tpu_torch.compilecache import metrics, prewarm

        prewarm.reset_latch()
        os.environ["BALLISTA_TPU_PREWARM_BUCKETS"] = "2048"
        try:
            base = metrics.snapshot().get("prewarmed_signatures", 0)
            port = TorchContext(cfg, device="cpu")
            assert port._prewarm.n_signatures == 19
            assert metrics.snapshot()["prewarmed_signatures"] - base == 19
        finally:
            os.environ.pop("BALLISTA_TPU_PREWARM_BUCKETS", None)
            prewarm.reset_latch()
    elif key == "ballista.with_information_schema":
        # the reference reads the key nowhere; SHOW works whatever its value
        ref = _ref_context(cfg)
        port = TorchContext(cfg, device="cpu")
        assert port.config.with_information_schema() is True
        for c in (ref, port):
            c.register_table("t", pa.table({"x": [1]}))
        assert port.sql("SHOW TABLES").collect().equals(ref.sql("SHOW TABLES").collect())
    elif key == "ballista.parquet.pruning":
        assert _file_scan_counters(tmp_path, {})["row_groups_pruned"] == 1
        assert _file_scan_counters(tmp_path, {key: NON_DEFAULT[key]})["row_groups_pruned"] == 0
    elif key == "ballista.tpu.capacity_buckets":
        # both contexts install the session's ladder; a 3000-row table
        # scans into one batch of the same capacity in both
        from ballista_tpu.columnar.batch import capacity_ladder as ref_ladder
        from ballista_tpu.columnar.batch import set_capacity_buckets as ref_set_buckets
        from ballista_tpu_torch.columnar.batch import capacity_ladder, set_capacity_buckets

        specs = ref_ladder().spec(), capacity_ladder().spec()
        try:
            ref = _ref_context(cfg)
            port = TorchContext(cfg, device="cpu")
            assert capacity_ladder().spec() == ref_ladder().spec() == NON_DEFAULT[key]
            t = pa.table({"x": pa.array(np.arange(3000, dtype=np.int64))})
            caps = []
            for c in (ref, port):
                c.register_table("t", t)
                plan = c.create_physical_plan(c.sql_to_logical("SELECT x FROM t"))
                caps.append([b.capacity for b in plan.execute(0, TaskContext(device="cpu") if c is port else RefTaskContext())])
            assert caps[0] == caps[1] == [4096]
        finally:
            ref_set_buckets(specs[0])
            set_capacity_buckets(specs[1])
    elif key == "ballista.tpu.aqe":
        # a context accepts the key as the reference's does, and narrates
        # the policy as on in EXPLAIN ANALYZE; a cluster with it learns a
        # strategy on a query's first run and applies it on the second
        from ballista_tpu.scheduler import aqe as ref_aqe
        from ballista_tpu_torch.client.context import BallistaContext
        from ballista_tpu_torch.scheduler import aqe

        ref, port = _ref_context(cfg), TorchContext(cfg, device="cpu")
        assert port.config.aqe() is ref.config.aqe() is True
        t = pa.table({"k": np.arange(200) % 7, "v": np.arange(200, dtype=np.float64)})
        sql = "SELECT k, SUM(v) AS s FROM t GROUP BY k"
        rows = []
        for c in (ref, port):
            c.register_table("t", t)
            out = c.sql(f"EXPLAIN ANALYZE {sql}").collect().to_pydict()
            rows.append(dict(zip(out["plan_type"], out["plan"]))["aqe"])
        assert rows[0] == rows[1] and rows[1].startswith("aqe=on class=")
        aqe.reset_store()
        ref_aqe.reset_store()
        ctx = BallistaContext.standalone(
            BallistaConfig({**cfg.settings(), "ballista.shuffle.partitions": "4"}), device="cpu"
        )
        try:
            ctx.register_table("t", t)
            sched = ctx._standalone_cluster.scheduler
            results, outcomes = [], []
            for _ in range(2):
                results.append(ctx.sql(sql).collect().sort_by("k"))
                with sched._lock:
                    job = max(sched.jobs.values(), key=lambda j: j.submitted_s)
                outcomes.append({d["outcome"] for d in job.aqe_decisions})
            assert outcomes == [{"learned"}, {"applied"}]
            assert results[0].column("k").equals(results[1].column("k"))
            np.testing.assert_allclose(results[1].column("s").to_numpy(), results[0].column("s").to_numpy(), rtol=1e-9)
        finally:
            ctx.close()
            aqe.reset_store()
    elif key == "ballista.plugin_dir":
        # a directory that does not exist loads nothing (and is not cached:
        # it may be mounted later); one with a plugin is loaded by a
        # context, whose SQL then calls the UDF as the reference's does
        from ballista_tpu.plugin import global_registry as ref_registry
        from ballista_tpu_torch.plugin import global_registry

        TorchContext(cfg, device="cpu")
        dirs = {}
        for side, lib in (("port", "torch"), ("ref", "jax.numpy")):
            d = dirs[side] = tmp_path / f"plugins-{side}"
            d.mkdir()
            (d / "cfg_fns.py").write_text(
                f"import {lib} as m\n\ndef register(register_udf):\n"
                "    register_udf('config_key_udf', lambda x: m.sqrt(x))\n"
            )
        try:
            ref = _ref_context(BallistaConfig({key: str(dirs["ref"])}))
            port = TorchContext(BallistaConfig({key: str(dirs["port"])}), device="cpu")
            t = pa.table({"x": pa.array([1.0, 4.0, 9.0])})
            got = []
            for c in (ref, port):
                c.register_table("t", t)
                got.append(c.sql("SELECT config_key_udf(x) AS r FROM t").collect())
            assert got[0].equals(got[1]) and got[1].column("r").to_pylist() == [1.0, 2.0, 3.0]
        finally:
            global_registry.clear()
            ref_registry.clear()
    elif key == "ballista.tpu.build_cache_mb":
        # 0 keeps no join build table; the default keeps one (a plan's
        # counters, as the reference's)
        from ballista_tpu.exec.base import plan_counters as ref_plan_counters
        from ballista_tpu_torch.exec.base import plan_counters

        t = pa.table({"k": pa.array(np.arange(300, dtype=np.int64) % 50), "v": pa.array(np.arange(300, dtype=np.int64))})
        d = pa.table({"k": pa.array(np.arange(50, dtype=np.int64)), "w": pa.array(np.arange(50, dtype=np.int64) * 3)})
        sql = "SELECT COUNT(*) AS c, SUM(d.w) AS w FROM t JOIN d ON t.k = d.k"
        for settings, stored in (({key: NON_DEFAULT[key]}, 0), ({}, 1)):
            c = BallistaConfig({"ballista.shuffle.partitions": "1", **settings})
            got = []
            for ctx, counters in ((_ref_context(c), ref_plan_counters), (TorchContext(c, device="cpu"), plan_counters)):
                ctx.register_table("t", t)
                ctx.register_table("d", d)
                out, plan = ctx.sql(sql).collect_with_plan()
                got.append((out.to_pydict(), counters(plan, ("build_cache_store",))["build_cache_store"]))
            assert got[0] == got[1] == ({"c": [300], "w": [3 * 6 * 1225]}, stored)
    elif key == "ballista.tpu.scan_stream_mb":
        assert _file_scan_counters(tmp_path, {key: "1"})["stream_slices"] == 3
        assert _file_scan_counters(tmp_path, {key: NON_DEFAULT[key]})["stream_slices"] == 0
    else:
        streamed = {"ballista.tpu.scan_stream_mb": "1"}
        c = _file_scan_counters(tmp_path, streamed)
        assert c["prefetch_hits"] + c["prefetch_misses"] == 3
        c = _file_scan_counters(tmp_path, {**streamed, key: NON_DEFAULT[key]})
        assert c["prefetch_hits"] + c["prefetch_misses"] == 0 and c["stream_slices"] == 3


def test_non_default_cases_cover_every_key():
    assert set(NON_DEFAULT) == set(UNPORTED) | PORTED_SINCE
    assert not PORTED_SINCE & set(UNPORTED)


@pytest.mark.parametrize("key", sorted(NON_DEFAULT))
def test_unported_feature_key_raises_at_its_point_of_use(key, tmp_path):
    """A non-default value of a key whose feature is not ported raises
    where the reference would read it, naming the ROADMAP item; its
    default passes. A key ported since is accepted and honoured."""
    cfg = BallistaConfig({key: NON_DEFAULT[key]})
    if key in PORTED_SINCE:
        _honoured(key, cfg, tmp_path)
        return
    item = UNPORTED[key].split(" (")[0]
    with pytest.raises(ConfigError, match=item):
        if key == "ballista.tpu.profile_dir":
            run_with_capacity_retry(cfg, lambda ctx: None, device="cpu")
        else:
            TorchContext(cfg, device="cpu")
    default = BallistaConfig({key: _ENTRIES[key][0]})
    TorchContext(default, device="cpu")
    run_with_capacity_retry(default, lambda ctx: None, device="cpu")


def test_staged_path_on_cuda_raises_without_a_card():
    """No fallback: a task context on the card refuses to start where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    b = _one_batch()
    w = ShuffleWriterExec("job", 1, _Source([b], b.schema), [L.Column("k")], 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_with_capacity_retry(BallistaConfig(), lambda ctx: w.execute_shuffle_write(0, ctx), work_dir="/tmp")


@pytest.mark.gpu
def test_writer_and_reader_on_card_match_cpu(tmp_path):
    """On the card the writer groups with the kernel and copies each batch
    to the host once; slices that wait in a coalescer across batches must
    keep their rows. Its files equal the CPU's, and the reader uploads them
    to the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    t = table(30_000, seed=7)
    batches = [both_batches(t, seed=s)[1] for s in range(4)]
    metas = {}
    for dev in ("cpu", "cuda"):
        src = _Source([b if dev == "cpu" else _to(b, dev) for b in batches], batches[0].schema)
        w = ShuffleWriterExec("job", 2, src, [L.Column("k"), L.Column("s")], 7)
        metas[dev] = w.execute_shuffle_write(0, TaskContext(device=dev, work_dir=str(tmp_path / dev)))
    assert [(m.partition_id, m.num_rows) for m in metas["cuda"]] == [
        (m.partition_id, m.num_rows) for m in metas["cpu"]
    ]
    for a, b in zip(metas["cpu"], metas["cuda"]):
        assert fetch_partition_table(_loc(b.path)).equals(fetch_partition_table(_loc(a.path)))
    locs = [[_loc(m.path) for m in metas["cuda"]]]
    on_card = list(ShuffleReaderExec(locs, batches[0].schema).execute(0, TaskContext(device="cuda")))
    assert all(b.device.type == "cuda" for b in on_card)
    got = pa.Table.from_batches([batch_to_arrow(b) for b in on_card])
    assert got.equals(pa.concat_tables([fetch_partition_table(_loc(m.path)) for m in metas["cpu"]]))


def _to(b: DeviceBatch, dev: str) -> DeviceBatch:
    return DeviceBatch(
        schema=b.schema, columns=tuple(c.to(dev) for c in b.columns), valid=b.valid.to(dev),
        nulls=tuple(None if m is None else m.to(dev) for m in b.nulls), dictionaries=b.dictionaries,
    )
