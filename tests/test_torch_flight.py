"""The port's Arrow Flight data plane against the reference's, on the CPU:
the port's service serves a file the port's shuffle writer wrote to the
reference's client, and the reference's service serves one to the port's
client, batch for batch; push streams cross ``do_exchange`` both ways;
path containment refuses an escaping ticket; the port's reader sends every
read through Flight when the local fast path is off; the connection-pool
cases of ``tests/test_flight_pool.py`` hold for the port's pool; and the
backoff schedule is the reference's."""

import dataclasses
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc
import pytest

import ballista_tpu_torch.client.flight as flight
from ballista_tpu.client.flight import backoff_s as ref_backoff_s
from ballista_tpu.client.flight import fetch_partition_batches as ref_fetch
from ballista_tpu.client.flight import fetch_push_batches as ref_fetch_push
from ballista_tpu.executor.flight_service import start_flight_server as ref_start_flight_server
from ballista_tpu.executor.push import REGISTRY as REF_REGISTRY
from ballista_tpu.scheduler_types import PartitionLocation as RefLocation
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import ShuffleFetchError
from ballista_tpu_torch.exec.base import TaskContext
from ballista_tpu_torch.exec.scan import MemoryScanExec
from ballista_tpu_torch.columnar.arrow_interop import schema_from_arrow
from ballista_tpu_torch.executor.flight_service import start_flight_server
from ballista_tpu_torch.executor.push import REGISTRY, stream_key
from ballista_tpu_torch.executor.reader import ShuffleReaderExec
from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.scheduler_types import PartitionLocation


@pytest.fixture()
def servers(tmp_path):
    """A port and a reference Flight service, each over its own work dir."""
    out = {}
    started = []
    for side, start in (("port", start_flight_server), ("reference", ref_start_flight_server)):
        work = tmp_path / side
        work.mkdir()
        svc, port, t = start("127.0.0.1", 0, str(work))
        started.append((svc, t))
        out[side] = (str(work), port)
    yield out
    for svc, t in started:
        svc.shutdown()
        t.join(timeout=10)


def _table(n=5000, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 97, n).astype(np.int64),
        "v": rng.uniform(-1, 1, n),
        "s": pa.array([f"item-{i % 13}" for i in range(n)]),
    })


def _write(work: str, job: str) -> list:
    """The port's shuffle writer's files of one task (K = 4), as metas."""
    t = _table()
    scan = MemoryScanExec(t, schema_from_arrow(t.schema), partitions=1)
    cfg = BallistaConfig({"ballista.tpu.shuffle_target_batch_mb": "0"})
    return ShuffleWriterExec(job, 1, scan, [L.col("k")], 4).execute_shuffle_write(
        0, TaskContext(config=cfg, work_dir=work, device="cpu")
    )


def _loc(cls, m, job, port, **kw):
    return cls(job, 1, m.partition_id, "e-1", "127.0.0.1", port, m.path, **kw)


def _read_file(path):
    with pa.memory_map(path) as src:
        return paipc.open_file(src).read_all()


@pytest.mark.parametrize("server", ["port", "reference"])
def test_do_get_serves_the_port_writers_files_both_ways(servers, server):
    """Port service -> reference client, reference service -> port client:
    every bucket file of a port-written task comes back as the file's
    batches, and the reference's client reads it as the port's does."""
    work, port = servers[server]
    job = f"jget-{server}"
    metas = _write(work, job)
    assert len(metas) == 4
    for m in metas:
        want = _read_file(m.path)
        if server == "port":
            got = list(ref_fetch(_loc(RefLocation, m, job, port), compression="none"))
            also = list(flight.fetch_partition_batches(_loc(PartitionLocation, m, job, port)))
            assert pa.Table.from_batches(also).equals(want)
        else:
            got = list(flight.fetch_partition_batches(_loc(PartitionLocation, m, job, port)))
        assert sum(b.num_rows for b in got) == m.num_rows
        assert pa.Table.from_batches(got).equals(want)


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_compressed_stream_is_the_same_batches(servers, codec):
    work, port = servers["port"]
    metas = _write(work, f"jc-{codec}")
    for m in metas:
        got = list(flight.fetch_partition_batches(_loc(PartitionLocation, m, f"jc-{codec}", port), compression=codec))
        assert pa.Table.from_batches(got).equals(_read_file(m.path))


def test_fetch_partition_materializes_the_file(servers):
    work, port = servers["port"]
    metas = _write(work, "jt")
    for m in metas:
        assert flight.fetch_partition(_loc(PartitionLocation, m, "jt", port)).equals(_read_file(m.path))


@pytest.mark.parametrize("server", ["port", "reference"])
def test_do_exchange_of_a_push_stream_both_ways(servers, server):
    """A stream committed in the serving side's registry crosses
    do_exchange to the other side's client: the same batches, from memory."""
    work, port = servers[server]
    key = (f"jx-{server}", 2, 1, 0)
    path = os.path.join(work, key[0], "2", "0", "push-1.arrow")
    reg = REGISTRY if server == "port" else REF_REGISTRY
    s = reg.open(key, path, work, None)
    batches = [b for b in _table(300).to_batches(max_chunksize=100)]
    for b in batches:
        reg.append(s, b, 1 << 30)
    reg.seal(s)
    fallbacks = []
    try:
        if server == "port":
            loc = RefLocation(key[0], 2, 0, "e-1", "127.0.0.1", port, path, push=True, map_partition=1)
            got = list(ref_fetch_push(loc, on_fallback=lambda: fallbacks.append(1)))
        else:
            loc = PartitionLocation(key[0], 2, 0, "e-1", "127.0.0.1", port, path, push=True, map_partition=1)
            got = list(flight.fetch_push_batches(loc, on_fallback=lambda: fallbacks.append(1)))
        assert pa.Table.from_batches(got).equals(pa.Table.from_batches(batches))
        assert not fallbacks and not os.path.exists(path)
    finally:
        reg.drop_owner(work)


@pytest.mark.parametrize("path", ["/etc/passwd", "{work}/../outside.arrow"])
def test_containment_rejects_an_escaping_ticket(servers, tmp_path, path):
    work, port = servers["port"]
    (tmp_path / "outside.arrow").write_bytes(b"x")
    loc = PartitionLocation("j", 1, 0, "e-1", "127.0.0.1", port, path.format(work=work))
    with pytest.raises(ShuffleFetchError, match="escapes the executor shuffle root") as ei:
        list(flight.fetch_partition_batches(loc, retries=1))
    assert ei.value.transient is False and ei.value.executor_id == "e-1"


def test_missing_file_is_a_nontransient_fetch_error(servers):
    work, port = servers["port"]
    loc = PartitionLocation("jm", 3, 1, "e-9", "127.0.0.1", port, os.path.join(work, "jm", "3", "1", "data-0.arrow"))
    with pytest.raises(ShuffleFetchError) as ei:
        list(flight.fetch_partition_batches(loc, retries=2, backoff_ms=1))
    assert ei.value.transient is False and (ei.value.stage_id, ei.value.partition) == (3, 1)


def test_unreachable_executor_is_a_transient_fetch_error():
    """Connection refused: retried, then a transient ShuffleFetchError
    naming the producer."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    loc = PartitionLocation("ju", 2, 0, "e-7", "127.0.0.1", port, "/w/ju/2/0/data-0.arrow")
    with pytest.raises(ShuffleFetchError) as ei:
        list(flight.fetch_partition_batches(loc, retries=2, backoff_ms=1, timeout_s=5))
    assert ei.value.transient is True and ei.value.executor_id == "e-7"
    flight.close_pool()


def test_reader_without_the_local_fast_path_reads_over_flight(servers):
    """``shuffle_local_fastpath=false``: the reader fetches a local file
    through the producer's Flight service and yields what the local path
    yields."""
    from ballista_tpu_torch.executor import reader

    work, port = servers["port"]
    metas = _write(work, "jr")
    schema = schema_from_arrow(_table().schema)
    locs = [[_loc(PartitionLocation, m, "jr", port) for m in metas]]

    def keys(fastpath: str):
        ctx = TaskContext(config=BallistaConfig({"ballista.tpu.shuffle_local_fastpath": fastpath}), device="cpu")
        before = reader.stats["flight_batches"]
        out = np.concatenate([b.columns[0][b.valid].numpy() for b in ShuffleReaderExec(locs, schema).execute(0, ctx)])
        return out, reader.stats["flight_batches"] - before

    local, n_local = keys("true")
    remote, n_remote = keys("false")
    assert n_local == 0 and n_remote == sum(m.num_batches for m in metas)
    assert np.array_equal(local, remote)


def test_backoff_is_the_references():
    for attempt in range(6):
        for backoff_ms in (0, 1, 50, 1000):
            for stage in (1, 7):
                args = ("job", stage, 3, "e", "h", 1, "/p")
                assert flight.backoff_s(PartitionLocation(*args), attempt, backoff_ms) == ref_backoff_s(
                    RefLocation(*args), attempt, backoff_ms
                )


def test_ticket_is_the_references():
    from ballista_tpu.client.flight import make_ticket as ref_make_ticket

    args = ("job", 4, 2, "e", "h", 9, "/w/job/4/2/data-1.arrow")
    for kw in ({}, {"push": True, "map_partition": 1}):
        for compression, trace in (("", None), ("lz4", ("t" * 32, "s" * 16))):
            got = flight.make_ticket(PartitionLocation(*args, **kw), compression, trace)
            want = ref_make_ticket(RefLocation(*args, **kw), compression, trace)
            assert got.ticket == want.ticket


# -- the pool (tests/test_flight_pool.py's cases) -----------------------------


class _FakeClient:
    def __init__(self, name="c"):
        self.name = name
        self.closed = False

    def close(self):
        self.closed = True


def _clean_pool():
    with flight._POOL_LOCK:
        flight._POOL.clear()


def test_evict_removes_without_closing_inflight_client():
    _clean_pool()
    c = _FakeClient()
    with flight._POOL_LOCK:
        flight._POOL[("h", 1)] = c
    flight._evict("h", 1, c)
    assert ("h", 1) not in flight._POOL and not c.closed


def test_evict_ignores_stale_client():
    _clean_pool()
    stale, fresh = _FakeClient("stale"), _FakeClient("fresh")
    with flight._POOL_LOCK:
        flight._POOL[("h", 1)] = fresh
    flight._evict("h", 1, stale)
    assert flight._POOL[("h", 1)] is fresh and not fresh.closed and not stale.closed


def test_client_for_dials_outside_lock_and_closes_race_loser(monkeypatch):
    _clean_pool()
    dialed = []

    def fake_connect(uri):
        c = _FakeClient(uri)
        dialed.append(c)
        if len(dialed) == 1:
            with flight._POOL_LOCK:
                flight._POOL[("h", 1)] = _FakeClient("winner")
        return c

    monkeypatch.setattr(flight.paflight, "connect", fake_connect)
    got = flight._client_for("h", 1)
    assert got.name == "winner" and dialed[0].closed
    assert flight._client_for("h", 1) is got and len(dialed) == 1
    _clean_pool()


def test_close_pool_closes_every_cached_client():
    _clean_pool()
    cs = [_FakeClient(str(i)) for i in range(3)]
    with flight._POOL_LOCK:
        for i, c in enumerate(cs):
            flight._POOL[("h", i)] = c
    flight.close_pool()
    assert all(c.closed for c in cs) and not flight._POOL


def test_concurrent_client_for_returns_single_cached_client(monkeypatch):
    _clean_pool()
    dial_count = []
    gate = threading.Event()

    def slow_connect(uri):
        gate.wait(timeout=5)
        c = _FakeClient(uri)
        dial_count.append(c)
        return c

    monkeypatch.setattr(flight.paflight, "connect", slow_connect)
    got = []
    lock = threading.Lock()

    def worker():
        c = flight._client_for("h", 9)
        with lock:
            got.append(c)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 4 and len({id(c) for c in got}) == 1
    shared = got[0]
    assert not shared.closed and all(c.closed for c in dial_count if c is not shared)
    _clean_pool()


def test_location_fields_are_the_references():
    fields = [f.name for f in dataclasses.fields(PartitionLocation)]
    assert fields == [f.name for f in dataclasses.fields(RefLocation)]
