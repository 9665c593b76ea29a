"""Push shuffle and the TTL sweep of the port, on the CPU: the cases of
``tests/test_push_shuffle.py`` through the port's push registry, its
shuffle writer's push appender, its Flight ``do_exchange`` and its
reader, and the cases of ``tests/test_lifecycle.py::test_cleanup_ttl``
through the port's ``executor/cleanup.py``. Where the reference and the
port take the same input (a committed stream served over Flight, the
writer's push commit) their outputs are compared too."""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc
import pytest
import torch

from ballista_tpu_torch.errors import ShuffleFetchError
from ballista_tpu_torch.executor.push import PushRegistry, stream_key
from ballista_tpu_torch.scheduler_types import PartitionLocation


def rb_of(n: int, base: int = 0) -> pa.RecordBatch:
    return pa.record_batch(
        [pa.array(np.arange(base, base + n, dtype=np.int64)),
         pa.array(np.arange(n, dtype=np.float64))],
        names=["k", "v"],
    )


def open_stream(reg, tmp_path, key=None, owner="own"):
    key = key or stream_key("j", 2, 0, 0)
    path = str(tmp_path / "j" / str(key[1]) / str(key[3]) / f"push-{key[2]}.arrow")
    return reg.open(key, path, owner, None)


# -- the registry's state machine ---------------------------------------------


def test_commit_take_is_idempotent(tmp_path):
    reg = PushRegistry()
    s = open_stream(reg, tmp_path)
    rb = rb_of(100)
    assert reg.append(s, rb, 1 << 30) == 0
    rows, nb, size, pushed = reg.seal(s)
    assert (rows, nb, pushed) == (100, 1, True) and size == rb.nbytes
    assert not os.path.exists(s.path)
    got1 = reg.take_batches(s.key)
    got2 = reg.take_batches(s.key)  # a capacity retry fetches again
    assert got1 is got2 and len(got1) == 1 and got1[0].equals(rb)
    reg.drop_owner("own")
    assert reg.stream_count() == 0 and reg.mem_bytes() == 0


def test_window_overflow_spills_sealed_victim_atomically(tmp_path):
    reg = PushRegistry()
    window = 1 << 20
    a = open_stream(reg, tmp_path, stream_key("j", 2, 0, 0))
    rb = rb_of(1 << 15)  # 512 KiB
    reg.append(a, rb, window)
    assert reg.seal(a)[3] is True
    b = open_stream(reg, tmp_path, stream_key("j", 2, 1, 0))
    spilled = reg.append(b, rb, window) + reg.append(b, rb, window)
    assert spilled > 0
    assert reg.take_batches(a.key) is None  # the consumer falls back to the file
    assert os.path.exists(a.path) and not os.path.exists(a.path + ".spill.tmp")
    with paipc.open_file(a.path) as r:
        assert r.read_all().to_pydict() == pa.Table.from_batches([rb]).to_pydict()
    assert reg.mem_bytes() <= window
    reg.drop_owner("own")


def test_window_overflow_drops_consumed_victims_without_disk(tmp_path):
    reg = PushRegistry()
    window = 1 << 20
    rb = rb_of(1 << 15)
    consumed = open_stream(reg, tmp_path, stream_key("j", 2, 0, 0))
    reg.append(consumed, rb, window)
    reg.seal(consumed)
    assert reg.take_batches(consumed.key) is not None
    lagging = open_stream(reg, tmp_path, stream_key("j", 2, 1, 0))
    reg.append(lagging, rb, window)
    reg.seal(lagging)
    writer = open_stream(reg, tmp_path, stream_key("j", 2, 2, 0))
    assert reg.append(writer, rb, window) == 0  # dropping the consumed one was enough
    assert not os.path.exists(consumed.path)
    assert reg.take_batches(consumed.key) is None
    assert reg.peek_batches(lagging.key) is not None
    assert reg.append(writer, rb, window) > 0 and os.path.exists(lagging.path)
    reg.drop_owner("own")


def test_self_conversion_commits_plain_file(tmp_path):
    reg = PushRegistry()
    s = open_stream(reg, tmp_path)
    window = rb_of(1 << 14).nbytes * 2
    batches = []
    for i in range(5):
        batches.append(rb_of(1 << 14, i))
        reg.append(s, batches[-1], window)
    rows, nb, size, pushed = reg.seal(s)
    assert pushed is False and rows == 5 * (1 << 14)
    assert os.path.exists(s.path) and size == os.path.getsize(s.path)
    assert reg.stream_count() == 0 and reg.mem_bytes() == 0
    with paipc.open_file(s.path) as r:
        assert r.read_all().equals(pa.Table.from_batches(batches))


def test_abort_discards_partial_attempt(tmp_path):
    reg = PushRegistry()
    s = open_stream(reg, tmp_path)
    reg.append(s, rb_of(10), 1 << 30)
    reg.abort(s)
    assert reg.stream_count() == 0 and reg.mem_bytes() == 0
    assert reg.take_batches(s.key) is None and not os.path.exists(s.path)
    s2 = open_stream(reg, tmp_path)
    reg.append(s2, rb_of(20), 1 << 30)
    assert reg.seal(s2)[0] == 20
    reg.drop_owner("own")


def test_open_replaces_previous_attempt(tmp_path):
    reg = PushRegistry()
    s1 = open_stream(reg, tmp_path)
    reg.append(s1, rb_of(10), 1 << 30)
    reg.seal(s1)
    s2 = open_stream(reg, tmp_path)
    reg.append(s2, rb_of(30), 1 << 30)
    reg.seal(s2)
    assert [b.num_rows for b in reg.take_batches(s2.key)] == [30]
    reg.drop_owner("own")
    assert reg.mem_bytes() == 0


def test_superseded_attempt_cannot_inflate_the_window(tmp_path):
    reg = PushRegistry()
    s1 = open_stream(reg, tmp_path)
    reg.append(s1, rb_of(10), 1 << 30)
    s2 = open_stream(reg, tmp_path)
    before = reg.mem_bytes()
    reg.append(s1, rb_of(1 << 15), 1 << 30)
    rows, nb, size, pushed = reg.seal(s1)
    assert reg.mem_bytes() == before and (size, pushed) == (0, False)
    reg.append(s2, rb_of(30), 1 << 30)
    reg.seal(s2)
    assert reg.take_batches(s2.key)[0].num_rows == 30
    reg.drop_owner("own")
    assert reg.mem_bytes() == 0 and reg.stream_count() == 0


def test_sweep_drops_only_stale_sealed_streams(tmp_path):
    reg = PushRegistry()
    s = open_stream(reg, tmp_path, stream_key("j", 2, 0, 0))
    reg.append(s, rb_of(10), 1 << 30)
    reg.seal(s)
    live = open_stream(reg, tmp_path, stream_key("j", 2, 1, 0))
    reg.append(live, rb_of(10), 1 << 30)
    assert reg.sweep(3600) == 0
    assert reg.sweep(-1) == 1
    assert reg.take_batches(s.key) is None and reg.stream_count() == 1
    reg.drop_owner("own")


def test_registry_counts_are_exact_under_threads(tmp_path):
    """Eight threads append to their own streams of one registry while
    the window evicts: no byte of the in-memory total is lost or doubled."""
    import sys
    import threading

    reg = PushRegistry()
    window = 4 * rb_of(1 << 12).nbytes
    streams = [open_stream(reg, tmp_path, stream_key("j", 2, i, 0)) for i in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda s=s: [reg.append(s, rb_of(1 << 12, i), window) for i in range(20)])
            for s in streams
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    in_mem = sum(s.nbytes for s in streams if s.state == "open-mem")
    assert reg.mem_bytes() == in_mem
    for s in streams:
        reg.seal(s)
    reg.drop_owner("own")
    assert reg.mem_bytes() == 0


# -- do_exchange over the port's Flight service -------------------------------


@pytest.fixture()
def flight_exec(tmp_path):
    from ballista_tpu_torch.executor.flight_service import start_flight_server

    work = tmp_path / "exec-0"
    work.mkdir()
    svc, port, t = start_flight_server("127.0.0.1", 0, str(work))
    yield str(work), port
    svc.shutdown()
    t.join(timeout=10)


def push_loc(work, port, key, push=True):
    return PartitionLocation(
        job_id=key[0], stage_id=key[1], partition=key[3], executor_id="e0", host="127.0.0.1",
        port=port, path=os.path.join(work, key[0], str(key[1]), str(key[3]), f"push-{key[2]}.arrow"),
        push=push, map_partition=key[2],
    )


def test_do_exchange_serves_memory_stream(flight_exec):
    """A stream committed in the port's registry, served from memory by the
    port's do_exchange (the reference's client reads it in
    test_torch_flight.py)."""
    from ballista_tpu_torch.client.flight import fetch_push_batches
    from ballista_tpu_torch.executor.push import REGISTRY

    work, port = flight_exec
    key = stream_key("jx", 2, 0, 0)
    loc = push_loc(work, port, key)
    s = REGISTRY.open(key, loc.path, work, None)
    batches = [rb_of(64, 0), rb_of(64, 64)]
    for rb in batches:
        REGISTRY.append(s, rb, 1 << 30)
    REGISTRY.seal(s)
    try:
        fallbacks = []
        got = list(fetch_push_batches(loc, on_fallback=lambda: fallbacks.append(1)))
        assert pa.Table.from_batches(got).equals(pa.Table.from_batches(batches))
        assert not fallbacks and not os.path.exists(loc.path)
    finally:
        REGISTRY.drop_owner(work)


def test_do_exchange_falls_back_to_spilled_file(flight_exec):
    from ballista_tpu_torch.client.flight import fetch_push_batches

    work, port = flight_exec
    loc = push_loc(work, port, stream_key("jy", 2, 0, 0))
    os.makedirs(os.path.dirname(loc.path))
    rb = rb_of(128)
    with paipc.new_file(loc.path, rb.schema) as w:
        w.write_batch(rb)
    fallbacks = []
    got = list(fetch_push_batches(loc, on_fallback=lambda: fallbacks.append(1)))
    assert fallbacks == [1] and got[0].equals(rb)


def test_do_exchange_gone_stream_is_nontransient_fetch_error(flight_exec):
    from ballista_tpu_torch.client.flight import fetch_push_batches

    work, port = flight_exec
    loc = push_loc(work, port, stream_key("jz", 2, 0, 0))
    with pytest.raises(ShuffleFetchError) as ei:
        list(fetch_push_batches(loc, retries=2, backoff_ms=1))
    assert ei.value.transient is False and "[push-stream-gone]" in str(ei.value)
    assert ei.value.executor_id == "e0" and ei.value.stage_id == 2


def test_do_exchange_containment_rejects_escaping_path(flight_exec):
    from ballista_tpu_torch.client.flight import fetch_push_batches

    work, port = flight_exec
    loc = dataclasses.replace(push_loc(work, port, stream_key("jq", 2, 0, 0)), path="/etc/passwd")
    with pytest.raises(ShuffleFetchError, match="escapes the executor shuffle root"):
        list(fetch_push_batches(loc, retries=1))


def test_reader_fetch_uses_local_registry_then_file(tmp_path):
    from ballista_tpu_torch.executor.push import REGISTRY
    from ballista_tpu_torch.executor.reader import fetch_partition_batches

    key = stream_key("jr", 3, 1, 0)
    loc = push_loc(str(tmp_path), 0, key)
    s = REGISTRY.open(key, loc.path, str(tmp_path), None)
    rb = rb_of(32)
    REGISTRY.append(s, rb, 1 << 30)
    REGISTRY.seal(s)
    try:
        hits = []
        got = list(fetch_partition_batches(loc, on_push_fallback=hits.append))
        assert got[0].equals(rb) and not hits
    finally:
        REGISTRY.drop_owner(str(tmp_path))
    os.makedirs(os.path.dirname(loc.path), exist_ok=True)
    with paipc.new_file(loc.path, rb.schema) as w:
        w.write_batch(rb)
    hits = []
    got = list(fetch_partition_batches(loc, on_push_fallback=lambda: hits.append(1)))
    assert got[0].equals(rb) and hits == [1]


# -- codecs, serde of the push fields -----------------------------------------


def test_resolve_link_codec_auto(tmp_path):
    from ballista_tpu_torch.executor.reader import resolve_link_codec

    local_file = tmp_path / "d.arrow"
    local_file.write_bytes(b"x")

    def loc(host, path):
        return PartitionLocation("j", 1, 0, "e", host, 1, str(path))

    assert resolve_link_codec("auto", loc("far.example", local_file)) == "none"
    assert resolve_link_codec("auto", loc("localhost", "/gone")) == "none"
    assert resolve_link_codec("auto", loc("127.0.0.1", "/gone")) == "none"
    assert resolve_link_codec("auto", loc("far.example", "/gone")) == "lz4"
    assert resolve_link_codec("zstd", loc("localhost", "/gone")) == "zstd"
    assert resolve_link_codec("none", loc("far.example", "/gone")) == "none"


def test_shuffle_write_meta_push_rides_task_status():
    from ballista_tpu_torch.executor.executor import as_task_status
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.scheduler_types import ShuffleWritePartitionMeta

    metas = [
        ShuffleWritePartitionMeta(0, "/w/push-0.arrow", 1, 10, 100, push=True),
        ShuffleWritePartitionMeta(1, "/w/data-0.arrow", 1, 10, 100),
    ]
    st = as_task_status(pb.PartitionId(job_id="j", stage_id=2, partition_id=0), "e0", metas, None)
    assert [bool(p.push) for p in st.completed.partitions] == [True, False]


# -- the writer's push commit --------------------------------------------------


def _writer_case(tmp_path, device):
    from ballista_tpu.columnar.arrow_interop import schema_from_arrow as ref_schema_from_arrow
    from ballista_tpu.config import BallistaConfig as RefConfig
    from ballista_tpu.exec.base import TaskContext as RefTaskContext
    from ballista_tpu.exec.scan import MemoryScanExec as RefScan
    from ballista_tpu.executor.push import REGISTRY as REF_REGISTRY
    from ballista_tpu.executor.push import stream_key as ref_stream_key
    from ballista_tpu.executor.shuffle import ShuffleWriterExec as RefWriter
    from ballista_tpu.expr import logical as RL
    from ballista_tpu_torch.columnar.arrow_interop import schema_from_arrow
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.base import TaskContext
    from ballista_tpu_torch.exec.scan import MemoryScanExec
    from ballista_tpu_torch.executor.push import REGISTRY
    from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec
    from ballista_tpu_torch.expr import logical as L

    rng = np.random.default_rng(7)
    n = 3000
    t = pa.table({
        "k": rng.integers(0, 50, n).astype(np.int64),
        "v": rng.uniform(0, 1, n),
        "s": pa.array([f"name-{i % 17}" for i in range(n)]),
    })

    def make_writer():
        scan = MemoryScanExec(t, schema_from_arrow(t.schema), partitions=1)
        return ShuffleWriterExec("jw", 1, scan, [L.col("k")], 4)

    # files: no scheduler-connected executor, so no push
    pull_dir = tmp_path / "pull"
    pull_metas = make_writer().execute_shuffle_write(
        0, TaskContext(config=BallistaConfig(), work_dir=str(pull_dir), device=device)
    )
    assert pull_metas and all(not m.push for m in pull_metas)
    push_dir = tmp_path / "push"
    ctx = TaskContext(
        config=BallistaConfig(), work_dir=str(push_dir), device=device, shuffle_locations=lambda *a: None,
    )
    writer = make_writer()
    push_metas = writer.execute_shuffle_write(0, ctx)
    ref_dir = tmp_path / "ref"
    ref_scan = RefScan(t, ref_schema_from_arrow(t.schema), partitions=1)
    ref_metas = RefWriter("jw", 1, ref_scan, [RL.col("k")], 4).execute_shuffle_write(
        0, RefTaskContext(config=RefConfig(), work_dir=str(ref_dir), shuffle_locations=lambda *a: None)
    )
    return (pull_metas, push_metas, ref_metas, writer, push_dir, ref_dir, REGISTRY, REF_REGISTRY, stream_key,
            ref_stream_key)


def _check_writer_case(tmp_path, device):
    (pull_metas, push_metas, ref_metas, writer, push_dir, ref_dir, REGISTRY, REF_REGISTRY, key,
     ref_key) = _writer_case(tmp_path, device)
    try:
        assert push_metas and all(m.push for m in push_metas)
        assert not any(os.path.exists(m.path) for m in push_metas)
        assert [(m.partition_id, m.num_rows, m.push) for m in push_metas] == [
            (m.partition_id, m.num_rows, m.push) for m in ref_metas
        ]
        assert writer.metrics.counters["pushed_bytes"] == sum(m.num_bytes for m in push_metas)
        for pm, fm in zip(push_metas, pull_metas):
            batches = REGISTRY.take_batches(key("jw", 1, 0, pm.partition_id))
            got = pa.Table.from_batches(batches)
            with paipc.open_file(fm.path) as r:
                assert got.to_pydict() == r.read_all().to_pydict()
            want = pa.Table.from_batches(REF_REGISTRY.take_batches(ref_key("jw", 1, 0, pm.partition_id)))
            assert got.to_pydict() == want.to_pydict()
            assert pm.num_rows == fm.num_rows
        return REGISTRY, push_metas
    finally:
        REF_REGISTRY.drop_owner(str(ref_dir))


def test_writer_push_commit_and_pull_fallback_file(tmp_path):
    """ShuffleWriterExec in push mode: push metas, nothing on disk, and the
    registry holds the rows the file mode writes and the reference's
    writer pushes, bucket for bucket."""
    registry, _ = _check_writer_case(tmp_path, "cpu")
    registry.drop_owner(str(tmp_path / "push"))


@pytest.mark.gpu
def test_writer_push_batches_hold_no_pinned_memory(tmp_path, monkeypatch):
    """On the card a grouped batch's slices alias its pinned host buffer;
    a pushed batch must hold memory of its own, or a stream would keep the
    whole pinned buffer alive past what the window counts. Every buffer of
    every pushed batch lies outside the pinned buffers the writer used."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from ballista_tpu_torch.exec.spill import HostStaging
    from ballista_tpu_torch.executor import shuffle

    pinned: list[tuple[int, int]] = []

    class Recording(HostStaging):
        def __call__(self, nbytes):
            buf = super().__call__(nbytes)
            assert buf.is_pinned()
            pinned.append((buf.data_ptr(), buf.data_ptr() + buf.numel()))
            return buf

    monkeypatch.setattr(shuffle, "HostStaging", Recording)
    registry, metas = _check_writer_case(tmp_path, "cuda")
    try:
        assert pinned
        for m in metas:
            for rb in registry.peek_batches(stream_key("jw", 1, 0, m.partition_id)):
                for col in rb.columns:
                    arr = col.indices if pa.types.is_dictionary(col.type) else col
                    for buf in arr.buffers():
                        if buf is not None and buf.size:
                            assert not any(lo <= buf.address < hi for lo, hi in pinned)
    finally:
        registry.drop_owner(str(tmp_path / "push"))


# -- the TTL sweep (tests/test_lifecycle.py::test_cleanup_ttl) ------------------


def _age(path, seconds):
    stale = time.time() - seconds
    for root, dirs, files in os.walk(path, topdown=False):
        for name in files + dirs:
            os.utime(os.path.join(root, name), (stale, stale))
    os.utime(path, (stale, stale))


def test_cleanup_ttl(tmp_path):
    """Expired job dirs are deleted, fresh ones survive; loose files in the
    work dir are never touched (the reference's cases)."""
    from ballista_tpu_torch.executor.cleanup import clean_shuffle_data

    old_job = tmp_path / "job-old" / "1" / "0"
    old_job.mkdir(parents=True)
    (old_job / "data-0.arrow").write_bytes(b"x")
    new_job = tmp_path / "job-new" / "1" / "0"
    new_job.mkdir(parents=True)
    (new_job / "data-0.arrow").write_bytes(b"y")
    (tmp_path / "loose.txt").write_bytes(b"z")
    _age(tmp_path / "job-old", 3600)
    assert clean_shuffle_data(str(tmp_path), ttl_seconds=600) == ["job-old"]
    assert not (tmp_path / "job-old").exists() and (new_job / "data-0.arrow").exists()
    assert clean_shuffle_data(str(tmp_path), ttl_seconds=0) == ["job-new"]
    assert (tmp_path / "loose.txt").exists()


def test_cleanup_ttl_of_spill_and_push_data(tmp_path):
    """Orphaned grace-hash spill attempt directories under the port's spill
    root go past the TTL, live ones stay; stale sealed push streams go."""
    from ballista_tpu_torch.exec.spill import SPILL_TMP_ROOT
    from ballista_tpu_torch.executor import cleanup
    from ballista_tpu_torch.executor.push import REGISTRY

    root = tmp_path / "spill"
    (root / "attempt-old").mkdir(parents=True)
    (root / "attempt-old" / "b0.arrow").write_bytes(b"x")
    (root / "attempt-live").mkdir()
    _age(root / "attempt-old", 3600)
    assert cleanup.clean_spill_data(600, root=str(root)) == ["attempt-old"]
    assert (root / "attempt-live").exists()
    assert SPILL_TMP_ROOT.startswith(__import__("tempfile").gettempdir())
    s = REGISTRY.open(stream_key("jttl", 1, 0, 0), str(tmp_path / "p.arrow"), "ttl-owner", None)
    REGISTRY.append(s, rb_of(4), 1 << 30)
    REGISTRY.seal(s)
    assert cleanup.clean_push_streams(-1) >= 1
    assert REGISTRY.take_batches(s.key) is None


def test_cleanup_loop_sweeps_and_stops(tmp_path):
    from ballista_tpu_torch.executor.cleanup import start_cleanup_loop

    (tmp_path / "job-old").mkdir()
    _age(tmp_path / "job-old", 3600)
    t, stop = start_cleanup_loop(str(tmp_path), 600, 0.05)
    deadline = time.time() + 10
    while (tmp_path / "job-old").exists() and time.time() < deadline:
        time.sleep(0.05)
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive() and not (tmp_path / "job-old").exists()
