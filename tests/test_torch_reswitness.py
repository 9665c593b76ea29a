"""The port's runtime resource witness
(``ballista_tpu_torch/analysis/reswitness.py``), the cases of
``tests/test_reswitness.py`` that ``tests/test_torch_prewarm.py`` does not
hold: the tracker's semantics, held against the reference's tracker on
the same calls, and the leak repairs on the port's own objects, each with
the live and acquired counts the reference's test asserts:

- the reader's local path closes its memory map on exhaustion, on
  abandonment and under ``fetch_partition_table``;
- the Flight service closes the file of a served partition, also when the
  stream is dropped before its first pull;
- a failed executor registration tears the partial startup down;
- the REST server's stop joins its thread and closes its socket.
"""

import gc
import os
import socket
import threading
import time

import grpc
import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc
import pytest

from ballista_tpu.analysis import reswitness as ref_reswitness
from ballista_tpu_torch.analysis import reswitness


@pytest.fixture
def witness():
    reswitness.reset()
    reswitness.enable(True)
    yield reswitness
    reswitness.enable(False)
    reswitness.reset()


def _write_ipc(path, rows=50_000):
    t = pa.table({"a": np.arange(rows, dtype=np.int64)})
    with paipc.new_file(str(path), t.schema) as w:
        w.write_table(t)
    return t


def _location(path):
    from ballista_tpu_torch.scheduler_types import PartitionLocation

    return PartitionLocation(
        job_id="j", stage_id=1, partition=0, executor_id="e",
        host="127.0.0.1", port=1, path=str(path),
    )


def _wait_drained(w, seconds=5.0):
    deadline = time.time() + seconds
    while w.live() and time.time() < deadline:
        time.sleep(0.05)


# ------------------------------------------------------------- semantics --


def test_disabled_witness_is_inert():
    def scenario(w):
        w.reset()
        enabled = w.enabled()
        tok = w.acquire("grpc-channel", "x")
        w.release(tok)  # tolerated
        w.assert_drained()
        return enabled, tok, w.live(), w.acquired_counts()

    got = scenario(reswitness)
    assert got == scenario(ref_reswitness) == (False, None, [], {})


def test_acquire_release_and_leak_report():
    def scenario(w):
        w.reset()
        w.enable(True)
        try:
            tok = w.acquire("thread-pool", "demo")
            live = len(w.live())
            counts = w.acquired_counts()
            with pytest.raises(AssertionError) as ei:
                w.assert_drained()
            report = str(ei.value)
            w.release(tok)
            w.release(tok)  # double release tolerated
            w.assert_drained()
            return live, counts, w.acquired_counts(), report
        finally:
            w.enable(False)
            w.reset()

    live, counts, lifetime, report = scenario(reswitness)
    assert (live, counts, lifetime) == scenario(ref_reswitness)[:3]
    assert (live, counts, lifetime) == (1, {"thread-pool": 1}, {"thread-pool": 1})
    assert "thread-pool demo" in report
    assert "test_torch_reswitness" in report  # the creation stack


# ---------------------------------------------- reader local-path mmap fix --


def test_local_fetch_releases_mmap_on_exhaustion_and_abandonment(witness, tmp_path):
    from ballista_tpu_torch.executor.reader import fetch_partition_batches

    p = tmp_path / "part.arrow"
    _write_ipc(p)
    loc = _location(p)
    # full consumption
    assert sum(rb.num_rows for rb in fetch_partition_batches(loc)) == 50_000
    assert witness.acquired_counts().get("mmap") == 1
    witness.assert_drained()
    # early abandonment (LIMIT shape): GeneratorExit must close the map
    it = fetch_partition_batches(loc)
    next(it)
    it.close()
    witness.assert_drained()
    assert witness.acquired_counts().get("mmap") == 2


def test_fetch_partition_table_releases_mmap(witness, tmp_path):
    from ballista_tpu_torch.executor.reader import fetch_partition_table

    p = tmp_path / "part.arrow"
    expect = _write_ipc(p, rows=1000)
    got = fetch_partition_table(_location(p))
    # the table stays valid after the map is closed (its buffers pin the
    # mapping; close drops the fd)
    assert got.equals(expect)
    assert witness.acquired_counts().get("mmap") == 1
    witness.assert_drained()


# ------------------------------------------- flight service fd ownership --


def _fetch_action(path):
    from ballista_tpu_torch.proto import pb

    action = pb.Action()
    action.fetch_partition.job_id = "j"
    action.fetch_partition.stage_id = 1
    action.fetch_partition.partition_id = 0
    action.fetch_partition.path = str(path)
    return action


def test_do_get_releases_served_file_fd(witness, tmp_path):
    import pyarrow.flight as paflight

    from ballista_tpu_torch.executor.flight_service import BallistaFlightService

    part = tmp_path / "shuffle.arrow"
    expect = _write_ipc(part, rows=10_000)
    svc = BallistaFlightService("grpc://127.0.0.1:0", str(tmp_path))
    t = threading.Thread(target=svc.serve, daemon=True)
    t.start()
    try:
        client = paflight.connect(f"grpc://127.0.0.1:{svc.port}")
        try:
            ticket = paflight.Ticket(_fetch_action(part).SerializeToString())
            got = client.do_get(ticket).read_all()
            assert got.num_rows == expect.num_rows
        finally:
            client.close()
        assert witness.acquired_counts().get("served-file") == 1
        # the stream generator's finally closes the fd on exhaustion
        _wait_drained(witness)
        witness.assert_drained()
    finally:
        svc.shutdown()
        t.join(timeout=10)


def test_do_get_stream_dropped_before_first_pull_still_closes_fd(witness, tmp_path):
    """A client cancelling before the first batch drops a never-started
    generator, whose finally would not run: ``do_get`` primes it, so the
    cleanup is armed from the moment the stream exists."""
    from ballista_tpu_torch.executor.flight_service import BallistaFlightService

    part = tmp_path / "shuffle.arrow"
    _write_ipc(part, rows=100)
    svc = BallistaFlightService.__new__(BallistaFlightService)
    svc.work_dir = str(tmp_path)
    svc._root = os.path.realpath(str(tmp_path))

    class _Ticket:
        ticket = _fetch_action(part).SerializeToString()

    stream = svc.do_get(None, _Ticket())
    assert witness.acquired_counts().get("served-file") == 1
    del stream
    gc.collect()
    witness.assert_drained()


# ----------------------------------------- executor-server startup leak --


def test_failed_registration_tears_down_partial_startup(witness, tmp_path, monkeypatch):
    from ballista_tpu_torch.executor import executor_server as es
    from ballista_tpu_torch.executor.executor import Executor

    monkeypatch.setattr(es, "RPC_TIMEOUT_S", 1.0)
    # a port nothing listens on: RegisterExecutor must fail fast
    srv = es.ExecutorServer(
        Executor("exec-test", str(tmp_path), device="cpu"),
        scheduler_addr="127.0.0.1:1",
        flight_host="127.0.0.1",
        flight_port=1,
        task_slots=1,
    )
    with pytest.raises(grpc.RpcError):
        srv.startup(port=0)
    # the except path ran stop(): the channel released, no heartbeat or
    # runner threads spawned, the witness drained
    assert witness.acquired_counts().get("grpc-channel") == 1
    witness.assert_drained()
    names = {t.name for t in threading.enumerate()}
    assert "heartbeater" not in names
    assert not any(n.startswith("task-runner") for n in names)


# --------------------------------------------------- rest server socket --


def test_stop_rest_server_joins_thread_and_closes_socket():
    from ballista_tpu_torch.scheduler.rest import start_rest_server, stop_rest_server

    class _Dummy:  # the handler touches the server only per request
        pass

    httpd, port = start_rest_server(_Dummy(), host="127.0.0.1", port=0)
    serve_thread = httpd._serve_thread
    assert serve_thread.is_alive()
    stop_rest_server(httpd)
    assert not serve_thread.is_alive()
    # the listening socket is gone: the port can be bound again at once
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.bind(("127.0.0.1", port))
    finally:
        s.close()
