"""The PyTorch port stands alone: it imports neither jax nor any module of
the JAX package, and its entry point refuses to run without a card unless
asked for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "ballista_tpu_torch"


def forbidden(module: str) -> bool:
    """jax, or the reference package itself. Matched by exact module name:
    ``ballista_tpu_torch`` starts with ``ballista_tpu`` but is the port."""
    return module.split(".")[0] in ("jax", "jaxlib", "ballista_tpu")


def imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def test_forbidden_matches_names_exactly():
    assert forbidden("jax") and forbidden("jax.numpy")
    assert forbidden("ballista_tpu") and forbidden("ballista_tpu.exec.context")
    assert not forbidden("ballista_tpu_torch")
    assert not forbidden("ballista_tpu_torch.exec.context")
    assert not forbidden("jaxtyping")


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_no_forbidden_imports_in_source(target):
    files = sorted(PKG.rglob("*.py")) if target == "package" else [ROOT / "chip_smoke.py"]
    assert files
    if target == "package":
        names = {f.relative_to(PKG).as_posix() for f in files}
        assert {
            "exec/window.py", "exec/percentile.py", "exec/joins.py", "exec/spill.py",
            "exec/repartition.py", "ops/partition.py", "ops/cuda_build.py",
            "serde.py", "distributed_plan.py", "scheduler_types.py", "proto/__init__.py",
            "proto/ballista_tpu_pb2.py", "columnar/coalesce.py", "executor/shuffle.py",
            "executor/reader.py", "executor/executor.py", "executor/executor_server.py",
            "executor/__main__.py", "executor/flight_service.py", "executor/push.py",
            "executor/metrics.py", "executor/cleanup.py", "client/flight.py",
            "scheduler/rpc.py", "analysis/witness.py", "analysis/reswitness.py",
            "analysis/replay.py", "testing/faults.py", "obs/trace.py", "obs/hist.py",
            "obs/profile.py", "obs/history.py", "event_loop.py", "analysis/statemachine.py",
            "analysis/verifier.py", "analysis/stalewitness.py", "obs/qclass.py",
            "scheduler/executor_manager.py", "scheduler/stage_manager.py",
            "scheduler/state_backend.py", "scheduler/persistent_state.py",
            "scheduler/result_cache.py", "scheduler/aqe.py", "scheduler/server.py",
            "scheduler/__main__.py", "standalone.py", "client/context.py",
            "avro.py", "functions.py", "exec/scan.py", "compilecache/__init__.py",
            "compilecache/hints.py", "compilecache/metrics.py", "utils.py", "cli.py",
            "scheduler/rest.py", "obs/prometheus.py", "scheduler/external_scaler.py",
            "scheduler/etcd_backend.py", "proto/etcd_pb2.py", "rewrite.py",
            "compilecache/registry.py", "analysis/eqlint.py",
            "analysis/serde_audit.py", "analysis/protodrift.py", "analysis/configlint.py",
            "analysis/racelint.py", "analysis/lifelint.py", "analysis/detlint.py",
            "analysis/budget.py", "analysis/stalelint.py", "analysis/cachereg.py",
            "analysis/durlint.py", "analysis/durreg.py", "analysis/durwitness.py",
            "analysis/__main__.py",
        } <= names
    bad = [
        f"{f.relative_to(ROOT)}: {m}"
        for f in files
        for m in imported_modules(f)
        if forbidden(m)
    ]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ballista_tpu')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_context_needs_cuda_unless_asked_for_cpu(monkeypatch):
    from ballista_tpu_torch.exec.context import TorchContext

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchContext()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchContext(device="cuda")
    assert TorchContext(device="cpu").device == torch.device("cpu")


def _no_device_calls():
    """Each public constructor of batches or tasks, called without a device."""
    import numpy as np
    import pyarrow as pa

    from ballista_tpu_torch.columnar import arrow_interop
    from ballista_tpu_torch.columnar.batch import DeviceBatch
    from ballista_tpu_torch.columnar.bridge import batch_from_numpy
    from ballista_tpu_torch.datatypes import DataType, Field, Schema
    from ballista_tpu_torch.exec.base import TaskContext
    from ballista_tpu_torch.executor.executor import Executor

    schema = Schema([Field("x", DataType.INT64, False)])
    table = pa.table({"x": pa.array([1, 2, 3], pa.int64())})
    x = np.arange(2048, dtype=np.int64)
    return {
        "TaskContext": lambda **kw: TaskContext(**kw).device,
        "Executor": lambda **kw: Executor("e", "/nonexistent/work", **kw).device,
        "batch_from_numpy": lambda **kw: batch_from_numpy(
            [("x", "int64", False)], [x], np.ones(2048, bool), [None], {}, **kw
        ).device,
        "from_host": lambda **kw: DeviceBatch.from_host(schema, [x], **kw).device,
        "empty": lambda **kw: DeviceBatch.empty(schema, **kw).device,
        "batch_from_arrow": lambda **kw: arrow_interop.batch_from_arrow(
            table, **kw
        ).device,
        "table_from_arrow": lambda **kw: arrow_interop.table_from_arrow(
            table, 2, **kw
        )[0].device,
    }


@pytest.mark.parametrize(
    "entry",
    ["TaskContext", "Executor", "batch_from_numpy", "from_host", "empty", "batch_from_arrow",
     "table_from_arrow"],
)
def test_batches_and_tasks_need_cuda_unless_asked_for_cpu(entry, monkeypatch):
    """Without a device argument nothing lands on the CPU: the default is
    the card, and a missing card raises."""
    call = _no_device_calls()[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert call(device="cpu") == torch.device("cpu")


def test_executor_process_needs_cuda_unless_asked_for_cpu(monkeypatch):
    """``python -m ballista_tpu_torch.executor`` raises without a card
    before it binds a port, unless started with ``--device cpu``."""
    from ballista_tpu_torch.executor import __main__ as executor_main

    def no_bind(*a, **kw):
        raise AssertionError("bound a port without a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(executor_main, "start_flight_server", no_bind)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            executor_main.main(["--bind-port", "0", *argv])


def test_executor_process_on_the_cpu_stops_on_sigterm(tmp_path):
    """With ``--device cpu`` the process starts its Flight service and poll
    loop (here against a scheduler port nobody listens on) and exits 0
    within 10 s of a SIGTERM."""
    import os
    import signal
    import socket
    import time

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        closed = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("BALLISTA_EXECUTOR_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.executor", "--device", "cpu",
         "--bind-host", "127.0.0.1", "--bind-port", "0", "--scheduler-host", "127.0.0.1",
         "--scheduler-port", str(closed), "--work-dir", str(tmp_path / "work")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.time() + 60
        started = ""
        while "Flight on" not in started and time.time() < deadline and proc.poll() is None:
            started += proc.stdout.readline()
        assert "Flight on" in started and "device=cpu" in started, started
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_config_rejects_unknown_keys():
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.errors import ConfigError

    cfg = BallistaConfig()
    assert cfg.tpu_batch_rows() == 1 << 21
    assert cfg.agg_capacity() == 1 << 16
    assert cfg.default_shuffle_partitions() == 2
    assert BallistaConfig({"ballista.tpu.batch_rows": "4096"}).tpu_batch_rows() == 4096
    with pytest.raises(ConfigError):
        BallistaConfig({"ballista.tpu.no_such_key": "1"})
    with pytest.raises(ConfigError):
        BallistaConfig({"ballista.shuffle.partitions": "two"})


def test_standalone_cluster_needs_cuda_unless_asked_for_cpu(monkeypatch):
    """``BallistaContext.standalone()`` raises without a card before it
    starts a thread or binds a port, unless asked for the CPU."""
    import threading

    from ballista_tpu_torch.client.context import BallistaContext

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BallistaContext.standalone(**kw)
    assert threading.active_count() == before
    ctx = BallistaContext.standalone(device="cpu")
    try:
        assert ctx.device == torch.device("cpu")
        assert ctx._standalone_cluster.executor.device == torch.device("cpu")
    finally:
        ctx.close()


def _scheduler_process(*args):
    proc = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.scheduler", "--bind-host", "127.0.0.1",
         "--bind-port", "0", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc


class _AbortContext:
    def abort(self, code, details):
        raise RuntimeError(code, details)


def test_scheduler_process_on_the_cpu_serves_and_stops_on_sigterm(tmp_path):
    """``python -m ballista_tpu_torch.scheduler`` needs no card: it starts,
    answers RegisterExecutor (push-staged) and GetFileMetadata (a Parquet
    file's schema, as the reference's scheduler gives it; INVALID_ARGUMENT
    for CSV), and exits 0 within 10 s of a SIGTERM."""
    import datetime
    import re
    import signal
    import time

    import grpc
    import pyarrow as pa
    import pyarrow.parquet as papq

    from ballista_tpu.scheduler.server import SchedulerGrpcServicer as RefServicer
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.scheduler.rpc import scheduler_stub

    path = str(tmp_path / "t.parquet")
    papq.write_table(
        pa.table({
            "k": pa.array([1, 2], pa.int64()), "s": pa.array(["a", None]),
            "d": pa.array([datetime.date(1995, 1, 1)] * 2, pa.date32()), "f": pa.array([0.5, None]),
        }),
        path,
    )
    ask = pb.GetFileMetadataParams(path=path, file_type="parquet")
    want = RefServicer.GetFileMetadata(None, ask, _AbortContext()).SerializeToString()

    proc = _scheduler_process("--scheduler-policy", "push-staged")
    try:
        deadline = time.time() + 60
        started = ""
        while "gRPC on" not in started and time.time() < deadline and proc.poll() is None:
            started += proc.stdout.readline()
        m = re.search(r"gRPC on 127\.0\.0\.1:(\d+)", started)
        assert m, started
        with grpc.insecure_channel(f"127.0.0.1:{m.group(1)}") as ch:
            stub = scheduler_stub(ch)
            meta = pb.ExecutorMetadata(
                id="e1", host="127.0.0.1", port=1, grpc_port=0,
                specification=pb.ExecutorSpecification(task_slots=2, n_devices=1),
            )
            res = stub.RegisterExecutor(pb.RegisterExecutorParams(metadata=meta), timeout=10)
            assert res.success
            assert stub.GetFileMetadata(ask, timeout=10).SerializeToString() == want
            csv = pb.GetFileMetadataParams(path="/x.csv", file_type="csv")
            with pytest.raises(grpc.RpcError) as e:
                stub.GetFileMetadata(csv, timeout=10)
            assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
            with pytest.raises(RuntimeError) as ref_e:
                RefServicer.GetFileMetadata(None, csv, _AbortContext())
            assert e.value.details() == ref_e.value.args[1]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def _free_port() -> int:
    import socket

    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        return so.getsockname()[1]


def _wait_for(proc, needle: str, timeout: float = 60) -> str:
    import time

    deadline = time.time() + timeout
    seen = ""
    while needle not in seen and time.time() < deadline and proc.poll() is None:
        seen += proc.stdout.readline()
    assert needle in seen, seen
    return seen


def _adapted_runs(cfg) -> list:
    """Two runs of one GROUP BY on a fresh standalone cluster with four
    shuffle partitions: the outcomes and sources of each job's AQE
    decisions (a tiny input's buckets are learned as a coalesce by the
    first run and applied at the second's submission)."""
    import numpy as np
    import pyarrow as pa

    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.scheduler import aqe

    settings = {**(cfg.settings() if cfg is not None else {}), "ballista.shuffle.partitions": "4"}
    aqe.reset_store()
    ctx = BallistaContext.standalone(BallistaConfig(settings), device="cpu")
    try:
        ctx.register_table("t", pa.table({"k": np.arange(200) % 7, "v": np.arange(200, dtype=np.float64)}))
        sched = ctx._standalone_cluster.scheduler
        out = []
        for _ in range(2):
            got = ctx.sql("SELECT k, SUM(v) AS s FROM t GROUP BY k").collect()
            assert got.num_rows == 7
            with sched._lock:
                job = max(sched.jobs.values(), key=lambda j: j.submitted_s)
            out.append({(d["outcome"], d["source"]) for d in job.aqe_decisions})
        return out
    finally:
        ctx.close()
        aqe.reset_store()


@pytest.mark.parametrize(
    "case",
    ["session aqe", "env BALLISTA_AQE", "rest port", "etcd backend", "system table", "plugin dir"],
)
def test_unported_features_are_refused_naming_their_item(case, monkeypatch, tmp_path):
    """Every feature of these cases has been ported since, and each runs
    and answers as the reference does: a scheduler's plugin directory,
    from its config or ``$BALLISTA_PLUGIN_DIR``, loaded at construction;
    AQE, turned on by a session key or by the
    process's ``BALLISTA_AQE=1`` (a cluster whose second run of a query
    applies the strategy its first run learned), with ``BALLISTA_AQE=0``
    overriding a session that asks for it; the scheduler process's REST
    port (``/api/state`` with the reference's keys), its etcd backend (a
    session saved under the reference's key, over the in-process fake
    etcd) and the system tables (``system.queries`` with the reference's
    schema)."""
    import re
    import signal
    import time

    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.scheduler.server import SchedulerServer

    if case == "session aqe":
        from ballista_tpu_torch.scheduler import aqe

        cfg = BallistaConfig({"ballista.tpu.aqe": "true"})
        server = SchedulerServer(provider=None, config=cfg)
        try:
            assert aqe.enabled(server.config) and isinstance(server.aqe, aqe.AqePolicy)
        finally:
            server.shutdown()
        assert _adapted_runs(cfg) == [{("learned", "reactive")}, {("applied", "learned")}]
    elif case == "env BALLISTA_AQE":
        monkeypatch.setenv("BALLISTA_AQE", "1")
        server = SchedulerServer(provider=None)
        try:
            from ballista_tpu_torch.scheduler import aqe

            assert aqe.enabled(server.config)
        finally:
            server.shutdown()
        assert _adapted_runs(None) == [{("learned", "reactive")}, {("applied", "learned")}]
        # the kill switch wins over a session that asks for AQE
        monkeypatch.setenv("BALLISTA_AQE", "0")
        assert _adapted_runs(BallistaConfig({"ballista.tpu.aqe": "true"})) == [set(), set()]
    elif case == "rest port":
        import json
        import urllib.request

        from ballista_tpu.scheduler.rest import scheduler_state as ref_state
        from ballista_tpu.scheduler.server import SchedulerServer as RefServer

        rest_port = _free_port()
        proc = _scheduler_process("--rest-port", str(rest_port))
        try:
            _wait_for(proc, f"REST /state on 127.0.0.1:{rest_port}")
            got = json.load(urllib.request.urlopen(f"http://127.0.0.1:{rest_port}/api/state", timeout=10))
            ref = RefServer(provider=None)
            try:
                want = ref_state(ref)
            finally:
                ref.shutdown()
            assert sorted(got) == sorted(want)
            assert (got["executors"], got["jobs"], got["policy"], got["version"]) == (
                want["executors"], want["jobs"], want["policy"], want["version"],
            )
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=10) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    elif case == "etcd backend":
        from ballista_tpu.client.context import BallistaContext as RefClient
        from ballista_tpu.scheduler.etcd_backend import EtcdBackend as RefEtcdBackend
        from ballista_tpu.scheduler.server import SchedulerServer as RefServer
        from ballista_tpu.scheduler.server import start_scheduler_grpc as ref_grpc
        from test_torch_ops_surface import FakeEtcd, serve_fake_etcd

        def sessions(fake, session_id):
            return sorted((k.replace(session_id.encode(), b"<id>"), v) for k, v in fake._kv.items())

        port_fake, ref_fake = FakeEtcd(), FakeEtcd()
        port_etcd, port_url = serve_fake_etcd(port_fake)
        ref_etcd, ref_url = serve_fake_etcd(ref_fake)
        proc = _scheduler_process("--state-backend", "etcd", "--etcd-urls", port_url)
        ref = RefServer(provider=None, state_backend=RefEtcdBackend(ref_url), namespace="ballista")
        ref_gs, ref_port = ref_grpc(ref, "127.0.0.1", 0)
        try:
            seen = _wait_for(proc, "gRPC on")
            assert "backend=etcd" in seen, seen
            port = int(re.search(r"gRPC on 127\.0\.0\.1:(\d+)", seen).group(1))
            client = BallistaContext.remote("127.0.0.1", port, device="cpu")
            ref_client = RefClient.remote("127.0.0.1", ref_port)
            try:
                got = sessions(port_fake, client.session_id)
                assert got and got == sessions(ref_fake, ref_client.session_id)
            finally:
                client.close()
                ref_client.close()
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=10) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            ref_gs.stop(grace=None)
            ref.shutdown()
            port_etcd.stop(grace=None)
            ref_etcd.stop(grace=None)
    elif case == "plugin dir":
        from ballista_tpu_torch.plugin import PLUGIN_DIR_ENV, global_registry

        for name in ("config", "env"):
            d = tmp_path / name
            d.mkdir()
            (d / f"sched_{name}.py").write_text(
                "import torch\n\ndef register(register_udf):\n"
                f"    register_udf('sched_{name}_udf', lambda x: torch.abs(x))\n"
            )
        monkeypatch.setenv(PLUGIN_DIR_ENV, str(tmp_path / "env"))
        try:
            server = SchedulerServer(
                provider=None, config=BallistaConfig({"ballista.plugin_dir": str(tmp_path / "config")})
            )
            server.shutdown()
            assert {"sched_config_udf", "sched_env_udf"} <= set(global_registry.names())
        finally:
            global_registry.clear()
    else:
        import pyarrow as pa

        from ballista_tpu.obs.history import QUERIES_SCHEMA as REF_QUERIES_SCHEMA

        ctx = BallistaContext.standalone(device="cpu")
        try:
            ctx.register_table("t", pa.table({"x": [1, 2]}))
            ctx.sql("select * from t").collect()
            # the scheduler records a job's terminal row just after the
            # client sees it complete
            deadline = time.time() + 30
            while True:
                got = ctx.sql("select * from system.queries").collect()
                if got.column("status").to_pylist() == ["completed"] or time.time() > deadline:
                    break
                time.sleep(0.05)
            assert got.column_names == [f.name for f in REF_QUERIES_SCHEMA]
            assert got.column("status").to_pylist() == ["completed"]
        finally:
            ctx.close()


@pytest.mark.gpu
def test_port_cluster_on_the_card_matches_collect():
    """Two port executors on the card (pull-staged, default settings): q1
    and q3 equal ``TorchContext(device="cuda")``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.tpch import gen_all

    data = gen_all(0.01, 42)
    local = TorchContext(device="cuda")
    dist = BallistaContext.standalone(device="cuda", n_executors=2, concurrent_tasks=2)
    try:
        for name, t in data.items():
            local.register_table(name, t)
            dist.register_table(name, t)
        for q in ("q1", "q3"):
            sql = (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text()
            want = local.sql(sql).collect()
            got = dist.sql(sql).collect()
            key = [(c, "ascending") for c in want.column_names]
            assert got.schema.equals(want.schema), q
            g, w = got.sort_by(key), want.sort_by(key)
            for c in w.column_names:
                if c in ("sum_base_price", "sum_disc_price", "sum_charge", "avg_price", "avg_disc"):
                    import numpy as np

                    np.testing.assert_allclose(g.column(c).to_numpy(), w.column(c).to_numpy(), rtol=1e-9)
                else:
                    assert g.column(c).equals(w.column(c)), (q, c)
    finally:
        dist.close()
