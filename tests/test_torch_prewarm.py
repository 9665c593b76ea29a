"""The port's kernel prewarm (``ballista_tpu_torch/compilecache/prewarm.py``
and ``registry.enumerate_prewarm``), the cases of
``tests/test_compile_cache.py``'s prewarm section and of
``tests/test_reswitness.py``'s prewarm cases: the modes and thread
hygiene, a failing signature is not fatal, the executor loops join their
prewarm on stop, the latch and the witness. The port's enumeration has a
counterpart of every reference signature, and each of its signatures runs
on the CPU (the kernels' plain versions there)."""

import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from ballista_tpu.compilecache import registry as ref_registry
from ballista_tpu_torch.analysis import reswitness
from ballista_tpu_torch.compilecache import metrics, prewarm, registry
from ballista_tpu_torch.compilecache.registry import PrewarmSignature
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.executor.executor import Executor, PollLoop
from ballista_tpu_torch.executor.executor_server import ExecutorServer

# the reference's program names -> the port's, by variant
_REF_TO_PORT = {"argsort": "ops.perm.stable_argsort", "take": "ops.perm.multi_key_perm",
                "compact": "ops.compact.compact"}


@pytest.fixture(autouse=True)
def fresh_latch():
    prewarm.reset_latch()
    yield
    prewarm.reset_latch()


@pytest.fixture
def small_ladder(monkeypatch):
    monkeypatch.setenv("BALLISTA_TPU_PREWARM_BUCKETS", "2048")


def _prewarm_threads():
    return [t for t in threading.enumerate() if t.name.startswith("compile-prewarm") and t.is_alive()]


def test_prewarm_modes_and_thread_hygiene():
    before = set(threading.enumerate())
    base = metrics.snapshot().get("prewarmed_signatures", 0)
    h = prewarm.start_prewarm("background", buckets=(2048,), device="cpu")
    assert h.n_signatures > 0
    assert h.join(timeout=240), "prewarm did not finish in time"
    done = metrics.snapshot().get("prewarmed_signatures", 0) - base
    assert done == h.n_signatures, (done, h.n_signatures)
    # latched: the same buckets on the same device again is a no-op handle
    assert prewarm.start_prewarm("background", buckets=(2048,), device="cpu").n_signatures == 0
    # off never spawns anything
    assert prewarm.start_prewarm("off", device="cpu").n_signatures == 0
    h.stop()  # idempotent after join
    leaked = [t for t in set(threading.enumerate()) - before if t.name.startswith("compile-prewarm")]
    assert not leaked, leaked


def test_on_blocks_until_every_signature_ran():
    base = metrics.snapshot().get("prewarmed_signatures", 0)
    h = prewarm.start_prewarm("on", buckets=(2048,), device="cpu")
    assert h.n_signatures == len(registry.enumerate_prewarm((2048,), device="cpu")) == 19
    assert metrics.snapshot()["prewarmed_signatures"] - base == h.n_signatures
    assert not _prewarm_threads()


def test_prewarm_failure_is_nonfatal():
    """A signature whose thunk raises only counts a failure: the query
    path never depends on prewarm having succeeded."""
    base = metrics.snapshot().get("prewarm_failures", 0)
    sig = PrewarmSignature(
        "ops.perm.stable_argsort", 2048, ("int64",), variant="boom",
        compile=lambda: (_ for _ in ()).throw(RuntimeError("boom")),
    )
    prewarm._run_one(sig)
    assert metrics.snapshot()["prewarm_failures"] == base + 1


def test_executor_server_joins_prewarm_on_stop(small_ladder):
    """PollLoop.stop with prewarm=background leaves no prewarm thread
    behind."""
    with tempfile.TemporaryDirectory() as wd:
        loop = PollLoop(
            Executor(executor_id="px", work_dir=wd, device="cpu"),
            "127.0.0.1:1",  # never dialed successfully: that's fine
            "127.0.0.1",
            0,
            prewarm="background",
        )
        loop.start()
        assert loop._prewarm.n_signatures == 19
        loop.stop()
    assert not _prewarm_threads()


def test_failed_server_startup_stops_its_prewarm(small_ladder):
    """ExecutorServer.startup against no scheduler raises, and the
    partial-startup teardown stops the prewarm pool it started."""
    with tempfile.TemporaryDirectory() as wd:
        server = ExecutorServer(
            Executor(executor_id="ps", work_dir=wd, device="cpu"), "127.0.0.1:1", "127.0.0.1", 0,
            prewarm="background",
        )
        with pytest.raises(Exception):
            server.startup("127.0.0.1", 0)
        assert server._prewarm is None
    assert not _prewarm_threads()


def test_loops_resolve_the_mode_as_the_reference(monkeypatch, tmp_path):
    from ballista_tpu.compilecache import prewarm as ref_prewarm

    ex = Executor("p", str(tmp_path), device="cpu")
    monkeypatch.delenv("BALLISTA_TPU_PREWARM", raising=False)
    for explicit in (None, "off", "on", "background"):
        want = ref_prewarm.resolve_mode(explicit)
        assert PollLoop(ex, "localhost:1", "localhost", 1, prewarm=explicit).prewarm_mode == want
        assert ExecutorServer(ex, "localhost:1", "localhost", 1, prewarm=explicit).prewarm_mode == want
    monkeypatch.setenv("BALLISTA_TPU_PREWARM", "background")
    assert PollLoop(ex, "localhost:1", "localhost", 1).prewarm_mode == "background"
    assert PollLoop(ex, "localhost:1", "localhost", 1, prewarm="off").prewarm_mode == "off"


@pytest.mark.parametrize("mode", ["on", "background"])
def test_context_starts_the_configured_prewarm(mode, small_ladder):
    base = metrics.snapshot().get("prewarmed_signatures", 0)
    ctx = TorchContext(BallistaConfig({"ballista.tpu.prewarm": mode}), device="cpu")
    assert ctx._prewarm.n_signatures == 19
    assert ctx._prewarm.join(timeout=240)
    assert metrics.snapshot()["prewarmed_signatures"] - base == 19
    # a second context in the process finds the latch set
    assert TorchContext(BallistaConfig({"ballista.tpu.prewarm": mode}), device="cpu")._prewarm.n_signatures == 0


def test_every_reference_signature_has_its_counterpart():
    """For buckets (2048, 4096), every key of the reference's enumeration
    (listed, not compiled) has its port counterpart; the port adds one
    signature per hand-written kernel and mode."""
    buckets = (2048, 4096)
    port = {s.key for s in registry.enumerate_prewarm(buckets, device="cpu")}
    ref = ref_registry.enumerate_prewarm(buckets)
    assert registry.PREWARM_DTYPES == ref_registry.PREWARM_DTYPES
    for s in ref:
        name = _REF_TO_PORT[s.variant.split(",")[0]]
        key = PrewarmSignature(name, s.capacity, s.dtypes, s.variant).key
        assert key in port, key
    kernels = {k for k in port if k.startswith("cuda.")}
    assert len(port) == len(ref) + len(kernels)
    assert {k.split("[")[0] for k in kernels} == {n for n, s in registry.PROGRAMS.items() if s.route == "cuda"}
    assert all(k.split("[")[0] in registry.PROGRAMS for k in port)


def test_every_port_signature_runs_on_the_cpu():
    for sig in registry.enumerate_prewarm((2048,), device="cpu"):
        sig.compile()


def test_unstopped_background_prewarm_releases_witness_on_drain(monkeypatch):
    """A context-started background prewarm is never stopped or joined;
    the witness entry releases itself once the last signature completes."""

    class _Sig:
        key = "fake"

        def compile(self):
            pass

    reswitness.reset()
    reswitness.enable(True)
    try:
        monkeypatch.setattr(registry, "enumerate_prewarm", lambda buckets, device: [_Sig(), _Sig()])
        handle = prewarm.start_prewarm("background", buckets=(2048,), device="cpu")
        assert handle.n_signatures == 2
        deadline = time.time() + 10
        while reswitness.live() and time.time() < deadline:
            time.sleep(0.05)
        reswitness.assert_drained()
        assert reswitness.acquired_counts().get("thread-pool") == 1
    finally:
        reswitness.enable(False)
        reswitness.reset()


def test_prewarm_latch_rolls_back_on_enumeration_failure(monkeypatch):
    calls = []

    def boom(buckets, device):
        calls.append(tuple(buckets))
        raise RuntimeError("bad ladder")

    monkeypatch.setattr(registry, "enumerate_prewarm", boom)
    with pytest.raises(RuntimeError):
        prewarm.start_prewarm("on", buckets=(2048,), device="cpu")
    # the latch must not hold "started" for work that never started
    with pytest.raises(RuntimeError):
        prewarm.start_prewarm("on", buckets=(2048,), device="cpu")
    assert len(calls) == 2


def test_executor_entry_runs_prewarm_on(tmp_path):
    """``python -m ballista_tpu_torch.executor --device cpu --prewarm on``
    runs the signatures at start (logged), then serves until SIGTERM."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "BALLISTA_TPU_PREWARM_BUCKETS": "2048",
           "BALLISTA_TPU_HINT_CACHE": "off"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.executor", "--device", "cpu", "--prewarm", "on",
         "--bind-port", "0", "--bind-grpc-port", "0", "--scheduler-port", "1",
         "--work-dir", str(tmp_path)],
        env=env, stderr=subprocess.PIPE, text=True,
    )
    lines = []
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            if "prewarm: 19 signatures in" in line:
                break
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines) + err
    assert "prewarm(on) on cpu: 19 signatures" in text, text[-3000:]
    assert "prewarm: 19 signatures in" in text, text[-3000:]
    assert proc.returncode == 0, text[-3000:]
