"""The profiler hook of the port: ``ballista.tpu.profile_dir`` wraps one
task attempt in ``torch.profiler`` and writes a TensorBoard trace there
(the cases of ``tests/test_profiling.py``, whose reference wraps the
attempt in ``jax.profiler.trace``). The profiler is one per process: with
two concurrent tasks the first is traced and the other runs untraced."""

import glob
import json
import os
import subprocess
import sys
import threading

import torch

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.exec.base import run_with_capacity_retry

SCRIPT = r"""
import glob
import json

import pyarrow as pa

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.exec.context import TorchContext

cfg = BallistaConfig({"ballista.tpu.profile_dir": TRACE_DIR})
ctx = TorchContext(cfg, device="cpu")
ctx.register_table("t", pa.table({"a": pa.array([1.0, 2.0, 3.0])}))
res = ctx.sql("select sum(a) s from t").collect()
assert res.to_pandas().s[0] == 6.0
traces = glob.glob(TRACE_DIR + "/**/*.pt.trace.json", recursive=True)
assert len(traces) == 1, traces
events = json.load(open(traces[0]))["traceEvents"]
cats = {e.get("cat") for e in events}
assert "cpu_op" in cats, sorted(map(str, cats))
print("PROFILE-TRACE-OK", sum(e.get("cat") == "cpu_op" for e in events))
"""


def test_profile_dir_writes_traces(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "BALLISTA_TPU_HINT_CACHE": "off"}
    script = f"TRACE_DIR = {str(tmp_path / 'prof')!r}\n" + SCRIPT
    proc = subprocess.run(
        [sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    assert "PROFILE-TRACE-OK" in proc.stdout


def test_concurrent_tasks_write_one_trace(tmp_path):
    """The first task holds the profiler; a task that starts while it runs
    is not traced and does not fail."""
    cfg = BallistaConfig({"ballista.tpu.profile_dir": str(tmp_path)})
    first_in, second_done = threading.Event(), threading.Event()
    out = {}

    def first(ctx):
        first_in.set()
        assert second_done.wait(60)
        return int(torch.arange(100).sum())

    def second(ctx):
        return int(torch.arange(10).sum())

    t = threading.Thread(
        target=lambda: out.setdefault("first", run_with_capacity_retry(cfg, first, device="cpu"))
    )
    t.start()
    assert first_in.wait(60)
    out["second"] = run_with_capacity_retry(cfg, second, device="cpu")
    second_done.set()
    t.join(60)
    assert not t.is_alive()
    assert out == {"first": 4950, "second": 45}
    traces = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(traces) == 1, traces
    assert json.load(open(traces[0]))["traceEvents"]
    # the profiler lock is free again: the next task is traced
    run_with_capacity_retry(cfg, second, device="cpu")
    assert len(glob.glob(str(tmp_path / "*.pt.trace.json"))) == 2


def test_no_profile_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert run_with_capacity_retry(BallistaConfig(), lambda ctx: 7, device="cpu") == 7
    assert os.listdir(tmp_path) == []
