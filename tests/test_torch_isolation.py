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
            "executor/reader.py",
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

    schema = Schema([Field("x", DataType.INT64, False)])
    table = pa.table({"x": pa.array([1, 2, 3], pa.int64())})
    x = np.arange(2048, dtype=np.int64)
    return {
        "TaskContext": lambda **kw: TaskContext(**kw).device,
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
    ["TaskContext", "batch_from_numpy", "from_host", "empty", "batch_from_arrow",
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
