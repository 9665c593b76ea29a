"""The port's executor against the reference's, on the CPU. The reference's
codec encodes each stage's ``TaskDefinition`` of q1, q3 and q12 (SF=0.002,
K = 4, with the internal props a scheduler stamps: the attempt and the
query class); the port's ``Executor(device="cpu")`` and the reference's
``Executor`` each run every task, the port's into its own work directory,
and write the same shuffle files bucket for bucket, with the same metas,
the same operator metric records (paths and operator names) and a cost
vector whose fields are set. Task statuses, the refusals (a root other
than ``ShuffleWriterExec``, UDF plugins), the prewarm modes, a session's capacity
ladder, the advertised devices and the process's flags are held to the
reference's."""

import pathlib

import pyarrow as pa
import pyarrow.ipc as paipc
import pytest
import torch

from ballista_tpu.config import BallistaConfig as RefConfig
from ballista_tpu.distributed_plan import DistributedPlanner as RefDistributedPlanner
from ballista_tpu.distributed_plan import remove_unresolved_shuffles as ref_remove_unresolved
from ballista_tpu.exec.context import TpuContext
from ballista_tpu.exec.planner import PhysicalPlanner as RefPlanner
from ballista_tpu.executor import __main__ as ref_main
from ballista_tpu.executor.executor import Executor as RefExecutor
from ballista_tpu.executor.executor import as_task_status as ref_as_task_status
from ballista_tpu.obs.history import CostVector as RefCostVector
from ballista_tpu.plan.optimizer import optimize as ref_optimize
from ballista_tpu.scheduler_types import PartitionLocation as RefLocation
from ballista_tpu.scheduler_types import ShuffleWritePartitionMeta as RefMeta
from ballista_tpu.serde import BallistaCodec as RefCodec
from ballista_tpu_torch.config import (
    BALLISTA_INTERNAL_QUERY_CLASS,
    BALLISTA_INTERNAL_TASK_ATTEMPT,
)
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.executor import __main__ as port_main
from ballista_tpu_torch.executor import visible_devices
from ballista_tpu_torch.executor.executor import (
    Executor,
    PollLoop,
    TaskRunOutput,
    as_task_status,
)
from ballista_tpu_torch.executor.executor_server import ExecutorServer
from ballista_tpu_torch.obs.history import COST_KEYS, CostVector
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler_types import ShuffleWritePartitionMeta
from ballista_tpu_torch.tpch import gen_all, spec_substitutions
from test_torch_tpch import cmp

QDIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "queries"
SCALE = 0.002
K = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: in a parallel test run every worker's intra-op
    pool would oversubscribe the cores (see test_torch_repartition.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def env():
    data = gen_all(SCALE, 42)
    ref, port = TpuContext(), TorchContext(device="cpu")
    for name, t in data.items():
        ref.register_table(name, t)
        port.register_table(name, t)
    return data, ref, port


def query_sql(q: str, data) -> str:
    sql = (QDIR / f"{q}.sql").read_text()
    for old, new in spec_substitutions(q, data).items():
        sql = sql.replace(old, new)
    return sql


def task_def(plan_bytes: bytes, job: str, stage: int, part: int, props: dict) -> pb.TaskDefinition:
    return pb.TaskDefinition(
        task_id=pb.PartitionId(job_id=job, stage_id=stage, partition_id=part),
        plan=plan_bytes,
        props=[pb.KeyValuePair(key=k, value=v) for k, v in props.items()],
        session_id="session-1",
    )


def _files(root: pathlib.Path) -> dict:
    out = {}
    for p in sorted(root.rglob("*.arrow")):
        with pa.memory_map(str(p)) as src:
            out[p.relative_to(root).as_posix()] = paipc.open_file(src).read_all()
    return out


def _locations(metas, job, stage, map_part, work, parts):
    for m in metas:
        parts[m.partition_id].append(
            RefLocation(job, stage, m.partition_id, "e", "localhost", 0, m.path, map_partition=map_part)
        )


@pytest.mark.parametrize("q", ["q1", "q3", "q12"])
def test_executor_writes_the_reference_executors_files(env, q, tmp_path):
    """Every task of the query, encoded by the reference's codec with the
    scheduler's internal props, run by both executors: the same metas
    (bucket, rows, batches), the same files bucket for bucket (floats
    within rtol 1e-9), the same operator metric records, and a cost vector
    with wall, CPU and shuffle bytes set."""
    data, ref, port = env
    job = f"job-{q}"
    props = {
        "ballista.shuffle.partitions": str(K),
        BALLISTA_INTERNAL_TASK_ATTEMPT: "0",
        BALLISTA_INTERNAL_QUERY_CLASS: q,
    }
    cfg = RefConfig().with_setting("ballista.shuffle.partitions", str(K))
    plan = RefPlanner(ref, K, config=cfg, distributed=True).plan(
        ref_optimize(ref.sql_to_logical(query_sql(q, data)))
    )
    stages = RefDistributedPlanner().plan_query_stages(job, plan)
    codec = RefCodec(provider=ref)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_exec = RefExecutor("ref-exec", str(ref_dir), provider=ref)
    port_exec = Executor("port-exec", str(port_dir), provider=port, device="cpu")
    assert port_exec.device == torch.device("cpu")
    ref_locs: dict = {}
    port_locs: dict = {}
    for stage in stages:
        ref_parts = [[] for _ in range(stage.output_partition_count)]
        port_parts = [[] for _ in range(stage.output_partition_count)]
        ref_bytes = codec.physical_to_proto(ref_remove_unresolved(stage.plan, ref_locs)).SerializeToString()
        port_bytes = codec.physical_to_proto(ref_remove_unresolved(stage.plan, port_locs)).SerializeToString()
        if not ref_locs:  # the scan stages read no file: one set of bytes
            assert ref_bytes == port_bytes
        for p in range(stage.input_partition_count):
            want = ref_exec.execute_shuffle_write(task_def(ref_bytes, job, stage.stage_id, p, props))
            got = port_exec.execute_shuffle_write(task_def(port_bytes, job, stage.stage_id, p, props))
            assert isinstance(got, TaskRunOutput)
            assert [(m.partition_id, m.num_rows, m.num_batches, m.push) for m in got] == [
                (m.partition_id, m.num_rows, m.num_batches, m.push) for m in want
            ]
            assert [m.path.replace(str(port_dir), "") for m in got] == [
                m.path.replace(str(ref_dir), "") for m in want
            ]
            assert [(r["path"], r["operator"]) for r in got.operator_metrics] == [
                (r["path"], r["operator"]) for r in want.operator_metrics
            ]
            rows = {r["path"]: r["counters"].get("output_rows") for r in got.operator_metrics}
            assert rows == {r["path"]: r["counters"].get("output_rows") for r in want.operator_metrics}
            cost = got.cost
            assert cost.wall_seconds > 0 and cost.cpu_seconds > 0
            assert cost.shuffle_write_bytes == sum(m.num_bytes for m in got)
            assert (cost.shuffle_read_bytes > 0) == (want.cost.shuffle_read_bytes > 0)
            _locations(want, job, stage.stage_id, p, ref_dir, ref_parts)
            _locations(got, job, stage.stage_id, p, port_dir, port_parts)
        ref_locs[stage.stage_id] = ref_parts
        port_locs[stage.stage_id] = port_parts
    ref_files, port_files = _files(ref_dir), _files(port_dir)
    assert sorted(port_files) == sorted(ref_files) and ref_files
    for path, want_t in ref_files.items():
        assert port_files[path].schema.equals(want_t.schema), path
        cmp(port_files[path].to_pandas(), want_t.to_pandas())


def test_executor_refusals_match_the_reference(env, tmp_path):
    """A plan whose root is not a ShuffleWriterExec raises ExecutionError in
    both executors; a session that sets a plugin directory has each task
    load it before the decode (the port's plugin in torch, the reference's
    in jax), and the plan's error is still the reference's. A session that
    sets the capacity ladder installs it in both executors, whose tasks
    write the same metas and files under it."""
    from ballista_tpu.columnar.batch import capacity_ladder as ref_ladder
    from ballista_tpu.columnar.batch import set_capacity_buckets as ref_set_buckets
    from ballista_tpu_torch.columnar.batch import capacity_ladder, set_capacity_buckets

    data, ref, port = env
    scan = ref.create_physical_plan(ref_optimize(ref.sql_to_logical("SELECT n_name FROM nation")))
    bad = task_def(RefCodec(provider=ref).physical_to_proto(scan).SerializeToString(), "j", 1, 0, {})
    ref_exec = RefExecutor("r", str(tmp_path / "r"), provider=ref)
    with pytest.raises(Exception, match="task plan root must be ShuffleWriterExec") as want:
        ref_exec.execute_shuffle_write(bad)
    port_exec = Executor("p", str(tmp_path / "p"), provider=port, device="cpu")
    with pytest.raises(ExecutionError, match="task plan root must be ShuffleWriterExec") as got:
        port_exec.execute_shuffle_write(bad)
    assert str(got.value) == str(want.value)
    from ballista_tpu.plugin import global_registry as ref_registry
    from ballista_tpu_torch.plugin import global_registry

    dirs = {}
    for side, lib in (("port", "torch"), ("ref", "jax.numpy")):
        d = dirs[side] = tmp_path / f"plugins-{side}"
        d.mkdir()
        (d / "task_fns.py").write_text(
            f"import {lib} as m\n\ndef register(register_udf):\n"
            "    register_udf('executor_task_udf', lambda x: m.abs(x))\n"
        )
    try:
        for ex, side, err in ((ref_exec, "ref", Exception), (port_exec, "port", ExecutionError)):
            with pytest.raises(err, match="task plan root must be ShuffleWriterExec"):
                ex.execute_shuffle_write(task_def(bad.plan, "j", 1, 0, {"ballista.plugin_dir": str(dirs[side])}))
        assert ref_registry.get("executor_task_udf") is not None
        assert global_registry.get("executor_task_udf") is not None
    finally:
        global_registry.clear()
        ref_registry.clear()
    # the capacity ladder: the first stage of a grouped scan under 4096:4
    props = {"ballista.shuffle.partitions": str(K), "ballista.tpu.capacity_buckets": "4096:4"}
    cfg = RefConfig(props)
    plan = RefPlanner(ref, K, config=cfg, distributed=True).plan(ref_optimize(ref.sql_to_logical(
        "SELECT l_returnflag, COUNT(*) AS n, SUM(l_quantity) AS q FROM lineitem GROUP BY l_returnflag"
    )))
    stage = RefDistributedPlanner().plan_query_stages("jl", plan)[0]
    plan_bytes = RefCodec(provider=ref).physical_to_proto(stage.plan).SerializeToString()
    specs = ref_ladder().spec(), capacity_ladder().spec()
    try:
        for p in range(stage.input_partition_count):
            want = ref_exec.execute_shuffle_write(task_def(plan_bytes, "jl", stage.stage_id, p, props))
            got = port_exec.execute_shuffle_write(task_def(plan_bytes, "jl", stage.stage_id, p, props))
            assert [(m.partition_id, m.num_rows, m.num_batches) for m in got] == [
                (m.partition_id, m.num_rows, m.num_batches) for m in want
            ]
        assert capacity_ladder().spec() == ref_ladder().spec() == "4096:4"
    finally:
        ref_set_buckets(specs[0])
        set_capacity_buckets(specs[1])
    ref_files, port_files = _files(tmp_path / "r"), _files(tmp_path / "p")
    assert sorted(port_files) == sorted(ref_files) and ref_files
    for path, want_t in ref_files.items():
        cmp(port_files[path].to_pandas(), want_t.to_pandas())


def _status_inputs(pkg):
    meta, cost = (ShuffleWritePartitionMeta, CostVector) if pkg == "port" else (RefMeta, RefCostVector)
    metas = [meta(0, "/w/j/2/0/data-1.arrow", 2, 10, 4096), meta(3, "/w/j/2/3/push-1.arrow", 1, 5, 800, push=True)]
    records = [
        {"path": "0", "operator": "ShuffleWriterExec", "describe": "w", "counters": {"output_rows": 15, "write_time": 0.5}},
        {"path": "0.0", "operator": "MemoryScanExec", "describe": "s", "counters": {"output_rows": 15}},
    ]
    c = cost(wall_seconds=1.5, cpu_seconds=0.25, shuffle_read_bytes=7, shuffle_write_bytes=4896, compile_seconds=0.125)
    return metas, records, c


@pytest.mark.parametrize("outcome", ["completed", "failed", "bare metas"])
def test_task_status_is_the_reference_proto(outcome):
    from ballista_tpu.executor.executor import TaskRunOutput as RefTaskRunOutput

    task_id = pb.PartitionId(job_id="j", stage_id=2, partition_id=1)
    got_in, want_in = _status_inputs("port"), _status_inputs("ref")
    if outcome == "completed":
        got = as_task_status(task_id, "e0", TaskRunOutput(got_in[0], got_in[1], got_in[2]), None)
        want = ref_as_task_status(task_id, "e0", RefTaskRunOutput(want_in[0], want_in[1], want_in[2]), None)
    elif outcome == "failed":
        got = as_task_status(task_id, "e0", [], "ExecutionError: boom\n" + "x" * 5000, cost=got_in[2])
        want = ref_as_task_status(task_id, "e0", [], "ExecutionError: boom\n" + "x" * 5000, cost=want_in[2])
    else:
        got = as_task_status(task_id, "e0", got_in[0], None)
        want = ref_as_task_status(task_id, "e0", want_in[0], None)
    assert got.SerializeToString() == want.SerializeToString()
    assert got.WhichOneof("status") == ("failed" if outcome == "failed" else "completed")


def test_cost_vector_keys_are_the_reference_keys():
    from ballista_tpu.obs.history import COST_KEYS as REF_COST_KEYS

    assert COST_KEYS == REF_COST_KEYS


def test_executor_advertises_one_device(monkeypatch):
    """An executor advertises its mesh's shard count: one device without
    ``BALLISTA_TPU_MESH_SHARDS``, keeping its task slots, and N with it,
    running one task at a time (the reference's rule: a mesh is one
    resource)."""
    from ballista_tpu_torch.executor import effective_task_slots

    monkeypatch.delenv("BALLISTA_TPU_MESH_SHARDS", raising=False)
    assert visible_devices() == 1
    assert effective_task_slots(4) == 4
    monkeypatch.setenv("BALLISTA_TPU_MESH_SHARDS", "8")
    assert visible_devices() == 8
    assert effective_task_slots(4) == 1
    assert effective_task_slots(1) == 1
    monkeypatch.setenv("BALLISTA_TPU_MESH_SHARDS", "0")
    with pytest.raises(ValueError, match="BALLISTA_TPU_MESH_SHARDS"):
        visible_devices()


def test_loops_accept_only_prewarm_off(tmp_path, monkeypatch):
    """The prewarm is ported: the loops take every mode the reference's
    take (``off``, ``on``, ``background``; default off) and start it with
    the loop (tests/test_torch_prewarm.py runs them)."""
    monkeypatch.delenv("BALLISTA_TPU_PREWARM", raising=False)
    ex = Executor("p", str(tmp_path), device="cpu")
    assert PollLoop(ex, "localhost:1", "localhost", 1, prewarm="off").prewarm_mode == "off"
    assert PollLoop(ex, "localhost:1", "localhost", 1).prewarm_mode == "off"
    for mode in ("on", "background"):
        assert PollLoop(ex, "localhost:1", "localhost", 1, prewarm=mode).prewarm_mode == mode
        assert ExecutorServer(ex, "localhost:1", "localhost", 1, prewarm=mode).prewarm_mode == mode


def _flags(parser) -> dict:
    return {
        a.option_strings[0]: (a.default, tuple(a.choices) if a.choices else None)
        for a in parser._actions
        if a.option_strings and a.option_strings[0] != "-h"
    }


def test_executor_process_flags_are_the_references_and_device(monkeypatch):
    """``python -m ballista_tpu_torch.executor`` takes the reference's flags
    with the reference's defaults, plus ``--device`` (default cuda)."""
    for k in list(__import__("os").environ):
        if k.startswith("BALLISTA_EXECUTOR_") or k == "BALLISTA_TPU_PREWARM":
            monkeypatch.delenv(k)
    want, got = _flags(ref_main.build_parser()), _flags(port_main.build_parser())
    assert got.pop("--device") == ("cuda", None)
    assert got == want


@pytest.mark.gpu
def test_executor_on_card_writes_the_cpu_executors_files(env, tmp_path):
    """``Executor(device="cuda")`` runs q12's tasks on the card and writes
    the files the CPU executor writes (floats within rtol 1e-9)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    data, ref, port = env
    card = TorchContext(device="cuda")
    for name, t in data.items():
        card.register_table(name, t)
    job = "job-card"
    props = {"ballista.shuffle.partitions": str(K)}
    cfg = RefConfig().with_setting("ballista.shuffle.partitions", str(K))
    plan = RefPlanner(ref, K, config=cfg, distributed=True).plan(
        ref_optimize(ref.sql_to_logical(query_sql("q12", data)))
    )
    codec = RefCodec(provider=ref)
    stages = RefDistributedPlanner().plan_query_stages(job, plan)
    runs = {}
    for dev, provider in (("cpu", port), ("cuda", card)):
        ex = Executor(f"e-{dev}", str(tmp_path / dev), provider=provider, device=dev)
        assert ex.device.type == dev
        locs: dict = {}
        for stage in stages:
            wire = codec.physical_to_proto(ref_remove_unresolved(stage.plan, locs)).SerializeToString()
            parts = [[] for _ in range(stage.output_partition_count)]
            for p in range(stage.input_partition_count):
                out = ex.execute_shuffle_write(task_def(wire, job, stage.stage_id, p, props))
                assert out.cost.wall_seconds > 0 and out.operator_metrics
                _locations(out, job, stage.stage_id, p, tmp_path / dev, parts)
            locs[stage.stage_id] = parts
        runs[dev] = _files(tmp_path / dev)
    assert sorted(runs["cuda"]) == sorted(runs["cpu"]) and runs["cpu"]
    for path, want in runs["cpu"].items():
        assert runs["cuda"][path].schema.equals(want.schema), path
        cmp(runs["cuda"][path].to_pandas(), want.to_pandas())


def test_stats_are_exact_under_threads():
    """Task threads share the shuffle, spill and reader stats: eight
    threads adding at once lose no increment."""
    import sys
    import threading

    from ballista_tpu_torch.exec import spill
    from ballista_tpu_torch.executor import reader, shuffle

    spill.reset_stats(shuffle.stats)
    reader.reset_stats()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(2000):
            spill.add_stats(shuffle.stats, batches=1, ipc_s=0.5)
            reader.add_stats(flight_batches=1, flight_bytes=3)

    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert shuffle.stats["batches"] == 16000 and shuffle.stats["ipc_s"] == 8000.0
    assert reader.stats["flight_batches"] == 16000 and reader.stats["flight_bytes"] == 48000
    spill.reset_stats(shuffle.stats)
    reader.reset_stats()
