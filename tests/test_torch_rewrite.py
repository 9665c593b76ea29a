"""Certified plan rewrites of the port (``ballista_tpu_torch/rewrite.py``)
held against the reference's (``ballista_tpu/rewrite.py``).

The cases of ``tests/test_rewrite.py``, each run through both packages on
the same TPC-H tables (SF=0.001, seed 42): every typed op over a stage DAG
must give the reference's verdict (the certificate's clause names, which
clause failed, the exactness class, the stages it rewrote, added and
removed) and rewritten stage plans whose ``display()`` equals the
reference's. The port's rewritten stages then run through the staged path
on the CPU and must equal its unrewritten run at the certificate's class:
``bit-exact`` ops bit for bit; ``multiset-exact`` ops with every non-float
column exact, q3's money sum ``revenue`` (an exact decimal sum) bit for
bit and other floats within rtol 1e-9."""

import os
import pathlib
import tempfile
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu import rewrite as ref_rw
from ballista_tpu.config import BallistaConfig as RefConfig
from ballista_tpu.distributed_plan import DistributedPlanner as RefDistributedPlanner
from ballista_tpu.distributed_plan import QueryStage as RefQueryStage
from ballista_tpu.distributed_plan import find_unresolved_shuffles as ref_find_unresolved
from ballista_tpu.errors import RewriteRejected as RefRewriteRejected
from ballista_tpu.exec.context import TpuContext
from ballista_tpu.exec.joins import HashJoinExec as RefHashJoinExec
from ballista_tpu.exec.planner import PhysicalPlanner as RefPlanner
from ballista_tpu.plan.logical import JoinType as RefJoinType
from ballista_tpu.plan.optimizer import optimize as ref_optimize
from ballista_tpu_torch import rewrite as rw
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.distributed_plan import (
    DistributedPlanner,
    QueryStage,
    find_unresolved_shuffles,
    remove_unresolved_shuffles,
)
from ballista_tpu_torch.errors import RewriteRejected, error_is_retryable
from ballista_tpu_torch.exec.base import run_with_capacity_retry
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.exec.joins import HashJoinExec
from ballista_tpu_torch.exec.planner import PhysicalPlanner
from ballista_tpu_torch.executor.reader import fetch_partition_table
from ballista_tpu_torch.plan.logical import JoinType
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.scheduler_types import PartitionLocation
from ballista_tpu_torch.tpch import gen_all

QUERIES_DIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "queries"
SCALE = 0.001
# money sums the port takes through its exact decimal path: bit for bit
# under every rewrite, multiset-exact ones included
EXACT_MONEY = {"q3": {"revenue"}}

REF = types.SimpleNamespace(
    rw=ref_rw, HashJoinExec=RefHashJoinExec, JoinType=RefJoinType,
    find_unresolved=ref_find_unresolved, Rejected=RefRewriteRejected,
)
PORT = types.SimpleNamespace(
    rw=rw, HashJoinExec=HashJoinExec, JoinType=JoinType,
    find_unresolved=find_unresolved_shuffles, Rejected=RewriteRejected,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: in a parallel test run every worker's intra-op
    pool would oversubscribe the cores (see test_torch_repartition.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data():
    return gen_all(SCALE, 42)


def _contexts(data, settings: dict):
    ref = TpuContext(RefConfig(dict(settings)))
    port = TorchContext(BallistaConfig(dict(settings)), device="cpu")
    for name, t in data.items():
        ref.register_table(name, t)
        port.register_table(name, t)
    return ref, port


@pytest.fixture(scope="module")
def ctxs(data):
    return _contexts(data, {})


@pytest.fixture(scope="module")
def collect_ctxs(data):
    """Same tables with repartition disabled: the planner then emits
    COLLECT-mode hash joins, the build-side-flip op's target shape."""
    return _contexts(data, {"ballista.repartition.joins": "false"})


def build_stages(ctx, qi: int, job_id: str | None = None):
    sql = (QUERIES_DIR / f"q{qi}.sql").read_text()
    if isinstance(ctx, TorchContext):
        dist = PhysicalPlanner(ctx, 2, config=ctx.config, distributed=True).plan(
            optimize(ctx.sql_to_logical(sql))
        )
        return DistributedPlanner().plan_query_stages(job_id or f"job-q{qi}", dist)
    dist = RefPlanner(ctx, 2, config=ctx.config, distributed=True).plan(
        ref_optimize(ctx.sql_to_logical(sql))
    )
    return RefDistributedPlanner().plan_query_stages(job_id or f"job-q{qi}", dist)


def both_stages(pair, qi: int):
    ref, port = pair
    return build_stages(ref, qi), build_stages(port, qi)


def run_stages(stages, config, work_dir) -> pa.Table | None:
    """Mini in-process stage runner on the CPU: execute each stage's writer
    per input partition into ``work_dir``, resolve consumers against the
    written locations (the scheduler's ``remove_unresolved_shuffles``
    path), and fetch the terminal stage's single output partition."""
    locations: dict[int, list[list[PartitionLocation]]] = {}
    for stage in stages:
        unresolved = find_unresolved_shuffles(stage.plan)
        plan = stage.plan
        if unresolved:
            plan = remove_unresolved_shuffles(
                stage.plan, {u.stage_id: locations[u.stage_id] for u in unresolved}
            )
        locs: list[list[PartitionLocation]] = [[] for _ in range(stage.output_partition_count)]
        for p in range(plan.input.output_partitioning().n):
            out = run_with_capacity_retry(
                config,
                lambda c, p=p, plan=plan: plan.execute_shuffle_write(p, c),
                work_dir=work_dir,
                job_id=stage.job_id,
                device="cpu",
            )
            for m in out:
                locs[m.partition_id].append(
                    PartitionLocation(
                        job_id=stage.job_id, stage_id=stage.stage_id, partition=m.partition_id,
                        executor_id="local", host="localhost", port=0, path=m.path,
                    )
                )
        locations[stage.stage_id] = locs
    tables = [fetch_partition_table(loc) for loc in locations[stages[-1].stage_id][0]]
    nonempty = [t for t in tables if t.num_rows]
    use = nonempty or tables
    return pa.concat_tables(use) if use else None


def assert_equivalent(base, got, exactness: str, what: str, exact_cols=()) -> None:
    assert (base is None) == (got is None), what
    if base is None:
        return
    assert base.schema.names == got.schema.names, what
    bd = base.to_pandas()
    gd = got.to_pandas()
    assert len(bd) == len(gd), f"{what}: row count {len(bd)} vs {len(gd)}"
    cols = list(bd.columns)
    nonfloat = [c for c in cols if bd[c].dtype.kind not in "fc"]
    floats = [c for c in cols if c not in nonfloat]
    order = nonfloat + floats
    bd = bd.sort_values(order).reset_index(drop=True)
    gd = gd.sort_values(order).reset_index(drop=True)
    for c in nonfloat:
        assert bd[c].equals(gd[c]), f"{what}: column {c} differs"
    for c in floats:
        if exactness == rw.BIT_EXACT or c in exact_cols:
            assert bd[c].to_numpy().tobytes() == gd[c].to_numpy().tobytes(), (
                f"{what}: float column {c} not bit-exact"
            )
        else:
            np.testing.assert_allclose(
                gd[c].to_numpy(), bd[c].to_numpy(), rtol=1e-9, atol=1e-12, err_msg=f"{what}: column {c}"
            )


def enumerate_ops(ns, stages, per_family_cap: int | None = None):
    """Every syntactically-addressable typed op of ``ns``'s package over a
    stage DAG (ops may still raise op-applicability rejections — that is
    part of the contract under test)."""
    ops = []
    for st in stages:
        joins = ns.rw.find_nodes(st.plan, lambda p: isinstance(p, ns.HashJoinExec))
        n_part = 0
        for i, j in enumerate(joins):
            if j.partition_mode == "partitioned":
                ops.append(ns.rw.SwitchToBroadcast(st.stage_id, n_part))
                n_part += 1
            elif j.join_type.value == "inner":
                ops.append(ns.rw.FlipJoinBuildSide(st.stage_id, i))
        if ns.find_unresolved(st.plan):
            ops.append(ns.rw.CoalesceShufflePartitions(st.stage_id, 1))
            ops.append(ns.rw.SplitShufflePartitions(st.stage_id, 3))
        ops.append(ns.rw.InjectExchange(st.stage_id, 0))
    for st in stages[:-1]:
        if not st.plan.partition_keys and st.plan.output_partitions == 1:
            ops.append(ns.rw.RemoveExchange(st.stage_id))
    if per_family_cap is not None:
        seen: dict = {}
        capped = []
        for op in ops:
            k = type(op).__name__
            if seen.get(k, 0) < per_family_cap:
                capped.append(op)
                seen[k] = seen.get(k, 0) + 1
        return capped
    return ops


def verdict(ns, stages, op, job_id: str):
    """The comparable outcome of one op: the op, then either the failing
    clause or the certificate's clauses, class and touched stages with
    the rewritten DAG's plans as displayed (job ids normalized)."""
    try:
        res = ns.rw.apply_rewrite(stages, op, job_id=job_id)
    except ns.Rejected as e:
        return (op.describe(), "rejected", e.clause, tuple(e.stage_ids or ())), None
    cert = res.certificate
    shown = tuple((s.stage_id, s.plan.display().replace(job_id, "JOB")) for s in res.stages)
    return (
        op.describe(), "ok", tuple((c.name, c.ok) for c in cert.clauses), cert.exactness,
        cert.rewritten_stages, cert.added_stages, cert.removed_stages,
        cert.bucket_changed_stages, shown,
    ), res


def verdicts_match(pair_stages, qi: int, per_family_cap=None):
    """Verdicts of every op over q``qi``'s DAG, port against reference;
    returns the port's (op, verdict, result) triples."""
    ref_stages, port_stages = pair_stages
    ref_ops = enumerate_ops(REF, ref_stages, per_family_cap)
    port_ops = enumerate_ops(PORT, port_stages, per_family_cap)
    assert [o.describe() for o in port_ops] == [o.describe() for o in ref_ops]
    out = []
    for rop, pop in zip(ref_ops, port_ops):
        want, _ = verdict(REF, ref_stages, rop, f"job-q{qi}")
        got, res = verdict(PORT, port_stages, pop, f"job-q{qi}")
        assert got == want, f"q{qi} {pop.describe()}:\nport {got}\nref  {want}"
        out.append((pop, got, res))
    return out


def sweep_query(pair, qi: int, per_family_cap: int | None) -> dict:
    ref, port = pair
    stages = both_stages(pair, qi)
    with tempfile.TemporaryDirectory() as d:
        base = run_stages(stages[1], port.config, os.path.join(d, "base"))
    counts = {"certified": 0, "inapplicable": 0}
    for op, v, res in verdicts_match(stages, qi, per_family_cap):
        if res is None:
            # op-applicability = the op has no target here;
            # float-sensitivity = a ULP-drift-exposed float equality
            # downstream (the q15 total_revenue = max(...) shape)
            assert v[2] in ("op-applicability", "float-sensitivity"), f"q{qi} {op}: {v}"
            counts["inapplicable"] += 1
            continue
        cert = res.certificate
        assert cert.ok and cert.failing is None
        assert tuple(c.name for c in cert.clauses) == rw.CERT_CLAUSES
        with tempfile.TemporaryDirectory() as d:
            got = run_stages(res.stages, port.config, os.path.join(d, "rw"))
        assert_equivalent(base, got, cert.exactness, f"q{qi} {op}", EXACT_MONEY.get(f"q{qi}", ()))
        counts["certified"] += 1
    return counts


def test_q3_every_op_family_certifies(ctxs, collect_ctxs):
    """Every addressable op over q3, partitioned and collect-mode: the
    port's verdicts equal the reference's, and each of the six op
    families certifies at least once."""
    certified: set = set()
    for pair in (ctxs, collect_ctxs):
        for op, v, res in verdicts_match(both_stages(pair, 3), 3):
            if res is not None:
                certified.add(type(op))
            else:
                assert v[2] == "op-applicability", f"{op}: {v}"
    assert certified == {
        rw.FlipJoinBuildSide, rw.SwitchToBroadcast, rw.CoalesceShufflePartitions,
        rw.SplitShufflePartitions, rw.InjectExchange, rw.RemoveExchange,
    }, certified


def test_q3_rewrites_execute_equivalently(ctxs):
    counts = sweep_query(ctxs, 3, per_family_cap=1)
    assert counts["certified"] >= 4, counts


def test_q3_flip_executes_equivalently(collect_ctxs):
    """Build-side flip end to end: the flipped+reprojected join must
    produce the same result multiset as the original (collect-mode
    planning — the flip's target shape)."""
    ref, port = collect_ctxs
    stages = both_stages(collect_ctxs, 3)
    with tempfile.TemporaryDirectory() as d:
        base = run_stages(stages[1], port.config, os.path.join(d, "base"))
    ran = 0
    for op, v, res in verdicts_match(stages, 3):
        if not isinstance(op, rw.FlipJoinBuildSide) or res is None:
            continue
        with tempfile.TemporaryDirectory() as d:
            got = run_stages(res.stages, port.config, os.path.join(d, "rw"))
        assert_equivalent(base, got, res.certificate.exactness, f"q3 {op}", EXACT_MONEY["q3"])
        ran += 1
        if ran >= 2:
            break
    assert ran >= 1, "no flip executed"


def test_q6_exchange_ops_bit_exact(ctxs):
    counts = sweep_query(ctxs, 6, per_family_cap=2)
    assert counts["certified"] >= 2, counts


@pytest.mark.slow
@pytest.mark.parametrize("qi", list(range(1, 23)))
def test_full_tpch_rewrite_sweep(ctxs, qi):
    counts = sweep_query(ctxs, qi, per_family_cap=1)
    # every query admits at least the exchange-injection op
    assert counts["certified"] >= 1, counts


def test_q15_float_equality_guard(ctxs):
    """q15 filters on ``total_revenue = (select max(...))`` — a float
    EQUALITY over aggregated values. The float-sensitivity clause must
    reject every multiset-exact op whose exposed region feeds that
    comparison, as the reference's does, while bit-exact exchange ops
    still certify."""
    verdicts = {op: v for op, v, _ in verdicts_match(both_stages(ctxs, 15), 15)}
    float_rejects = [op for op, v in verdicts.items() if v[1] == "rejected" and v[2] == "float-sensitivity"]
    assert float_rejects, f"no float-sensitivity rejection on q15: {verdicts}"
    assert all(
        isinstance(
            op,
            (rw.CoalesceShufflePartitions, rw.SplitShufflePartitions, rw.SwitchToBroadcast, rw.FlipJoinBuildSide),
        )
        for op in float_rejects
    )
    # bit-exact ops stay certifiable on the same query
    assert any(v[1] == "ok" and v[3] == rw.BIT_EXACT for v in verdicts.values()), verdicts


# -- certificates & rejection -------------------------------------------------


def _schema_breaking(ns_stage, ProjectionExec, ShuffleWriterExec, L):
    """An op that drops the terminal stage's last column — the
    schema-equivalence clause must catch it BEFORE scheduling."""

    class _SchemaBreakingOp(ns_stage.RewriteOp):
        stage_id = -1

        def apply(self, stages):
            last = stages[-1]
            names = last.plan.schema().names[:-1]
            proj = ProjectionExec(last.plan.input, [L.Column(n) for n in names])
            writer = ShuffleWriterExec(last.job_id, last.stage_id, proj, [], 1)
            return stages[:-1] + [ns_stage.QueryStage(last.job_id, last.stage_id, writer)]

        def describe(self):
            return "_SchemaBreakingOp()"

    return _SchemaBreakingOp()


def _bucket_desync(ns_stage, ShuffleWriterExec):
    """An op that re-buckets one keyed producer WITHOUT fixing its readers —
    the partition-compat clause must name the violated pair."""

    class _BucketDesyncOp(ns_stage.RewriteOp):
        stage_id = -1

        def apply(self, stages):
            for st in stages:
                w = st.plan
                if w.partition_keys:
                    bad = ShuffleWriterExec(
                        st.job_id, st.stage_id, w.input, list(w.partition_keys), w.output_partitions + 3
                    )
                    return [
                        ns_stage.QueryStage(st.job_id, st.stage_id, bad) if s.stage_id == st.stage_id else s
                        for s in stages
                    ]
            raise AssertionError("query has no keyed producer stage")

        def describe(self):
            return "_BucketDesyncOp()"

    return _BucketDesyncOp()


def _bad_ops():
    from ballista_tpu.exec.pipeline import ProjectionExec as RefProjectionExec
    from ballista_tpu.executor.shuffle import ShuffleWriterExec as RefShuffleWriterExec
    from ballista_tpu.expr import logical as RefL
    from ballista_tpu_torch.exec.pipeline import ProjectionExec
    from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec
    from ballista_tpu_torch.expr import logical as L

    ref_ns = types.SimpleNamespace(RewriteOp=ref_rw.RewriteOp, QueryStage=RefQueryStage)
    port_ns = types.SimpleNamespace(RewriteOp=rw.RewriteOp, QueryStage=QueryStage)
    return {
        "schema": (
            _schema_breaking(ref_ns, RefProjectionExec, RefShuffleWriterExec, RefL),
            _schema_breaking(port_ns, ProjectionExec, ShuffleWriterExec, L),
        ),
        "desync": (_bucket_desync(ref_ns, RefShuffleWriterExec), _bucket_desync(port_ns, ShuffleWriterExec)),
    }


def test_schema_breaking_rewrite_rejected_with_typed_clause(ctxs):
    ref_stages, stages = both_stages(ctxs, 3)
    ref_op, op = _bad_ops()["schema"]
    with pytest.raises(RewriteRejected) as ei:
        rw.apply_rewrite(stages, op, job_id="job-q3")
    e = ei.value
    assert e.clause == "schema-equivalence"
    assert "rewrite-rejected" in str(e)
    with pytest.raises(RefRewriteRejected) as ref_ei:
        ref_rw.apply_rewrite(ref_stages, ref_op, job_id="job-q3")
    assert (e.clause, e.stage_ids) == (ref_ei.value.clause, ref_ei.value.stage_ids)
    # deterministic: the scheduler must never burn retries on it
    assert not error_is_retryable(f"RewriteRejected: {e}")
    # rejection left the input untouched (copy-on-write discipline)
    cert = rw.certify(stages, op.apply(stages))
    ref_cert = ref_rw.certify(ref_stages, ref_op.apply(ref_stages))
    assert not cert.ok and cert.failing.name == "schema-equivalence"
    assert [(c.name, c.ok) for c in cert.clauses] == [(c.name, c.ok) for c in ref_cert.clauses]


def test_bucket_desync_rejected_by_partition_compat(ctxs):
    ref_stages, stages = both_stages(ctxs, 3)
    ref_op, op = _bad_ops()["desync"]
    with pytest.raises(RewriteRejected) as ei:
        rw.apply_rewrite(stages, op, job_id="job-q3")
    assert ei.value.clause == "partition-compat"
    assert "buckets" in str(ei.value)
    with pytest.raises(RefRewriteRejected) as ref_ei:
        ref_rw.apply_rewrite(ref_stages, ref_op, job_id="job-q3")
    # the same clause, naming the same violated pair
    assert str(ei.value) == str(ref_ei.value)


def test_certificate_shape_and_exactness(collect_ctxs):
    stages = both_stages(collect_ctxs, 3)
    done = next(
        ((op, res) for op, v, res in verdicts_match(stages, 3)
         if isinstance(op, rw.FlipJoinBuildSide) and res is not None),
        None,
    )
    assert done is not None, "q3 exposed no applicable flip"
    op, res = done
    cert = res.certificate
    assert tuple(c.name for c in cert.clauses) == rw.CERT_CLAUSES
    assert cert.exactness == rw.MULTISET_EXACT
    assert cert.rewritten_stages == (op.stage_id,)
    assert cert.added_stages == () and cert.removed_stages == ()
    assert "VALID" in cert.summary()
    # inject is bit-exact and ADDS a stage, as in the reference
    ref_stages, port_stages = stages
    inj = rw.apply_rewrite(port_stages, rw.InjectExchange(port_stages[-1].stage_id, 0), job_id="job-q3")
    ref_inj = ref_rw.apply_rewrite(
        ref_stages, ref_rw.InjectExchange(ref_stages[-1].stage_id, 0), job_id="job-q3"
    )
    assert inj.certificate.exactness == rw.BIT_EXACT
    assert len(inj.certificate.added_stages) == 1
    assert inj.certificate.summary() == ref_inj.certificate.summary()


def test_copy_on_write_leaves_pristine_templates(ctxs):
    stages = build_stages(ctxs[1], 3)
    before = [(s.stage_id, s.plan, s.plan.display()) for s in stages]
    for op in enumerate_ops(PORT, stages):
        try:
            rw.apply_rewrite(stages, op, job_id="job-q3")
        except RewriteRejected:
            pass
    for (sid, plan, disp), s in zip(before, stages):
        assert s.plan is plan, f"stage {sid} plan object replaced"
        assert s.plan.display() == disp, f"stage {sid} plan mutated"


# -- scheduler bookkeeping rebind ---------------------------------------------


def test_rebind_stages_for_rewrite_preconditions():
    from ballista_tpu_torch.scheduler.stage_manager import StageManager, TaskState
    from ballista_tpu_torch.scheduler_types import PartitionId

    sm = StageManager()
    sm.add_running_stage("j", 1, 2)
    sm.add_pending_stage("j", 2, 2)
    sm.add_final_stage("j", 2)
    sm.add_stages_dependency("j", {1: {2}})

    # a RUNNING task blocks the rebind, and nothing is mutated
    picked = sm.assign_next_task("ex-1")
    assert picked is not None and picked[1] == 1
    err = sm.rebind_stages_for_rewrite("j", affected={1: 4}, removed=(), added={}, deps={1: {2}})
    assert err is not None and "non-pending" in err
    assert sm.get_stage("j", 1).n_tasks == 2
    # release the task; rebind then succeeds and re-tasks the stage
    sm.update_task_status(PartitionId("j", 1, picked[2]), TaskState.PENDING)
    err = sm.rebind_stages_for_rewrite(
        "j", affected={1: 4}, removed=(), added={3: 1}, deps={1: {2}, 3: {2}}
    )
    assert err is None
    assert sm.get_stage("j", 1).n_tasks == 4
    assert sm.is_pending_stage("j", 1)  # frozen pending for re-promotion
    assert sm.get_stage("j", 3) is not None and sm.is_pending_stage("j", 3)
    assert sm.parents_of("j", 3) == {2}

    # removed stages disappear from every map
    err = sm.rebind_stages_for_rewrite("j", affected={}, removed=(3,), added={}, deps={1: {2}})
    assert err is None
    assert sm.get_stage("j", 3) is None
    assert sm.parents_of("j", 3) == set()


def test_rewrite_rejected_is_nonretryable_taxonomy():
    from ballista_tpu_torch.errors import NON_RETRYABLE_ERROR_TYPES

    assert "RewriteRejected" in NON_RETRYABLE_ERROR_TYPES
    e = RewriteRejected("nope", clause="stage-dag", stage_ids=(4,))
    assert e.clause == "stage-dag" and e.stage_ids == (4,)
    assert "clause=stage-dag" in str(e)
    assert str(e) == str(RefRewriteRejected("nope", clause="stage-dag", stage_ids=(4,)))
