"""The port's plan verifier (``ballista_tpu_torch/analysis/verifier.py``)
against the reference's, on the CPU.

The cases of ``tests/test_plan_verifier.py`` go through both verifiers,
each over its own package's plans built the same way: every TPC-H plan
(logical, physical, stage DAG) passes both with the same report (operators
and checks counted alike), and every hand-mutated plan fails both with the
same ``PlanVerificationError`` text, operator path and SQL span. The port
gates its submission paths as the reference does: the context's collect,
the client, the scheduler at submission, and the executor on a decoded
stage plan.
"""

import dataclasses
import pathlib
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

import ballista_tpu.analysis as ref_analysis
import ballista_tpu.distributed_plan as ref_dplan
import ballista_tpu.errors as ref_errors
import ballista_tpu.exec.context as ref_context
import ballista_tpu.exec.joins as ref_joins
import ballista_tpu.exec.planner as ref_planner
import ballista_tpu.exec.repartition as ref_repartition
import ballista_tpu.expr.logical as ref_L
import ballista_tpu.plan.logical as ref_P
import ballista_tpu.plan.optimizer as ref_optimizer
import ballista_tpu.datatypes as ref_datatypes
import ballista_tpu_torch.analysis as port_analysis
import ballista_tpu_torch.distributed_plan as port_dplan
import ballista_tpu_torch.errors as port_errors
import ballista_tpu_torch.exec.context as port_context
import ballista_tpu_torch.exec.joins as port_joins
import ballista_tpu_torch.exec.planner as port_planner
import ballista_tpu_torch.exec.repartition as port_repartition
import ballista_tpu_torch.expr.logical as port_L
import ballista_tpu_torch.plan.logical as port_P
import ballista_tpu_torch.plan.optimizer as port_optimizer
import ballista_tpu_torch.datatypes as port_datatypes
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.tpch import gen_all

QDIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "queries"
QUERIES = [f"q{i}" for i in range(1, 23)]


def side(name, analysis, dplan, errors, context, joins, planner, repartition, L, P, optimizer, datatypes):
    return types.SimpleNamespace(
        name=name, analysis=analysis, dplan=dplan, PVE=errors.PlanVerificationError,
        context=context, joins=joins, planner=planner, repartition=repartition, L=L, P=P,
        optimize=optimizer.optimize, Schema=datatypes.Schema,
    )


REF = side("ref", ref_analysis, ref_dplan, ref_errors, ref_context, ref_joins, ref_planner,
           ref_repartition, ref_L, ref_P, ref_optimizer, ref_datatypes)
PORT = side("port", port_analysis, port_dplan, port_errors, port_context, port_joins, port_planner,
            port_repartition, port_L, port_P, port_optimizer, port_datatypes)


def new_context(s, config=None):
    if s is REF:
        return ref_context.TpuContext(config)
    return port_context.TorchContext(config, device="cpu")


def small_tables():
    r = np.random.default_rng(3)
    n = 100
    return {
        "t": pa.table({
            "g": pa.array(r.integers(0, 5, n).astype(np.int64)),
            "v": pa.array(r.uniform(0, 10, n)),
            "s": pa.array([["a", "b", None][i % 3] for i in range(n)]),
        }),
        "d": pa.table({
            "k": pa.array(np.arange(5, dtype=np.int64)),
            "w": pa.array(r.uniform(0, 1, 5)),
        }),
    }


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ctxs():
    out = {}
    for s in (REF, PORT):
        c = new_context(s)
        for name, t in small_tables().items():
            c.register_table(name, t)
        out[s.name] = c
    return out


@pytest.fixture(scope="module")
def tpch_ctxs():
    data = gen_all(0.001, 42)
    out = {}
    for s in (REF, PORT):
        c = new_context(s)
        for name, t in data.items():
            c.register_table(name, t)
        out[s.name] = c
    return out


def verdict(fn):
    """("ok", nodes, checks, detail) or ("error", text, path, span)."""
    try:
        rep = fn()
    except (ref_errors.PlanVerificationError, port_errors.PlanVerificationError) as e:
        return ("error", str(e), tuple(e.path), e.span)
    return ("ok", rep.nodes, rep.checks, tuple(rep.detail))


def same_verdict(make) -> tuple:
    """``make(side, ctx)`` returns the verifier call of one side; both
    sides must give the same verdict, which is returned."""
    got = {}
    for s in (REF, PORT):
        got[s.name] = verdict(make(s))
    assert got["port"] == got["ref"], got
    return got["ref"]


def physical(s, c, sql):
    optimized = s.optimize(c.sql_to_logical(sql))
    return s.planner.PhysicalPlanner(c, c.config.default_shuffle_partitions()).plan(optimized)


def stages_of(s, c, sql, job):
    optimized = s.optimize(c.sql_to_logical(sql))
    phys = s.planner.PhysicalPlanner(c, 2, config=c.config, distributed=True).plan(optimized)
    return s.dplan.DistributedPlanner().plan_query_stages(job, phys)


# ------------------------------------------------------ TPC-H acceptance ---


@pytest.mark.parametrize("q", QUERIES)
def test_tpch_plans_verify_alike(tpch_ctxs, q):
    """Every TPC-H plan passes both tiers of both verifiers, with the same
    operator and check counts."""
    sql = (QDIR / f"{q}.sql").read_text()

    def logical(s):
        c = tpch_ctxs[s.name]
        return lambda: s.analysis.verify_logical(s.optimize(c.sql_to_logical(sql)), sql=sql)

    def phys(s):
        c = tpch_ctxs[s.name]
        return lambda: s.analysis.verify_physical(physical(s, c, sql), sql=sql)

    rl = same_verdict(logical)
    assert rl[0] == "ok" and rl[1] > 0 and rl[2] > rl[1], rl
    rp = same_verdict(phys)
    assert rp[0] == "ok" and rp[1] > 0, rp


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q18"])
def test_tpch_stages_verify_alike(tpch_ctxs, q):
    sql = (QDIR / f"{q}.sql").read_text()
    rep = same_verdict(
        lambda s: lambda: s.analysis.verify_stages(stages_of(s, tpch_ctxs[s.name], sql, f"job-{q}"), sql=sql)
    )
    assert rep[0] == "ok" and any("stages" in d for d in rep[3]), rep


# ----------------------------------------------------------- mutations ----


def _sum_over_string(s, c):
    return s.P.Aggregate(
        s.P.TableScan("t", c.schema_of("t")),
        (s.L.col("g"),),
        (s.L.AggregateExpr(s.L.AggFunc.SUM, s.L.col("s")),),
    )


def _logical_mutation(kind: str):
    def make(s, c):
        if kind == "dropped_column":
            opt = s.optimize(c.sql_to_logical("select g, sum(v) sv from t group by g"))

            def drop(node):
                if isinstance(node, s.P.TableScan):
                    return dataclasses.replace(node, projection=("g",))
                return node.with_children([drop(ch) for ch in node.children()])

            return drop(opt), None
        if kind == "unresolved_column":
            scan = s.P.TableScan("t", c.schema_of("t"))
            return s.P.Projection(scan, (s.L.col("g"), s.L.col("nope"))), "select g, nope from t"
        if kind == "sum_over_string":
            return _sum_over_string(s, c), None
        if kind == "join_key_mismatch":
            return s.P.Join(
                s.P.TableScan("t", c.schema_of("t")),
                s.P.TableScan("d", c.schema_of("d")),
                ((s.L.col("s"), s.L.col("w")),),
                s.P.JoinType.INNER,
            ), None
        if kind == "non_boolean_filter":
            return s.P.Filter(s.P.TableScan("t", c.schema_of("t")), s.L.col("v")), None
        raise AssertionError(kind)

    return make


@pytest.mark.parametrize(
    "kind,needle",
    [
        ("dropped_column", "'v'"),
        ("unresolved_column", "nope"),
        ("sum_over_string", "SUM over non-numeric dtype string"),
        ("join_key_mismatch", "join key dtype mismatch"),
        ("non_boolean_filter", "not boolean"),
    ],
)
def test_logical_mutation_fails_alike(ctxs, kind, needle):
    make = _logical_mutation(kind)

    def call(s):
        plan, sql = make(s, ctxs[s.name])
        return lambda: s.analysis.verify_logical(plan, sql=sql)

    v = same_verdict(call)
    assert v[0] == "error" and needle in v[1] and v[2], v
    if kind == "unresolved_column":
        assert v[3] == (1, 11)


@pytest.mark.parametrize("mutation", ["partition_count", "schema_drift"])
def test_stage_mutation_fails_alike(tpch_ctxs, mutation):
    sql = (QDIR / "q3.sql").read_text()

    def call(s):
        stages = stages_of(s, tpch_ctxs[s.name], sql, "job-mut")
        s.analysis.verify_stages(stages)  # sane before the mutation
        u = next(u for st in stages for u in s.dplan.find_unresolved_shuffles(st.plan))
        if mutation == "partition_count":
            u.output_partition_count += 1
        else:
            u._schema = s.Schema(list(u._schema.fields)[:-1])
        return lambda: s.analysis.verify_stages(stages)

    v = same_verdict(call)
    assert v[0] == "error" and any(p.startswith("stage ") for p in v[2]), v
    if mutation == "partition_count":
        assert "partition-count mismatch" in v[1] or "disagree on partition count" in v[1]
    else:
        assert "schema mismatch" in v[1]


def test_partitioned_join_bucket_mismatch_fails_alike(ctxs):
    def call(s):
        c = ctxs[s.name]
        left = s.repartition.HashRepartitionExec(c.scan("t", None, 2), [s.L.col("g")], 4)
        right = s.repartition.HashRepartitionExec(c.scan("d", None, 2), [s.L.col("k")], 3)
        bad = s.joins.HashJoinExec(
            left, right, [(s.L.col("g"), s.L.col("k"))], s.P.JoinType.INNER,
            partition_mode="partitioned",
        )
        return lambda: s.analysis.verify_physical(bad)

    v = same_verdict(call)
    assert v[0] == "error" and "disagree on partition count" in v[1], v


class _PlanningHandle:
    """A mesh runtime that never runs (the scheduler's planning handle)."""


def _mesh_node(s, c, case: str):
    """The reference's or the port's mesh operator of ``case`` over the
    small tables; a ``*_bad`` case is mutated after construction, as a
    serde drift would leave it."""
    import ballista_tpu.exec.mesh as ref_mesh
    import ballista_tpu_torch.exec.mesh as port_mesh

    mesh = ref_mesh if s is REF else port_mesh
    L, P, rt = s.L, s.P, _PlanningHandle()
    t, d = c.scan("t", None, 2), c.scan("d", None, 2)
    kind = case.split("_")[0]
    if kind == "join":
        key = "s" if case == "join_bad" else "g"
        return mesh.MeshJoinExec(t, d, [(L.col(key), L.col("k"))], P.JoinType.INNER, None, rt)
    if kind == "agg":
        node = mesh.MeshAggregateExec(t, [L.col("g")], [L.AggregateExpr(L.AggFunc.SUM, L.col("v"))], rt)
        if case == "agg_bad":
            node.group_exprs = [L.col("nope")]
        return node
    if kind == "sort":
        node = mesh.MeshSortExec(t, [P.SortExpr(L.col("v"), False, True)], 5, rt)
        if case == "sort_bad":
            node.sort_exprs = [P.SortExpr(L.col("nope"))]
        return node
    node = mesh.MeshWindowExec(
        t, [L.WindowFunction("row_number", (L.col("g"),), ((L.col("v"), False, None),))], ["rn"], rt
    )
    if case == "window_bad":
        node._local.window_exprs = [
            L.WindowFunction("row_number", (L.col("nope"),), ((L.col("v"), False, None),))
        ]
    return node


@pytest.mark.parametrize(
    "case", ["join_ok", "join_bad", "agg_ok", "agg_bad", "sort_ok", "sort_bad", "window_ok", "window_bad"]
)
def test_mesh_operators_verify_alike(ctxs, case):
    """The verifier's arms of the four mesh operators: a sound node passes
    both verifiers with the same report, a broken one fails both with the
    same text and operator path."""
    v = same_verdict(lambda s: (lambda: s.analysis.verify_physical(_mesh_node(s, ctxs[s.name], case))))
    assert v[0] == ("error" if case.endswith("_bad") else "ok"), v
    if case == "join_bad":
        assert "join key dtype mismatch" in v[1], v


@pytest.mark.parametrize(
    "sql,token", [("select g,\n       nope\nfrom t", "nope"), ("select g,\n       nope\nfrom t", "t.g"),
                  ("select g,\n       nope\nfrom t", "absent"), (None, "g")],
)
def test_sql_span_locator_alike(sql, token):
    assert port_analysis.sql_span(sql, token) == ref_analysis.sql_span(sql, token)


# ----------------------------------------------------- submission gates ---


def test_collect_gated_by_default(ctxs):
    """``TorchContext`` collect verifies by default, with the reference's
    message; with ``ballista.tpu.verify_plans=false`` it does not."""
    c = ctxs["port"]
    assert BallistaConfig().verify_plans() is True
    want = verdict(lambda: ref_analysis.verify_logical(ref_optimizer.optimize(_sum_over_string(REF, ctxs["ref"]))))
    with pytest.raises(port_errors.PlanVerificationError) as e:
        port_context.DataFrame(c, _sum_over_string(PORT, c)).collect()
    assert str(e.value) == want[1]
    off = port_context.TorchContext(BallistaConfig({"ballista.tpu.verify_plans": "false"}), device="cpu")
    off.register_table("t", pa.table({"g": [1, 2], "s": ["a", "b"]}))
    try:
        port_context.DataFrame(off, _sum_over_string(PORT, off)).collect()
    except port_errors.PlanVerificationError:  # pragma: no cover
        pytest.fail("verify off must not verify")
    except Exception:
        pass  # any runtime failure is fine: the point is no static gate


def test_cluster_rejects_a_bad_plan_at_submission(ctxs):
    """The port's cluster: the client verifies before it serializes, the
    scheduler verifies what it is sent, with the reference's text, and a
    bad plan sent over the wire fails its job at submission."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.serde import logical_to_proto

    want = verdict(lambda: ref_analysis.verify_logical(ref_optimizer.optimize(_sum_over_string(REF, ctxs["ref"]))))
    dctx = BallistaContext.standalone(device="cpu")
    try:
        dctx.register_table("t", pa.table({"g": [1, 2, 3], "s": ["a", "b", "c"]}))
        frame = dctx.sql("select g from t")
        bad = _sum_over_string(PORT, dctx)
        frame.logical = bad
        with pytest.raises(port_errors.PlanVerificationError) as e:
            frame.collect()
        assert str(e.value) == want[1]
        sched = dctx._standalone_cluster.scheduler
        with pytest.raises(port_errors.PlanVerificationError) as e:
            sched.submit_logical(bad, dctx.session_id)
        assert str(e.value) == want[1]
        res = dctx._stub.ExecuteQuery(pb.ExecuteQueryParams(
            logical_plan=logical_to_proto(bad).SerializeToString(), session_id=dctx.session_id,
        ))
        status = dctx._stub.GetJobStatus(pb.GetJobStatusParams(job_id=res.job_id)).status
        assert status.WhichOneof("status") == "failed"
        assert status.failed.error == want[1]
        out = dctx.sql("select g from t order by g").collect()
        assert out.column("g").to_pylist() == [1, 2, 3]
    finally:
        dctx.close()


def test_executor_verifies_decoded_plans(ctxs, tmp_path):
    """A port executor verifies a decoded stage plan before it runs it (the
    in-process cluster turns that off: its scheduler verified the same
    bytes), and the task fails with the reference's verdict."""
    from ballista_tpu_torch.executor.executor import Executor
    from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.serde import BallistaCodec

    c = ctxs["port"]
    scans = {}
    for name in ("t", "d"):
        scans[name] = c.scan(name, None, 2)
        scans[name].table_name = name  # as the planner names it, for serde
    join = port_joins.HashJoinExec(
        port_repartition.HashRepartitionExec(scans["t"], [port_L.col("g")], 4),
        port_repartition.HashRepartitionExec(scans["d"], [port_L.col("k")], 3),
        [(port_L.col("g"), port_L.col("k"))], port_P.JoinType.INNER,
        partition_mode="partitioned",
    )
    writer = ShuffleWriterExec("j", 1, join, [], 1)
    task = pb.TaskDefinition(
        task_id=pb.PartitionId(job_id="j", stage_id=1, partition_id=0),
        plan=BallistaCodec(provider=c).physical_to_proto(writer).SerializeToString(),
        session_id="s",
    )
    ex = Executor("e", str(tmp_path), provider=c, device="cpu")
    with pytest.raises(port_errors.PlanVerificationError, match="disagree on partition count"):
        ex.execute_shuffle_write(task)
    ex.verify_decoded_plans = False  # what runs then is not checked
    ex.execute_shuffle_write(task)
