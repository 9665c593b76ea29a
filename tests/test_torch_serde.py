"""Plans across the wire: the port's serde, stage splitter and shuffle
resolution against the reference's, on the CPU. For every stage of the
distributed plans of the 22 TPC-H queries (K = 4, spec constants from
``tpch.spec_substitutions``) the stage split is the reference's and the
port's proto bytes are the reference's byte for byte; expressions, logical
plans and collect-mode physical plans of the reference's serde round-trip
cases encode to the reference's bytes and decode to the same
``display()``. The generated message classes are shared by both packages
(one descriptor pool), so equal bytes are the test, never ``isinstance``."""

import pathlib

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu.config import BallistaConfig as RefConfig
from ballista_tpu.distributed_plan import DistributedPlanner as RefDistributedPlanner
from ballista_tpu.distributed_plan import resolve_shuffles_eager as ref_resolve_eager
from ballista_tpu.exec.base import TaskContext as RefTaskContext
from ballista_tpu.exec.context import TpuContext
from ballista_tpu.exec.planner import PhysicalPlanner as RefPlanner
from ballista_tpu.exec.sort import SortExec as RefSortExec
from ballista_tpu.expr import logical as RL
from ballista_tpu.plan.logical import SortExpr as RefSortExpr
from ballista_tpu.plan.optimizer import optimize as ref_optimize
from ballista_tpu.scheduler_types import PartitionLocation as RefLocation
from ballista_tpu.serde import BallistaCodec as RefCodec
from ballista_tpu.serde import expr_to_proto as ref_expr_to_proto
from ballista_tpu.serde import loc_to_proto as ref_loc_to_proto
from ballista_tpu.serde import logical_to_proto as ref_logical_to_proto
from ballista_tpu_torch.columnar.arrow_interop import batch_to_arrow
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.datatypes import DataType, Schema
from ballista_tpu_torch.distributed_plan import (
    DistributedPlanner,
    UnresolvedShuffleExec,
    find_unresolved_shuffles,
    remove_unresolved_shuffles,
    resolve_shuffles_eager,
)
from ballista_tpu_torch.errors import ExecutionError, InternalError, PlanError
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, execute_to_batches
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.exec.planner import PhysicalPlanner
from ballista_tpu_torch.exec.sort import SortExec
from ballista_tpu_torch.executor.reader import ShuffleReaderExec
from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.plan.logical import SortExpr
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler_types import PartitionLocation
from ballista_tpu_torch.serde import (
    BallistaCodec,
    PhysicalExtensionCodec,
    expr_from_proto,
    expr_to_proto,
    loc_from_proto,
    loc_to_proto,
    logical_from_proto,
    logical_to_proto,
)
from ballista_tpu_torch.tpch import gen_all, spec_substitutions

QDIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "queries"
SCALE = 0.002
QUERIES = [f"q{i}" for i in range(1, 23)]

# tests/test_serde_roundtrip.py's feature queries
FEATURE_QUERIES = [
    "select g, count(*), sum(v), avg(v), min(s), max(v) from t group by g",
    "select g, stddev(v), var_pop(v), corr(v, v) from t group by g",
    "select g, v, row_number() over (partition by g order by v desc) rn, "
    "dense_rank() over (order by v nulls last) dr from t",
    "select * from t left join d on g = k where v > 1 and s like 'a%'",
    "select t.g, d.w from t full join d on g = k",
    "select g, case when v > 5 then 'hi' else 'lo' end c, "
    "cast(v as bigint) b, v between 1 and 9, "
    "coalesce(s, 'x') cs from t where g in (1, 2, 3)",
    "select count(distinct g) from t",
    "select g from t union all select k from d order by g limit 3",
]


@pytest.fixture(scope="module")
def tpch():
    data = gen_all(SCALE, 42)
    ref, port = TpuContext(), TorchContext(device="cpu")
    for name, t in data.items():
        ref.register_table(name, t)
        port.register_table(name, t)
    return data, ref, port


@pytest.fixture(scope="module")
def features():
    r = np.random.default_rng(1)
    n = 200
    tables = {
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
    ref, port = TpuContext(), TorchContext(device="cpu")
    for name, t in tables.items():
        ref.register_table(name, t)
        port.register_table(name, t)
    return ref, port


def query_sql(q: str, data) -> str:
    sql = (QDIR / f"{q}.sql").read_text()
    for old, new in spec_substitutions(q, data).items():
        sql = sql.replace(old, new)
    return sql


def stages_of(ref, port, sql, k=4):
    rplan = RefPlanner(ref, k, config=RefConfig(), distributed=True).plan(
        ref_optimize(ref.sql_to_logical(sql))
    )
    pplan = PhysicalPlanner(port, k, config=BallistaConfig(), distributed=True).plan(
        optimize(port.sql_to_logical(sql))
    )
    return (
        RefDistributedPlanner().plan_query_stages("job", rplan),
        DistributedPlanner().plan_query_stages("job", pplan),
    )


def roundtrip(codec: BallistaCodec, plan):
    return codec.physical_from_proto(
        pb.PhysicalPlanNode.FromString(codec.physical_to_proto(plan).SerializeToString())
    )


@pytest.mark.parametrize("q", QUERIES)
def test_stage_bytes_match_reference(tpch, q):
    """Stage for stage: the split (ids, partition counts, display), the
    proto bytes, and the decoded plan's display."""
    data, ref, port = tpch
    rstages, pstages = stages_of(ref, port, query_sql(q, data))
    assert [(s.stage_id, s.input_partition_count, s.output_partition_count) for s in pstages] == [
        (s.stage_id, s.input_partition_count, s.output_partition_count) for s in rstages
    ]
    rcodec, pcodec = RefCodec(provider=ref), BallistaCodec(provider=port)
    for r, p in zip(rstages, pstages):
        assert p.plan.display() == r.plan.display()
        data_bytes = pcodec.physical_to_proto(p.plan).SerializeToString()
        assert data_bytes == rcodec.physical_to_proto(r.plan).SerializeToString(), p.stage_id
        back = pcodec.physical_from_proto(pb.PhysicalPlanNode.FromString(data_bytes))
        assert back.display() == p.plan.display()
        assert pcodec.physical_to_proto(back).SerializeToString() == data_bytes


@pytest.mark.parametrize("q", QUERIES)
def test_tpch_logical_plan_bytes_match_reference(tpch, q):
    """Each TPC-H query's optimized logical plan: the reference's bytes,
    and the same display after a round trip (tests/test_serde_roundtrip.py's
    logical half)."""
    data, ref, port = tpch
    sql = query_sql(q, data)
    logical = optimize(port.sql_to_logical(sql))
    wire = logical_to_proto(logical).SerializeToString()
    assert wire == ref_logical_to_proto(ref_optimize(ref.sql_to_logical(sql))).SerializeToString()
    assert logical_from_proto(pb.LogicalPlanNode.FromString(wire)).display() == logical.display()


@pytest.mark.parametrize("i", range(len(FEATURE_QUERIES)))
def test_feature_query_roundtrips_match_reference(features, i):
    """The logical plan and the collect-mode physical plan of each of the
    reference's serde feature queries: the reference's bytes, and the same
    display after a round trip."""
    ref, port = features
    sql = FEATURE_QUERIES[i]
    rlogical = ref_optimize(ref.sql_to_logical(sql))
    logical = optimize(port.sql_to_logical(sql))
    data = logical_to_proto(logical).SerializeToString()
    assert data == ref_logical_to_proto(rlogical).SerializeToString()
    assert logical_from_proto(pb.LogicalPlanNode.FromString(data)).display() == logical.display()
    phys = port.create_physical_plan(logical)
    want = RefCodec(provider=ref).physical_to_proto(ref.create_physical_plan(rlogical))
    codec = BallistaCodec(provider=port)
    assert codec.physical_to_proto(phys).SerializeToString() == want.SerializeToString()
    assert roundtrip(codec, phys).display() == phys.display()


LITERALS = [
    (None, "INT64"), (True, "BOOL"), (-7, "INT32"), (2**62 + 3, "INT64"), (-0.5, "FLOAT64"),
    (1.25, "FLOAT32"), ("naïve 'x'", "STRING"), (9131, "DATE32"), (1_700_000_000_123_456, "TIMESTAMP_US"),
    (None, "STRING"),
]


@pytest.mark.parametrize("value,dtype", LITERALS)
def test_literal_roundtrips_match_reference(value, dtype):
    e = L.BinaryExpr(L.Column("a"), L.Operator.EQ, L.Literal(value, DataType[dtype]))
    r = RL.BinaryExpr(RL.Column("a"), RL.Operator.EQ, RL.Literal(value, RL.DataType[dtype]))
    data = expr_to_proto(e).SerializeToString()
    assert data == ref_expr_to_proto(r).SerializeToString()
    back = expr_from_proto(pb.ExprNode.FromString(data))
    assert back.name() == e.name() and back.right.dtype == e.right.dtype


def test_interval_wildcard_and_alias_roundtrip():
    for e, r in (
        (L.IntervalLiteral(3, -2), RL.IntervalLiteral(3, -2)),
        (L.Wildcard(), RL.Wildcard()),
        (L.Alias(L.Negative(L.Column("x")), "nx"), RL.Alias(RL.Negative(RL.Column("x")), "nx")),
    ):
        data = expr_to_proto(e).SerializeToString()
        assert data == ref_expr_to_proto(r).SerializeToString()
        assert expr_from_proto(pb.ExprNode.FromString(data)).name() == e.name()


def test_remove_unresolved_shuffles_copies_on_write(tpch):
    """Resolving a stage leaves its plan as it was (the scheduler keeps it
    as the template of a later re-resolution): the placeholders stay, the
    display is unchanged, and subtrees without a placeholder are shared."""
    data, ref, port = tpch
    _, stages = stages_of(ref, port, query_sql("q3", data))
    stage = next(s for s in stages if len(find_unresolved_shuffles(s.plan)) >= 2)
    before = stage.plan.display()
    placeholders = find_unresolved_shuffles(stage.plan)
    locations = {
        u.stage_id: [
            [PartitionLocation("job", u.stage_id, p, "e", "localhost", 0, f"/nowhere/{u.stage_id}/{p}")]
            for p in range(u.output_partition_count)
        ]
        for u in placeholders
    }
    resolved = remove_unresolved_shuffles(stage.plan, locations)
    assert not find_unresolved_shuffles(resolved)
    assert stage.plan.display() == before
    assert [u.stage_id for u in find_unresolved_shuffles(stage.plan)] == [u.stage_id for u in placeholders]
    assert resolved is not stage.plan and "ShuffleReaderExec" in resolved.display()
    with pytest.raises(PlanError, match="no partition locations"):
        remove_unresolved_shuffles(stage.plan, {})
    with pytest.raises(InternalError):
        list(placeholders[0].execute(0, TaskContext(device="cpu")))


def test_eager_resolution_matches_reference(tpch):
    """An eager reader plan encodes as the reference's; executing it outside
    a scheduler-connected executor raises, as the reference's does (its
    locations come from the scheduler's feed)."""
    data, ref, port = tpch
    rstages, pstages = stages_of(ref, port, query_sql("q12", data))
    r = ref_resolve_eager(rstages[-1].plan, "job")
    p = resolve_shuffles_eager(pstages[-1].plan, "job")
    codec = BallistaCodec(provider=port)
    assert (
        codec.physical_to_proto(p).SerializeToString()
        == RefCodec(provider=ref).physical_to_proto(r).SerializeToString()
    )
    reader = roundtrip(codec, p)
    while not isinstance(reader, ShuffleReaderExec):
        reader = reader.children()[0]
    assert reader.eager
    with pytest.raises(ExecutionError, match="requires a scheduler-connected executor"):
        list(reader.execute(0, TaskContext(device="cpu")))


def test_location_roundtrip_matches_reference():
    args = ("job", 3, 2, "exec-1", "host-a", 50051, "/w/job/3/2/data-1.arrow")
    loc = PartitionLocation(*args, push=True, map_partition=1)
    data = loc_to_proto(loc).SerializeToString()
    assert data == ref_loc_to_proto(RefLocation(*args, push=True, map_partition=1)).SerializeToString()
    back = loc_from_proto(pb.PartitionLocation.FromString(data))
    assert back == loc


def _node(**kind) -> pb.PhysicalPlanNode:
    return pb.PhysicalPlanNode(**kind)


_FILE_SCHEMA = pb.SchemaP(
    fields=[
        pb.FieldP(name="k", dtype=pb.DT_INT64, nullable=False),
        pb.FieldP(name="s", dtype=pb.DT_STRING, nullable=True),
    ]
)
# the file scans, ported since: each case is a round trip
_FILTER = expr_to_proto(L.BinaryExpr(L.Column("k"), L.Operator.GTEQ, L.Literal(7, DataType.INT64)))
UNPORTED_KINDS = {
    "mesh_aggregate": (_node(mesh_aggregate=pb.PhysicalMeshAggregateNode()), "item 10b"),
    "mesh_join": (_node(mesh_join=pb.PhysicalMeshJoinNode()), "item 10b"),
    "mesh_sort": (_node(mesh_sort=pb.PhysicalMeshSortNode()), "item 10b"),
    "mesh_window": (_node(mesh_window=pb.PhysicalMeshWindowNode()), "item 10b"),
    "csv": (_node(scan=pb.ScanExecNode(
        table_name="t", kind="csv", path="/d/t.csv", table_schema=_FILE_SCHEMA,
        projection=["s"], has_projection=True, has_header=True, delimiter="|", partitions=3,
    )), None),
    "parquet": (_node(scan=pb.ScanExecNode(
        table_name="t", kind="parquet", path="/d/t.parquet", table_schema=_FILE_SCHEMA,
        partitions=2, filters=[_FILTER],
    )), None),
    "avro": (_node(scan=pb.ScanExecNode(
        table_name="t", kind="avro", path="/d/t.avro", table_schema=_FILE_SCHEMA,
        projection=["k", "s"], has_projection=True, partitions=4,
    )), None),
    # ported since: a registered PhysicalExtensionCodec round-trips it
    "extension": (
        _node(extension=pb.PhysicalExtensionNode(codec="udf", payload=b"x")), "codec"
    ),
}


class _MarkerExec(ExecutionPlan):
    """A third-party operator: its payload and its inputs."""

    def __init__(self, payload: bytes, inputs: list) -> None:
        super().__init__()
        self.payload, self.inputs = payload, list(inputs)

    def schema(self):
        return self.inputs[0].schema() if self.inputs else Schema([])

    def children(self) -> list:
        return self.inputs


class _MarkerCodec(PhysicalExtensionCodec):
    name = "udf"

    def try_encode(self, plan):
        return plan.payload if isinstance(plan, _MarkerExec) else None

    def try_decode(self, payload, inputs):
        return _MarkerExec(payload, inputs)


@pytest.mark.parametrize("kind", sorted(UNPORTED_KINDS))
def test_unported_kinds_raise_naming_their_item(features, kind):
    """Kinds without an operator raise naming their item; the file scans
    (ported since) decode and encode again to the same bytes, as the
    reference's do, without opening the file; an extension operator
    (ported since) round-trips through its registered codec."""
    node, item = UNPORTED_KINDS[kind]
    if item == "codec":
        # an unregistered codec is refused by both with the reference's
        # message; a registered one decodes the operator and its inputs
        # and encodes them back to the same bytes
        for codec in (BallistaCodec(), RefCodec()):
            with pytest.raises(Exception, match="no codec registered for extension 'udf'"):
                codec.physical_from_proto(node)
        scan = UNPORTED_KINDS["csv"][0]
        for n in (node, _node(extension=pb.PhysicalExtensionNode(codec="udf", payload=b"y", inputs=[scan]))):
            wire = n.SerializeToString()
            codec = BallistaCodec(extension=_MarkerCodec())
            back = codec.physical_from_proto(pb.PhysicalPlanNode.FromString(wire))
            assert isinstance(back, _MarkerExec) and back.payload == n.extension.payload
            assert [c.display() for c in back.children()] == [
                codec.physical_from_proto(c).display() for c in n.extension.inputs
            ]
            assert codec.physical_to_proto(back).SerializeToString() == wire
        return
    if item is None:
        wire = node.SerializeToString()
        back = BallistaCodec().physical_from_proto(pb.PhysicalPlanNode.FromString(wire))
        ref_back = RefCodec().physical_from_proto(pb.PhysicalPlanNode.FromString(wire))
        assert back.display() == ref_back.display()
        assert back.schema().names == ref_back.schema().names
        assert BallistaCodec().physical_to_proto(back).SerializeToString() == wire
        assert RefCodec().physical_to_proto(ref_back).SerializeToString() == wire
        return
    with pytest.raises(PlanError, match=item):
        BallistaCodec(provider=features[1]).physical_from_proto(node)


@pytest.fixture(scope="module")
def tpch_files(tmp_path_factory):
    """The TPC-H tables as Parquet files (and q1's lineitem as CSV),
    registered by DDL in both contexts."""
    import pyarrow.csv as pacsv
    import pyarrow.parquet as papq

    data = gen_all(SCALE, 42)
    d = tmp_path_factory.mktemp("files")
    out = {}
    for fmt in ("parquet", "csv"):
        ref, port = TpuContext(), TorchContext(device="cpu")
        for name, t in data.items():
            if fmt == "parquet":
                path = d / f"{name}.parquet"
                papq.write_table(t, path, row_group_size=4096)
                ddl = f"CREATE EXTERNAL TABLE {name} STORED AS PARQUET LOCATION '{path}'"
            else:
                path = d / f"{name}.csv"
                pacsv.write_csv(t, path)
                ddl = f"CREATE EXTERNAL TABLE {name} STORED AS CSV WITH HEADER ROW LOCATION '{path}'"
            for c in (ref, port):
                c.sql(ddl)
        out[fmt] = (data, ref, port)
    return out


@pytest.mark.parametrize("case", [("parquet", q) for q in QUERIES] + [("csv", "q1")], ids=lambda c: "-".join(c))
def test_file_stage_bytes_match_reference(tpch_files, case):
    """The stages of a query over file tables, and its logical plan (which
    carries each file's source): the reference's bytes; a decoded stage
    displays as before and opens no file until it runs."""
    fmt, q = case
    data, ref, port = tpch_files[fmt]
    sql = query_sql(q, data)
    assert logical_to_proto(optimize(port.sql_to_logical(sql))).SerializeToString() == ref_logical_to_proto(
        ref_optimize(ref.sql_to_logical(sql))
    ).SerializeToString()
    rstages, pstages = stages_of(ref, port, sql)
    assert len(rstages) == len(pstages)
    rcodec, pcodec = RefCodec(provider=ref), BallistaCodec()
    scans = 0
    for r, p in zip(rstages, pstages):
        assert p.plan.display() == r.plan.display()
        wire = pcodec.physical_to_proto(p.plan).SerializeToString()
        assert wire == rcodec.physical_to_proto(r.plan).SerializeToString(), p.stage_id
        back = pcodec.physical_from_proto(pb.PhysicalPlanNode.FromString(wire))
        assert back.display() == p.plan.display()
        scans += back.display().count("ScanExec: ")
    assert scans >= 1


def test_memory_scan_needs_a_table_name(features):
    scan = features[1].scan("t", None, 1)
    with pytest.raises(PlanError, match="registered table name"):
        BallistaCodec().physical_to_proto(scan)
    scan.table_name = "t"
    with pytest.raises(InternalError, match="provider"):
        roundtrip(BallistaCodec(), scan)


@pytest.mark.parametrize("fetch", [1, 3, 150, 5000])
def test_topk_sort_matches_reference(features, fetch):
    """SortExec's TopK form (a fetch bound, carried by serde): the
    reference's bytes, its display, and its rows."""
    ref, port = features
    keys = [("v", False), ("g", True)]
    rscan, pscan = ref.scan("t", None, 2), port.scan("t", None, 2)
    rscan.table_name = pscan.table_name = "t"
    r = RefSortExec(rscan, [RefSortExpr(RL.Column(c), a, False) for c, a in keys], fetch)
    p = SortExec(pscan, [SortExpr(L.Column(c), a, False) for c, a in keys], fetch)
    codec = BallistaCodec(provider=port)
    data = codec.physical_to_proto(p).SerializeToString()
    assert data == RefCodec(provider=ref).physical_to_proto(r).SerializeToString()
    back = roundtrip(codec, p)
    assert back.fetch == fetch and back.display() == r.display()
    got = pa.Table.from_batches([batch_to_arrow(b) for b in execute_to_batches(back, TaskContext(device="cpu"))])
    from ballista_tpu.columnar.arrow_interop import batch_to_arrow as ref_batch_to_arrow
    from ballista_tpu.exec.base import execute_to_batches as ref_execute

    want = pa.Table.from_batches([ref_batch_to_arrow(b) for b in ref_execute(r, RefTaskContext())])
    assert got.num_rows == min(fetch, 200)
    assert got.equals(want)


def test_shuffle_writer_and_reader_roundtrip():
    """The stage-root writer and a resolved reader keep their fields."""
    from ballista_tpu_torch.datatypes import Field, Schema

    schema = Schema([Field("k", DataType.INT64), Field("s", DataType.STRING)])
    locs = [[PartitionLocation("job", 1, p, "e", "localhost", 0, f"/w/{p}", map_partition=m) for m in range(2)]
            for p in range(3)]
    reader = ShuffleReaderExec(locs, schema)
    writer = ShuffleWriterExec("job", 2, reader, [L.Column("k")], 7)
    back = roundtrip(BallistaCodec(), writer)
    assert back.display() == writer.display()
    assert back.input.partition_locations == locs and back.output_partitions == 7
    unresolved = UnresolvedShuffleExec(1, schema, 2, 3)
    back = roundtrip(BallistaCodec(), unresolved)
    assert (back.stage_id, back.input_partition_count, back.output_partition_count) == (1, 2, 3)
