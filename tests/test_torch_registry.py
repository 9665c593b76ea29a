"""The plan-level device-program closure of the port
(``ballista_tpu_torch/compilecache/registry.py``): every operator of every
TPC-H plan declares its device programs, and the gate's messages are the
reference's (``ballista_tpu/compilecache/registry.py``)."""

import pathlib

import pytest

from ballista_tpu.compilecache import registry as ref_registry
from ballista_tpu_torch.compilecache import registry
from ballista_tpu_torch.distributed_plan import DistributedPlanner
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.exec.planner import PhysicalPlanner
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.tpch import gen_all

QDIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "queries"


@pytest.fixture(scope="module")
def ctx():
    c = TorchContext(device="cpu")
    for name, t in gen_all(0.001, 42).items():
        c.register_table(name, t)
    return c


def test_programs_resolve_in_the_source():
    """Each torch program is a function of its module, each CUDA program
    an ``extern "C"`` entry point of its source; every operator names
    known programs only."""
    assert registry.check_programs() == []
    assert {n for n, s in registry.PROGRAMS.items() if s.route == "cuda"} == {
        "cuda.onehot_sums_f64", "cuda.partition_hash", "cuda.partition_groups",
        "cuda.prefix_sum_f64",
    }


def test_every_port_operator_is_mapped():
    """Every ExecutionPlan class of the port, and every operator of the
    reference's map (its mesh tier among them), is in the port's map."""
    import importlib

    from ballista_tpu_torch.exec.base import ExecutionPlan

    for m in ("exec.aggregate", "exec.joins", "exec.mesh", "exec.percentile", "exec.pipeline", "exec.repartition",
              "exec.scan", "exec.sort", "exec.window", "executor.reader", "executor.shuffle",
              "distributed_plan"):
        importlib.import_module(f"ballista_tpu_torch.{m}")

    def concrete(cls):
        # the package's own classes: a test's stand-in operators are not
        for sub in cls.__subclasses__():
            if sub.__module__.startswith("ballista_tpu_torch.") and not sub.__name__.startswith("_"):
                yield sub.__name__
            yield from concrete(sub)

    names = set(concrete(ExecutionPlan))
    assert names <= set(registry.OPERATOR_KERNELS), names - set(registry.OPERATOR_KERNELS)
    assert set(ref_registry.OPERATOR_KERNELS) == set(registry.OPERATOR_KERNELS)


def test_shrink_program_is_declared_where_the_reference_declares_it():
    """The adaptive shrink (``exec/shrink.maybe_shrink``) is a program of
    the operators that call it: the Filter/Projection chain, the joins and
    the percentile, and no other. The reference maps its ``exec.shrink.f``
    to the chain only, though its joins and percentile call it too."""
    name = "exec.shrink.maybe_shrink"
    assert registry.PROGRAMS[name].source == "exec/shrink.py"
    ours = {op for op, ks in registry.OPERATOR_KERNELS.items() if name in ks}
    refs = {op for op, ks in ref_registry.OPERATOR_KERNELS.items() if "exec.shrink.f" in ks}
    assert ours == {"FilterExec", "ProjectionExec", "HashJoinExec", "CrossJoinExec", "PercentileExec"}
    assert refs == {"FilterExec", "ProjectionExec"}


@pytest.mark.parametrize("qi", list(range(1, 23)))
def test_check_plan_is_clean_on_tpch(ctx, qi):
    """The port's physical plan of each TPC-H query, in collect mode and
    distributed (the whole plan and each stage), maps every operator."""
    sql = (QDIR / f"q{qi}.sql").read_text()
    optimized = optimize(ctx.sql_to_logical(sql))
    local = ctx.create_physical_plan(optimized)
    assert registry.check_plan(local) == []
    dist = PhysicalPlanner(ctx, 4, config=ctx.config, distributed=True).plan(optimized)
    assert registry.check_plan(dist) == []
    stages = DistributedPlanner().plan_query_stages(f"job-q{qi}", dist)
    for s in stages:
        assert registry.check_plan(s.plan) == [], s.stage_id
    kernels = set().union(*(registry.plan_kernels(s.plan) for s in stages))
    # every distributed plan writes hash-partitioned or single shuffles
    assert "ops.partition.batch_partition_groups" in kernels
    assert kernels <= set(registry.PROGRAMS)


def test_unmapped_operator_gives_the_references_message(ctx):
    from ballista_tpu_torch.exec.base import ExecutionPlan

    class NovelExec(ExecutionPlan):
        def __init__(self, input):
            super().__init__()
            self.input = input

        def children(self):
            return [self.input]

        def schema(self):
            return self.input.schema()

    from ballista_tpu.datatypes import Schema as RefSchema
    from ballista_tpu.exec.joins import EmptyExec as RefEmptyExec

    plan = NovelExec(ctx.create_physical_plan(optimize(ctx.sql_to_logical("SELECT n_name FROM nation"))))
    got = registry.check_plan(plan)
    # the reference's walk reads only class names and children
    want = ref_registry.check_plan(NovelExec(RefEmptyExec(False, RefSchema([]))))
    assert got == want == ["operator NovelExec not mapped in compilecache.registry.OPERATOR_KERNELS"]
    assert registry.plan_kernels(plan) == registry.plan_kernels(plan.input)
