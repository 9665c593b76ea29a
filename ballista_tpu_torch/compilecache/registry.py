"""The plan-level device-program closure: which device programs each
physical operator may run, and the gate over it (port of the plan half of
``ballista_tpu/compilecache/registry.py``).

The reference's registry closes a jitted-kernel vocabulary, because a
JAX engine pays a compile per distinct signature. The port compiles no
per-signature program: its device work is three hand-written CUDA kernels,
built once per source, and torch programs that run eagerly. What stays
is the plan-level closure that the certified rewrites need
(``rewrite.certify``'s ``compile-vocab`` clause): every operator class a
plan holds must declare the device programs it may run, so a rewrite
cannot bring an operator with an undeclared device surface into a stage.

- :data:`PROGRAMS` — every device program an operator may run: the CUDA
  kernels by their launch names (the ``extern "C"`` entry points of
  ``csrc/*.cu``), the torch programs by module and function.
- :data:`OPERATOR_KERNELS` — operator class name -> the programs it may
  run, with the reference's name.
- :func:`check_plan` / :func:`plan_kernels` — the reference's signatures
  and messages; :func:`check_programs` holds every entry of
  :data:`PROGRAMS` against the source (a mapping cannot rot).

Not ported here (ROADMAP queue 1, item 10b): the reference's jitted
``VOCABULARY`` and ``check_vocabulary`` against its jit-site report, the
AOT prewarm enumeration (``prewarm.py``), the shared trace cache
(``tracecache.py``) and the host-sync lint.
"""

from __future__ import annotations

import dataclasses
import importlib
import pathlib
import re


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    route: str  # "cuda" (a hand-written kernel) | "torch" (eager torch ops)
    source: str  # file of the package that holds it
    what: str  # what the program computes


_CSRC = "csrc"

PROGRAMS: dict[str, ProgramSpec] = {
    # the hand-written kernels, by launch name
    "cuda.onehot_sums_f64": ProgramSpec(
        "cuda", f"{_CSRC}/onehot_agg.cu",
        "dense group sums and counts (ops/onehot_agg.onehot_sums)",
    ),
    "cuda.partition_hash": ProgramSpec(
        "cuda", f"{_CSRC}/partition_hash.cu",
        "row hashes and bucket ids (ops/partition.partition_hash)",
    ),
    "cuda.partition_groups": ProgramSpec(
        "cuda", f"{_CSRC}/partition_hash.cu",
        "stable bucket grouping (ops/partition.partition_groups)",
    ),
    "cuda.prefix_sum_f64": ProgramSpec(
        "cuda", f"{_CSRC}/prefix_sum.cu",
        "fixed-order f64 prefix sums (ops/prefix_sum.prefix_sums)",
    ),
    # torch programs, by module.function
    "expr.physical.compile_expr": ProgramSpec(
        "torch", "expr/physical.py", "fused expression evaluation"
    ),
    "ops.compact.compact": ProgramSpec(
        "torch", "ops/compact.py", "front-valid compaction"
    ),
    "exec.shrink.maybe_shrink": ProgramSpec(
        "torch", "exec/shrink.py",
        "live rows to the front, cut to a learned capacity (adaptive shrink)",
    ),
    "ops.concat.concat_batches": ProgramSpec(
        "torch", "ops/concat.py", "batch concatenation"
    ),
    "ops.perm.take_batch": ProgramSpec(
        "torch", "ops/perm.py", "stacked gathers"
    ),
    "ops.perm.multi_key_perm": ProgramSpec(
        "torch", "ops/perm.py", "stable multi-key permutation"
    ),
    "ops.sort.sort_perm": ProgramSpec(
        "torch", "ops/sort.py", "sort permutation"
    ),
    "ops.search.searchsorted": ProgramSpec(
        "torch", "ops/search.py", "sorted-key search"
    ),
    "ops.aggregate.group_aggregate": ProgramSpec(
        "torch", "ops/aggregate.py",
        "sort-based segment aggregate (launches cuda.prefix_sum_f64)",
    ),
    "ops.aggregate.dense_group_aggregate": ProgramSpec(
        "torch", "ops/aggregate.py",
        "dense-slot aggregate (launches cuda.onehot_sums_f64)",
    ),
    "ops.aggregate.scalar_aggregate": ProgramSpec(
        "torch", "ops/aggregate.py", "ungrouped aggregate"
    ),
    "ops.join.build_side": ProgramSpec(
        "torch", "ops/join.py", "join build table"
    ),
    "ops.join.probe_side": ProgramSpec(
        "torch", "ops/join.py", "join probe"
    ),
    "ops.join.expand_join": ProgramSpec(
        "torch", "ops/join.py", "m:n join expansion"
    ),
    "ops.hashing.hash_columns": ProgramSpec(
        "torch", "ops/hashing.py", "row hashes (launches cuda.partition_hash)"
    ),
    "ops.partition.partition_ids": ProgramSpec(
        "torch", "ops/partition.py",
        "bucket ids (launches cuda.partition_hash)",
    ),
    "ops.partition.batch_partition_groups": ProgramSpec(
        "torch", "ops/partition.py",
        "bucket grouping (launches cuda.partition_groups)",
    ),
}

# Physical operator class -> the device programs it may run. The gate
# walks every TPC-H physical/stage plan and fails on an operator class
# missing here (a NEW operator cannot ship without declaring its device
# surface); check_programs fails on a mapping naming an unknown program.
_PIPELINE = (
    "expr.physical.compile_expr", "ops.compact.compact", "ops.perm.take_batch",
    "exec.shrink.maybe_shrink",
)
_SCAN = ("ops.concat.concat_batches",)
_AGG = (
    "expr.physical.compile_expr",
    "ops.aggregate.group_aggregate", "ops.aggregate.dense_group_aggregate",
    "ops.aggregate.scalar_aggregate", "cuda.onehot_sums_f64",
    "cuda.prefix_sum_f64", "ops.perm.multi_key_perm", "ops.perm.take_batch",
    "ops.concat.concat_batches",
)
_JOIN = (
    "expr.physical.compile_expr",
    "ops.join.build_side", "ops.join.probe_side", "ops.join.expand_join",
    "ops.compact.compact", "ops.perm.take_batch", "ops.search.searchsorted",
    "ops.concat.concat_batches", "exec.shrink.maybe_shrink",
)
_SORT = (
    "ops.sort.sort_perm", "ops.perm.take_batch", "ops.concat.concat_batches",
)
_EXCHANGE = (
    "ops.partition.partition_ids", "ops.partition.batch_partition_groups",
    "ops.hashing.hash_columns", "cuda.partition_hash",
    "cuda.partition_groups", "ops.perm.take_batch",
)

OPERATOR_KERNELS: dict[str, tuple[str, ...]] = {
    # leaf scans (Arrow -> DeviceBatch conversion + slice concat)
    "MemoryScanExec": _SCAN,
    "CsvScanExec": _SCAN,
    "ParquetScanExec": _SCAN,
    "AvroScanExec": _SCAN,
    "EmptyExec": (),
    # row pipeline
    "FilterExec": _PIPELINE,
    "ProjectionExec": _PIPELINE,
    "RenameExec": (),
    "CoalescePartitionsExec": (),
    "UnionExec": ("ops.concat.concat_batches",),
    # sorts / limits
    "SortExec": _SORT,
    "GlobalLimitExec": ("ops.perm.take_batch",),
    # aggregates / joins / windows
    "HashAggregateExec": _AGG,
    "HashJoinExec": _JOIN,
    "CrossJoinExec": _JOIN,
    "WindowExec": _SORT,
    "PercentileExec": _SORT + ("exec.shrink.maybe_shrink",),
    # exchange boundary
    "HashRepartitionExec": _EXCHANGE,
    "ShuffleWriterExec": _EXCHANGE + ("ops.concat.concat_batches",),
    "ShuffleReaderExec": ("ops.concat.concat_batches",),
    "UnresolvedShuffleExec": (),
}


def _package_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[1]


def check_programs() -> list[str]:
    """Hold :data:`PROGRAMS` and :data:`OPERATOR_KERNELS` against the
    source: each torch program resolves to a function of its module,
    each CUDA program is an ``extern "C"`` entry point of its source, and
    every operator names known programs only."""
    problems = []
    root = _package_root()
    for name, spec in sorted(PROGRAMS.items()):
        if spec.route == "cuda":
            src = root / spec.source
            text = src.read_text() if src.exists() else ""
            block = text[text.find('extern "C"'):]
            entry = name.split(".", 1)[1]
            if not re.search(rf"\b{re.escape(entry)}\s*\(", block):
                problems.append(
                    f"stale registry entry {name}: no extern \"C\" "
                    f"{entry} in {spec.source}"
                )
            continue
        module, _, fn = name.rpartition(".")
        try:
            mod = importlib.import_module(f"ballista_tpu_torch.{module}")
        except ImportError as e:
            problems.append(f"stale registry entry {name}: {e}")
            continue
        if not callable(getattr(mod, fn, None)):
            problems.append(
                f"stale registry entry {name}: {module} has no {fn}"
            )
    for op, kernels in sorted(OPERATOR_KERNELS.items()):
        for k in kernels:
            if k not in PROGRAMS:
                problems.append(
                    f"OPERATOR_KERNELS[{op}] names unknown kernel {k}"
                )
    return problems


def check_plan(plan) -> list[str]:
    """Walk a physical plan; every operator class must be mapped in
    OPERATOR_KERNELS (the plan-level closure: an unmapped operator is an
    undeclared device surface)."""
    problems = []
    seen = set()

    def walk(p) -> None:
        name = type(p).__name__
        if name not in seen:
            seen.add(name)
            if name not in OPERATOR_KERNELS:
                problems.append(
                    f"operator {name} not mapped in "
                    "compilecache.registry.OPERATOR_KERNELS"
                )
        for c in p.children():
            walk(c)

    walk(plan)
    return problems


def plan_kernels(plan) -> set[str]:
    """The device programs a plan may run."""
    out: set[str] = set()

    def walk(p) -> None:
        out.update(OPERATOR_KERNELS.get(type(p).__name__, ()))
        for c in p.children():
            walk(c)

    walk(plan)
    return out
