"""The device-program vocabulary: which device programs the port has, which
each physical operator may run, the gates over both, and the prewarm's
signatures (port of ``ballista_tpu/compilecache/registry.py``).

The reference's registry closes a jitted-kernel vocabulary, because a
JAX engine pays a compile per distinct signature. The port compiles no
per-signature program: its device work is three hand-written CUDA kernels,
built once per source, and torch programs that run eagerly. Its
vocabulary is those programs, closed over the source in both directions,
and the plan-level closure that the certified rewrites need
(``rewrite.certify``'s ``compile-vocab`` clause): every operator class a
plan holds must declare the device programs it may run, so a rewrite
cannot bring an operator with an undeclared device surface into a stage.

- :data:`PROGRAMS` — every device program an operator may run: the CUDA
  kernels by their launch names (the ``extern "C"`` entry points of
  ``csrc/*.cu``), the torch programs by module and function.
- :data:`OPERATOR_KERNELS` — operator class name -> the programs it may
  run, with the reference's name.
- :data:`HOST_ONLY` — the functions and entry points of the program
  modules that run no device program (host helpers, builds, error text,
  and the kernels' plain versions, which run on CPU tensors only), each
  with its reason.
- :func:`check_plan` / :func:`plan_kernels` — the reference's signatures
  and messages; :func:`check_programs` holds every entry of
  :data:`PROGRAMS` against the source (a mapping cannot rot).
- :func:`check_vocabulary` — the closure in the other direction, with the
  reference's messages: the source-derived report of the port's device
  programs (``analysis/devlint.device_program_report``) against
  :data:`PROGRAMS` and :data:`HOST_ONLY`, so a new kernel entry point, a
  new launcher or a new public function of a program module cannot ship
  undeclared, and an entry whose program is gone is stale.
- :func:`enumerate_prewarm` — the prewarm's signatures per capacity
  bucket (``compilecache/prewarm.py``), as zero-arg thunks that run the
  public function once on zeros on the prewarm's device. On the card the
  first use of a program pays the kernels' build and ctypes load, the
  one-hot kernel's once-a-device shared-memory limit and CUDA's lazy
  loading of each torch kernel by op, dtype and size class; a thunk pays
  them ahead of the first query.
"""

from __future__ import annotations

import dataclasses
import importlib
import pathlib
import re
from typing import Callable


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
    # the kernels' wrappers and launchers
    "ops.onehot_agg.onehot_sums": ProgramSpec(
        "torch", "ops/onehot_agg.py", "launches cuda.onehot_sums_f64"
    ),
    "ops.partition.partition_hash": ProgramSpec(
        "torch", "ops/partition.py",
        "row hashes or bucket ids (launches cuda.partition_hash)",
    ),
    "ops.partition._launch_hash": ProgramSpec(
        "torch", "ops/partition.py", "launches cuda.partition_hash"
    ),
    "ops.partition.partition_groups": ProgramSpec(
        "torch", "ops/partition.py", "launches cuda.partition_groups"
    ),
    "ops.partition.partition_ids_for": ProgramSpec(
        "torch", "ops/partition.py",
        "bucket ids of key columns (launches cuda.partition_hash)",
    ),
    "ops.partition.group_by_id": ProgramSpec(
        "torch", "ops/partition.py",
        "rows grouped by id: stable argsort and counted offsets",
    ),
    "ops.prefix_sum.prefix_sums": ProgramSpec(
        "torch", "ops/prefix_sum.py", "launches cuda.prefix_sum_f64"
    ),
    "ops.prefix_sum._launch": ProgramSpec(
        "torch", "ops/prefix_sum.py", "launches cuda.prefix_sum_f64"
    ),
    # the rest of the substrate
    "ops.perm.stable_argsort": ProgramSpec(
        "torch", "ops/perm.py", "one stable argsort pass"
    ),
    "ops.perm.refine_perm": ProgramSpec(
        "torch", "ops/perm.py", "one LSD pass over a permutation"
    ),
    "ops.perm.take": ProgramSpec("torch", "ops/perm.py", "one gather"),
    "ops.perm.take_many": ProgramSpec(
        "torch", "ops/perm.py", "stacked gathers by dtype"
    ),
    "ops.perm.take_many_split": ProgramSpec(
        "torch", "ops/perm.py", "stacked gathers with optional masks"
    ),
    "ops.sort.gather_batch": ProgramSpec(
        "torch", "ops/sort.py", "a batch gathered by a permutation"
    ),
    "ops.sort.sort_batch": ProgramSpec("torch", "ops/sort.py", "batch sort"),
    "ops.join.attach_lut": ProgramSpec(
        "torch", "ops/join.py", "direct-address probe table"
    ),
    "ops.join.lut_stale": ProgramSpec(
        "torch", "ops/join.py", "device flag: a kept probe table went stale"
    ),
    "ops.join.probe_counts": ProgramSpec(
        "torch", "ops/join.py", "matches of each probe row"
    ),
    "ops.concat.unify_dictionaries": ProgramSpec(
        "torch", "ops/concat.py", "string codes remapped onto shared dictionaries"
    ),
    "expr.physical.civil_from_days": ProgramSpec(
        "torch", "expr/physical.py", "dates to (year, month, day)"
    ),
}

# Functions and entry points of the program modules that run no device
# program: check_vocabulary accepts them, and devlint does not follow a
# call into them. Each says why.
_PLAIN = "the kernel's plain version: its wrapper runs it on CPU tensors only"
_BUILD = "the nvcc build and ctypes load of a kernel (host)"
HOST_ONLY: dict[str, str] = {
    "cuda.onehot_error_string": "the text of a return code (host)",
    "cuda.partition_hash_error_string": "the text of a return code (host)",
    "cuda.prefix_sum_error_string": "the text of a return code (host)",
    "cuda.onehot_smem_limit": (
        "raises the kernels' shared-memory limit once a device: a host-side "
        "attribute call, no launch"
    ),
    "cuda.partition_groups_tile_rows": "a compile-time constant the wrapper checks",
    "cuda.prefix_sum_chunk": "a compile-time constant the wrapper checks",
    "cuda.prefix_sum_tile": "a compile-time constant the wrapper checks",
    "ops.cuda_build.build_seconds": _BUILD,
    "ops.cuda_build.nvcc": _BUILD,
    "ops.cuda_build.library_path": _BUILD,
    "ops.cuda_build.build_many": _BUILD,
    "ops.cuda_build.build": _BUILD,
    "ops.cuda_build.load": _BUILD,
    "ops.onehot_agg.build": _BUILD,
    "ops.prefix_sum.build": _BUILD,
    "ops.onehot_agg.launch_plan": "launch-shape arithmetic on the host",
    "ops.prefix_sum.levels": "launch-shape arithmetic on the host",
    "ops.prefix_sum.scratch_words": "launch-shape arithmetic on the host",
    "ops.perm.group_by_dtype": "the index plan of stacked gathers (host)",
    "ops.sort.resolve_sort_keys": "sort keys resolved against a schema (host)",
    "ops.partition.string_key_tables": (
        "a dictionary's string hashes, computed on the host and uploaded once "
        "(memoized)"
    ),
    "expr.physical.like_to_regex": "a LIKE pattern compiled on the host",
    "ops.onehot_agg.onehot_sums_plain": _PLAIN,
    "ops.partition.partition_ids_plain": _PLAIN,
    "ops.partition.partition_groups_plain": _PLAIN,
    "ops.prefix_sum.prefix_sums_plain": _PLAIN,
    "ops.hashing.hash_columns_plain": _PLAIN,
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


def check_vocabulary(report: dict | None = None) -> list[str]:
    """Compare the source-derived device-program report against
    :data:`PROGRAMS` and :data:`HOST_ONLY`; any asymmetric difference is a
    finding (a new program unregistered, or a registry entry whose program
    no longer exists)."""
    if report is None:
        from ballista_tpu_torch.analysis.devlint import device_program_report

        report = device_program_report()
    known = set(PROGRAMS) | set(HOST_ONLY)
    problems = []
    for k in sorted(report):
        if k not in known:
            problems.append(
                f"unregistered kernel {k} ({report[k]['file']}:"
                f"{report[k]['line']}): new device programs must be added to "
                "compilecache.registry.PROGRAMS (and OPERATOR_KERNELS for the "
                "operators that run them), or to HOST_ONLY with the reason"
            )
    for k in sorted(known):
        if k not in report:
            problems.append(
                f"stale registry entry {k}: kernel no longer in the device "
                "program report"
            )
    for op, kernels in sorted(OPERATOR_KERNELS.items()):
        for k in kernels:
            if k not in PROGRAMS:
                problems.append(
                    f"OPERATOR_KERNELS[{op}] names unknown kernel {k}"
                )
    return problems


# -- prewarm enumeration --------------------------------------------------------

# The dtype axis of the data-movement substrate: every TPC-H column lands
# on one of these device dtypes (strings ride int32 dictionary codes,
# dates int32/int64, money float64; bool covers validity/null masks).
PREWARM_DTYPES = ("int64", "float64", "int32", "bool")


@dataclasses.dataclass(frozen=True)
class PrewarmSignature:
    """One concrete prewarm signature: ``compile`` runs its program once."""

    kernel: str
    capacity: int
    dtypes: tuple[str, ...]
    variant: str = ""
    compile: Callable[[], None] = None  # zero-arg thunk

    @property
    def key(self) -> str:
        v = f",{self.variant}" if self.variant else ""
        return f"{self.kernel}[{'+'.join(self.dtypes)}{v},cap={self.capacity}]"


def _zeros(cap: int, dtype: str, device, rows: int | None = None):
    import torch

    shape = (cap,) if rows is None else (rows, cap)
    return torch.zeros(shape, dtype=getattr(torch, dtype), device=device)


def _wait(device) -> None:
    """A thunk ends when its work on ``device`` is done, so its seconds are
    the program's and a launch fault surfaces in the thunk."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _warm_argsort(dtype: str, cap: int, descending: bool, device) -> None:
    """One stable argsort pass through the query path's ``ops/perm``."""
    from ballista_tpu_torch.ops.perm import stable_argsort

    stable_argsort(_zeros(cap, dtype, device), descending)
    _wait(device)


def _warm_sort_pass(dtype: str, cap: int, device) -> None:
    """One sort pass and its gather through the public ``multi_key_perm``."""
    from ballista_tpu_torch.ops.perm import multi_key_perm

    multi_key_perm([(_zeros(cap, dtype, device), False)])
    _wait(device)


def _warm_compact(cap: int, device) -> None:
    """The compaction (invalid mask, bool argsort, per-dtype gathers) on a
    representative two-column batch."""
    from ballista_tpu_torch.columnar.batch import DeviceBatch
    from ballista_tpu_torch.datatypes import DataType, Field, Schema
    from ballista_tpu_torch.ops.compact import compact

    schema = Schema([Field("k", DataType.INT64), Field("v", DataType.FLOAT64)])
    compact(DeviceBatch.empty(schema, capacity=cap, device=device))
    _wait(device)


def _warm_onehot(cap: int, mode: str, device) -> None:
    """The one-hot kernel (its build, load and shared-memory limit on
    first use) in one launch mode: q1's shape for "lanes", the least
    "owners" slot count with one value row."""
    from ballista_tpu_torch.ops import onehot_agg

    rows, slots = (6, 12) if mode == "lanes" else (1, onehot_agg._OWNER_MIN_SLOTS)
    onehot_agg.onehot_sums(_zeros(cap, "int32", device), _zeros(cap, "float64", device, rows), slots)
    _wait(device)


def _warm_partition(cap: int, mode: str, device) -> None:
    """The partition-hash kernel in one mode: row hashes, bucket ids, or
    the grouped mode, over one int64 key at the spills' 64 buckets."""
    import torch

    from ballista_tpu_torch.ops import partition

    key = _zeros(cap, "int64", device)
    valid = torch.ones(cap, dtype=torch.bool, device=device)
    if mode == "grouped":
        partition.partition_groups([key], [None], [None], valid, 64)
    else:
        partition.partition_hash([key], [None], [None], valid, 64 if mode == "ids" else 0)
    _wait(device)


def _warm_prefix(cap: int, device) -> None:
    from ballista_tpu_torch.ops.prefix_sum import prefix_sums

    prefix_sums(_zeros(cap, "float64", device, 1))
    _wait(device)


def enumerate_prewarm(buckets, device="cuda") -> list[PrewarmSignature]:
    """The concrete prewarm signature list over ``buckets`` (capacity
    ladder points, see CapacityLadder.buckets_upto), each a thunk that runs
    on ``device``: the reference's argsort, take and compaction passes,
    and one signature per hand-written kernel and mode."""
    sigs: list[PrewarmSignature] = []
    for cap in buckets:
        for dt in PREWARM_DTYPES:
            for desc in (False, True):
                sigs.append(PrewarmSignature(
                    "ops.perm.stable_argsort", cap, (dt,),
                    variant=f"argsort,desc={int(desc)}",
                    compile=(
                        lambda dt=dt, cap=cap, desc=desc:
                        _warm_argsort(dt, cap, desc, device)
                    ),
                ))
            sigs.append(PrewarmSignature(
                "ops.perm.multi_key_perm", cap, (dt,), variant="take",
                compile=lambda dt=dt, cap=cap: _warm_sort_pass(dt, cap, device),
            ))
        sigs.append(PrewarmSignature(
            "ops.compact.compact", cap, ("int64", "float64"), variant="compact",
            compile=lambda cap=cap: _warm_compact(cap, device),
        ))
        for mode in ("lanes", "owners"):
            sigs.append(PrewarmSignature(
                "cuda.onehot_sums_f64", cap, ("int32", "float64"), variant=mode,
                compile=lambda cap=cap, mode=mode: _warm_onehot(cap, mode, device),
            ))
        for mode in ("hash", "ids"):
            sigs.append(PrewarmSignature(
                "cuda.partition_hash", cap, ("int64",), variant=mode,
                compile=lambda cap=cap, mode=mode: _warm_partition(cap, mode, device),
            ))
        sigs.append(PrewarmSignature(
            "cuda.partition_groups", cap, ("int64",), variant="grouped",
            compile=lambda cap=cap: _warm_partition(cap, "grouped", device),
        ))
        sigs.append(PrewarmSignature(
            "cuda.prefix_sum_f64", cap, ("float64",),
            compile=lambda cap=cap: _warm_prefix(cap, device),
        ))
    return sigs
