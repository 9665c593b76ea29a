"""The declared cache registry: every cache in the tree is a contract
(the port's copy of ``ballista_tpu/analysis/cachereg.py``, declaring the
port's caches).

A cache may only exist if it is DECLARED here, with its key composition,
scope, coherence class, and invalidation sites written down — and
:mod:`ballista_tpu_torch.analysis.stalelint` proves the tree against the
declarations. The reference declares jitted programs and its trace cache;
the port has no jitted program, and declares what it keeps instead: the
built kernel libraries and their launcher, the kernels' launch-shape
memos, the shared callable cache (the trace cache's counterpart), the
dictionary memo, the join build-table cache, the scans' device and host
caches, and the learned shrink and clustered-aggregate entries of the plan
cache.

Coherence classes (what makes a hit safe):

- ``versioned`` — the key folds in a version of every mutable input
  (e.g. the result cache folds ``_data_version()``); stale entries are
  unreachable by construction, invalidation is only an eviction policy.
- ``snapshot`` — readers see a frozen copy taken at a declared seam
  (e.g. ``Executor._job_snapshot``); reading the live state from a task
  path is the q15 bug shape and a stalelint error.
- ``immutable-keyed`` — the value for a key never changes once written
  (a committed shuffle partition, a built kernel library for a source
  hash); eviction is safe at any time, staleness is impossible.
- ``speculative-validated`` — entries are guesses that every consumer
  re-validates at use via the ``defer_speculation`` seam in
  ``exec/base.py`` (a miss invalidates the key and re-runs); writes must
  stay inside functions wired into that seam.

Anchors are ``"relative/path.py::Class.attr"`` (instance attribute or
dataclass field), ``"relative/path.py::GLOBAL"`` (module global), or
``"relative/path.py::func"`` / ``"::Class.method"`` for an ``lru_cache``
function or for the one function that writes a key family of a shared
cache. :func:`verify_anchors` proves every declared anchor still resolves
to a real assignment or def in the tree, so the registry cannot rot into
aspirational documentation; the reverse direction — no cache in the tree
left undeclared — is stalelint's ``undeclared-cache`` rule.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib


@dataclasses.dataclass(frozen=True)
class CacheEntry:
    """One declared cache. ``seam``/``ok_calls`` only matter for
    ``snapshot``-class entries: ``seam`` names the functions allowed to
    touch the live anchor (the snapshot taker itself, ``__init__``), and
    ``ok_calls`` names callables the live anchor may be passed to from
    other code paths (persistence sinks that never influence results)."""

    name: str
    anchors: tuple[str, ...]
    keyed_by: str
    scope: str  # process | job | session | task
    coherence: str  # versioned | snapshot | immutable-keyed | speculative-validated
    invalidation: tuple[str, ...]
    seam: tuple[str, ...] = ()
    ok_calls: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Exempt:
    """A heuristic match that is NOT a cache of derived state (a source
    of truth, a metrics sink) — declared so stalelint's undeclared-cache
    rule stays a closed ledger instead of a fuzzy allowlist."""

    anchor: str
    reason: str


@dataclasses.dataclass(frozen=True)
class VersionSource:
    """A declared producer of data-version identity: the thing
    ``versioned`` cache keys must fold in and whose mutation sites carry
    invalidation contracts."""

    name: str
    anchor: str  # "relative/path.py::func" or "::Class.method"
    description: str


@dataclasses.dataclass(frozen=True)
class InvalidationContract:
    """Machine-checked: every ``mutators`` function in ``file`` must
    contain a call whose dotted name ends with each ``must_call`` suffix
    — stalelint's missing-invalidation rule. This is how "eager plan
    bytes are invalidated on rewrite acceptance" stops being a comment
    (scheduler/server.py JobInfo) and becomes a gate failure when the
    call is dropped."""

    source: str
    file: str
    mutators: tuple[str, ...]
    must_call: tuple[str, ...]
    caches: tuple[str, ...]


SCOPES = ("process", "job", "session", "task")
COHERENCE = (
    "versioned", "snapshot", "immutable-keyed", "speculative-validated"
)

CACHES: tuple[CacheEntry, ...] = (
    CacheEntry(
        name="exec-plan-cache",
        anchors=("ballista_tpu_torch/exec/context.py::TorchContext._plan_cache",),
        keyed_by="plan-shape fact key (join fingerprint, LUT domain, "
        "capacity site)",
        scope="session",
        coherence="speculative-validated",
        invalidation=(
            "register_* (through _registered), deregister_table and "
            "append_table clear it",
            "SpeculationMiss pops the invalid keys "
            "(exec/base.py run_with_capacity_retry)",
            "evict_plan_cache bounds it oldest-first",
        ),
    ),
    CacheEntry(
        name="physical-plan-cache",
        anchors=("ballista_tpu_torch/exec/context.py::TorchContext._physical_cache",),
        keyed_by="logical-plan structural fingerprint (plan_fingerprint) "
        "+ sorted session settings + _data_version()",
        scope="session",
        coherence="versioned",
        invalidation=(
            "register_* (through _registered), deregister_table and "
            "append_table clear it",
            "128-entry wholesale clear in create_physical_plan",
        ),
    ),
    CacheEntry(
        name="exec-capacity-hint",
        anchors=("ballista_tpu_torch/exec/context.py::TorchContext._capacity_hint",),
        keyed_by="'agg_capacity' (grow-only working capacity)",
        scope="session",
        coherence="speculative-validated",
        invalidation=(
            "never invalidated: values only grow and an overshoot only "
            "costs memory, not correctness (CapacityError re-grows)",
        ),
    ),
    CacheEntry(
        name="executor-plan-cache",
        anchors=("ballista_tpu_torch/executor/executor.py::Executor._plan_cache",),
        keyed_by="plan-shape fact key, executor-lifetime across jobs",
        scope="process",
        coherence="snapshot",
        invalidation=(
            "task commits merge attempt caches back post-task",
            "evict_plan_cache bounds it oldest-first at commit",
        ),
        seam=("__init__", "_job_snapshot"),
        ok_calls=("save_if_changed", "load_once", "evict_plan_cache"),
    ),
    CacheEntry(
        name="executor-job-snapshots",
        anchors=(
            "ballista_tpu_torch/executor/executor.py::Executor._job_snapshots",
        ),
        keyed_by="job_id -> frozen copy of executor-plan-cache at the "
        "job's first task (the q15 fix)",
        scope="job",
        coherence="snapshot",
        invalidation=("bounded FIFO (64 jobs); a job's entry is only "
                      "needed while its tasks run",),
        seam=("__init__", "_job_snapshot"),
    ),
    CacheEntry(
        name="executor-capacity-hint",
        anchors=(
            "ballista_tpu_torch/executor/executor.py::Executor._capacity_hint",
        ),
        keyed_by="'agg_capacity' (grow-only working capacity)",
        scope="process",
        coherence="speculative-validated",
        invalidation=("never: grow-only, overflow re-grows via "
                      "CapacityError retry",),
    ),
    CacheEntry(
        name="plan-hints",
        anchors=(
            "ballista_tpu_torch/exec/context.py::TorchContext._hints",
            "ballista_tpu_torch/executor/executor.py::Executor._hints",
            "ballista_tpu_torch/scheduler/aqe.py::StrategyStore._persist",
        ),
        keyed_by="plan-shape fact key, persisted across processes "
        "(compilecache/hints.py)",
        scope="process",
        coherence="speculative-validated",
        invalidation=(
            "stale persisted guesses are invalidated at use by the "
            "defer_speculation seam, then overwritten by save_if_changed",
            "4096-entry bound at save",
        ),
    ),
    CacheEntry(
        name="aqe-strategy-store",
        anchors=("ballista_tpu_torch/scheduler/aqe.py::StrategyStore._cache",),
        keyed_by="('aqe'|'aqe_deny', query_class) -> learned rewrite "
        "specs",
        scope="process",
        coherence="speculative-validated",
        invalidation=(
            "unlearn+deny on certificate rejection (self-healing)",
            "load_once prunes non-aqe keys",
        ),
    ),
    CacheEntry(
        name="result-cache",
        anchors=(
            "ballista_tpu_torch/scheduler/result_cache.py::ResultCache._entries",
            "ballista_tpu_torch/scheduler/server.py::SchedulerServer.result_cache",
        ),
        keyed_by="logical-plan serde bytes + sorted session settings + "
        "provider._data_version()",
        scope="process",
        coherence="versioned",
        invalidation=(
            "byte-bounded LRU eviction",
            "in-memory only: a restarted scheduler starts cold",
        ),
    ),
    CacheEntry(
        name="resolved-plan-bytes",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::JobInfo.resolved_plan_bytes",
        ),
        keyed_by="stage id -> shuffle-patched serialized plan (locations "
        "baked in)",
        scope="job",
        coherence="versioned",
        invalidation=(
            "_on_shuffle_lost pops every consumer of the lost producer",
            "apply_certified_rewrite pops every touched/removed stage",
        ),
    ),
    CacheEntry(
        name="eager-plan-bytes",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::JobInfo.eager_plan_bytes",
        ),
        keyed_by="stage id -> eager resolution (location-free, template-"
        "derived only)",
        scope="job",
        coherence="versioned",
        invalidation=(
            "apply_certified_rewrite pops every touched/removed stage "
            "(the only event that changes a template; lost-shuffle "
            "recovery cannot stale these — readers poll locations)",
        ),
    ),
    CacheEntry(
        name="push-registry",
        anchors=("ballista_tpu_torch/executor/push.py::REGISTRY",),
        keyed_by="(job, stage, map task, partition) -> committed pushed "
        "batches",
        scope="process",
        coherence="immutable-keyed",
        invalidation=(
            "window-bounded with atomic spill fallback",
            "job teardown drops the job's streams",
        ),
    ),
    CacheEntry(
        name="flight-pool",
        anchors=("ballista_tpu_torch/client/flight.py::_POOL",),
        keyed_by="(host, port) -> live FlightClient",
        scope="process",
        coherence="immutable-keyed",
        invalidation=(
            "_evict on transport error (ownership to GC)",
            "close_pool() at shutdown",
        ),
    ),
    CacheEntry(
        name="kernel-libraries",
        anchors=("ballista_tpu_torch/ops/cuda_build.py::_libs",),
        keyed_by="kernel source path -> its loaded library, built into "
        "build/kernels/ under the sha1 of the source (an edited source "
        "builds anew)",
        scope="process",
        coherence="immutable-keyed",
        invalidation=(
            "none needed: a library is a pure function of its source "
            "bytes, and the file name carries their hash",
        ),
    ),
    CacheEntry(
        name="partition-launcher",
        anchors=("ballista_tpu_torch/ops/partition.py::_launcher",),
        keyed_by="the partition-hash library (one a process), with its "
        "tile size and per-thread descriptor buffers",
        scope="process",
        coherence="immutable-keyed",
        invalidation=(
            "none needed: set once under _launcher_lock from the loaded "
            "library, never replaced",
        ),
    ),
    CacheEntry(
        name="launch-shape-memo",
        anchors=(
            "ballista_tpu_torch/ops/onehot_agg.py::launch_plan",
            "ballista_tpu_torch/ops/prefix_sum.py::scratch_words",
            "ballista_tpu_torch/exec/repartition.py::partition_ids_fn",
        ),
        keyed_by="the shapes (rows, value rows, slots, mode; rows and "
        "columns; key columns and K) -> launch shape, scratch size or "
        "routing function: pure functions of the key",
        scope="process",
        coherence="immutable-keyed",
        invalidation=(
            "none needed: values depend on the key only, never on the "
            "card or the data (lru_cache bounds)",
        ),
    ),
    CacheEntry(
        name="dictionary-memo",
        anchors=("ballista_tpu_torch/columnar/dict_util.py::_MEMO",),
        keyed_by="(tag, identity of each dictionary) -> a result computed "
        "from those immutable dictionaries",
        scope="process",
        coherence="immutable-keyed",
        invalidation=(
            "weakref.finalize drops an entry when one of its dictionaries "
            "is collected, so an id is never reused while an entry holds "
            "it",
            "bounded at _MEMO_MAX entries",
        ),
    ),
    CacheEntry(
        name="scan-device-cache",
        anchors=(
            "ballista_tpu_torch/exec/scan.py::MemoryScanExec.device_cache",
        ),
        keyed_by="(projection, partition, batch rows) -> the uploaded "
        "device batches of one registered memory table",
        scope="session",
        coherence="immutable-keyed",
        invalidation=(
            "registration-lifetime: a fresh dict rides every "
            "register_table (_Registered.kw), so new data never meets it",
        ),
    ),
    CacheEntry(
        name="file-scan-cache",
        anchors=(
            "ballista_tpu_torch/exec/scan.py::_StagedFileScanExec.scan_cache",
            "ballista_tpu_torch/exec/scan.py::ParquetScanExec.scan_cache",
            "ballista_tpu_torch/exec/context.py::TorchContext.file_scan_cache",
        ),
        keyed_by="(path, file mtime, projection, ...) -> parsed host "
        "table, and ('dev', mtime) -> its uploaded device batches",
        scope="session",
        coherence="versioned",
        invalidation=(
            "a changed file mtime misses and clears the dict",
            "registration-lifetime: register_* makes a new _Registered",
        ),
    ),
    CacheEntry(
        name="shrink-capacities",
        anchors=("ballista_tpu_torch/exec/shrink.py::maybe_shrink",),
        keyed_by="('shrink', site, partition, capacity) in the plan cache "
        "-> the learned smaller capacity (0 = do not shrink)",
        scope="session",
        coherence="speculative-validated",
        invalidation=(
            "a learned capacity the rows outgrow defers a SpeculationMiss "
            "that pops the key and re-runs",
            "plan-cache clears and evict_plan_cache retire it",
        ),
    ),
    CacheEntry(
        name="clustered-aggregate-entries",
        anchors=(
            "ballista_tpu_torch/exec/aggregate.py::HashAggregateExec._run_group_agg",
            "ballista_tpu_torch/exec/aggregate.py::HashAggregateExec._slice_states",
        ),
        keyed_by="('agg_sorted', job, site, from_state, capacity) -> the "
        "input was grouped-adjacent; ('agg_state_cap' | "
        "'agg_state_prefix', job, site, partition) -> the states' live "
        "capacity and prefix shape",
        scope="job",
        coherence="speculative-validated",
        invalidation=(
            "a guess the rows break defers a SpeculationMiss that pops the "
            "key and re-runs (speculation_misses counts it)",
            "job-scoped keys; plan-cache clears and evict_plan_cache "
            "retire them",
        ),
    ),
    CacheEntry(
        name="join-build-cache",
        anchors=("ballista_tpu_torch/exec/joins.py::HashJoinExec._build_cache",),
        keyed_by="slot (('bt_probe', None), ('bt_right',), ('bt_flip',)) "
        "-> the built table; the instance dies with its versioned "
        "physical plan, so a data change can never reuse it",
        scope="session",
        coherence="immutable-keyed",
        invalidation=(
            "committed at a clean task boundary by _build_cache_put, "
            "within ballista.tpu.build_cache_mb via the shared "
            "__build_cache_bytes__ tally",
            "instance-scoped: physical-plan-cache clears retire it",
        ),
    ),
    CacheEntry(
        name="trace-cache",
        anchors=("ballista_tpu_torch/compilecache/tracecache.py::_CACHE",),
        keyed_by="canonical plan signature of the closure (expression "
        "keys, schema keys, join kind) and the device it runs on",
        scope="process",
        coherence="immutable-keyed",
        invalidation=("LRU eviction at 1024 entries", "clear() in tests"),
    ),
    CacheEntry(
        name="dict-hash-cache",
        anchors=("ballista_tpu_torch/ops/partition.py::_dict_hash_cache",),
        keyed_by="tuple of dictionary strings -> stable 64-bit hashes "
        "(deterministic pure function of the key)",
        scope="process",
        coherence="immutable-keyed",
        invalidation=("none needed: value is a pure function of the "
                      "key",),
    ),
    CacheEntry(
        name="capacity-ladder",
        anchors=("ballista_tpu_torch/columnar/batch.py::_LADDER",),
        keyed_by="configured bucket spec -> rounded capacities",
        scope="process",
        coherence="versioned",
        invalidation=("set_capacity_buckets reinstalls the ladder when "
                      "the session spec changes",),
    ),
)

EXEMPT: tuple[Exempt, ...] = (
    Exempt(
        "ballista_tpu_torch/obs/hist.py::REGISTRY",
        "metrics registry: a sink of observations, not derived state "
        "that can go stale against a source",
    ),
    Exempt(
        "ballista_tpu_torch/client/flight.py::_POOL_TOKENS",
        "reswitness bookkeeping riding the flight pool, keyed 1:1 with "
        "_POOL and maintained at the same sites",
    ),
    Exempt(
        "ballista_tpu_torch/exec/context.py::TorchContext._local_history",
        "HistoryStore is the append-only query log — a source of truth, "
        "not derived state",
    ),
    Exempt(
        "ballista_tpu_torch/scheduler/server.py::SchedulerServer.history",
        "HistoryStore is the append-only query log — a source of truth, "
        "not derived state",
    ),
    Exempt(
        "ballista_tpu_torch/scheduler/server.py::SchedulerServer.hists",
        "obs histogram registry: a sink of observations, not derived "
        "state that can go stale against a source",
    ),
    Exempt(
        "ballista_tpu_torch/scheduler/aqe.py::StrategyStore._hint",
        "empty scalar-hint placeholder required by the HintStore API "
        "shape; never read",
    ),
    Exempt(
        "ballista_tpu_torch/exec/base.py::plan_cache_evictions",
        "a counter of plan-cache eviction passes and entries: a sink of "
        "observations, not derived state",
    ),
    Exempt(
        "ballista_tpu_torch/plugin.py::global_registry",
        "UDF plugin registry: the source of truth for registered "
        "functions, not derived state",
    ),
)

VERSION_SOURCES: tuple[VersionSource, ...] = (
    VersionSource(
        name="data-version",
        anchor="ballista_tpu_torch/exec/context.py::TorchContext._data_version",
        description="registered-data signature (memory-table registration "
        "generation + rows, file mtimes); the version every versioned cache "
        "key over table data must fold in",
    ),
    VersionSource(
        name="job-snapshot-seam",
        anchor="ballista_tpu_torch/executor/executor.py::Executor._job_snapshot",
        description="the ONLY sanctioned read of live learned strategies "
        "from the task path: a frozen per-job copy (q15 fix)",
    ),
)

# Machine-checked invalidation contracts (stalelint rule 2). Every
# mutator of a version source must reach the declared invalidation call
# of every dependent cache — drop a ``.clear()``/``.pop()`` and the gate
# goes red.
CONTRACTS: tuple[InvalidationContract, ...] = (
    InvalidationContract(
        source="registered-data",
        file="ballista_tpu_torch/exec/context.py",
        mutators=(
            "register_table", "register_csv", "register_parquet",
            "register_avro",
        ),
        # every registration routes through _registered to inherit its
        # contract (below)
        must_call=("_registered",),
        caches=("exec-plan-cache", "physical-plan-cache"),
    ),
    InvalidationContract(
        source="registered-data-seam",
        file="ballista_tpu_torch/exec/context.py",
        mutators=("_registered", "deregister_table"),
        must_call=("_plan_cache.clear", "_physical_cache.clear"),
        caches=("exec-plan-cache", "physical-plan-cache"),
    ),
    InvalidationContract(
        source="registered-data-append",
        file="ballista_tpu_torch/exec/context.py",
        mutators=("append_table",),
        # append routes through register_table to inherit its contract
        must_call=("register_table",),
        caches=("exec-plan-cache", "physical-plan-cache"),
    ),
    InvalidationContract(
        source="executor-loss",
        file="ballista_tpu_torch/scheduler/server.py",
        mutators=("_on_shuffle_lost",),
        must_call=("resolved_plan_bytes.pop",),
        caches=("resolved-plan-bytes",),
    ),
    InvalidationContract(
        source="rewrite-acceptance",
        file="ballista_tpu_torch/scheduler/server.py",
        mutators=("apply_certified_rewrite",),
        must_call=("resolved_plan_bytes.pop", "eager_plan_bytes.pop"),
        caches=("resolved-plan-bytes", "eager-plan-bytes"),
    ),
)


def _package_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2]


def anchor_index() -> dict[str, str]:
    """anchor -> declared name ('!exempt' entries use the reason ledger
    separately); duplicate anchors are a registry bug caught here."""
    idx: dict[str, str] = {}
    for e in CACHES:
        for a in e.anchors:
            assert a not in idx, f"anchor declared twice: {a}"
            idx[a] = e.name
    for x in EXEMPT:
        assert x.anchor not in idx, f"anchor declared twice: {x.anchor}"
        idx[x.anchor] = "!exempt"
    return idx


def entry(name: str) -> CacheEntry:
    for e in CACHES:
        if e.name == name:
            return e
    raise KeyError(name)


def _resolve_anchor(tree: ast.Module, qual: str) -> bool:
    """Does ``qual`` ('Class.attr', 'Class.method', 'GLOBAL', 'func')
    resolve to a real assignment/def in ``tree``?"""
    parts = qual.split(".")
    if len(parts) == 1:
        name = parts[0]
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and node.name == name:
                return True
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return True
        return False
    cls_name, attr = parts
    for node in tree.body:
        if not (isinstance(node, ast.ClassDef) and node.name == cls_name):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.FunctionDef) and sub.name == attr:
                return True
            targets = []
            if isinstance(sub, ast.Assign):
                targets = sub.targets
            elif isinstance(sub, ast.AnnAssign):
                targets = [sub.target]
            for t in targets:
                # dataclass field: bare Name in the class body
                if isinstance(t, ast.Name) and t.id == attr:
                    return True
                # instance attribute: self.<attr> = ...
                if (
                    isinstance(t, ast.Attribute)
                    and t.attr == attr
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    return True
    return False


def verify_anchors() -> list[str]:
    """Every declared anchor (caches, exemptions, version sources) must
    resolve against the live tree — a renamed attribute goes red here,
    not silently stale in the docs."""
    root = _package_root()
    problems: list[str] = []
    trees: dict[str, ast.Module] = {}

    def tree_for(rel: str) -> ast.Module | None:
        if rel not in trees:
            path = root / rel
            if not path.exists():
                return None
            trees[rel] = ast.parse(path.read_text(), filename=rel)
        return trees[rel]

    anchors = [(a, e.name) for e in CACHES for a in e.anchors]
    anchors += [(x.anchor, "exempt") for x in EXEMPT]
    anchors += [(v.anchor, v.name) for v in VERSION_SOURCES]
    for anchor, owner in anchors:
        rel, _, qual = anchor.partition("::")
        t = tree_for(rel)
        if t is None:
            problems.append(f"{owner}: anchor file missing: {rel}")
        elif not _resolve_anchor(t, qual):
            problems.append(
                f"{owner}: anchor does not resolve: {anchor} "
                "(renamed attribute? update analysis/cachereg.py)"
            )
    for e in CACHES:
        if e.scope not in SCOPES:
            problems.append(f"{e.name}: unknown scope {e.scope!r}")
        if e.coherence not in COHERENCE:
            problems.append(f"{e.name}: unknown coherence {e.coherence!r}")
    for c in CONTRACTS:
        for name in c.caches:
            try:
                entry(name)
            except KeyError:
                problems.append(
                    f"contract {c.source}: unknown cache {name!r}"
                )
    return problems


def render_inventory() -> str:
    """The cache inventory as a markdown table — embedded verbatim in
    docs/analysis.md and checked by the gate (docs_in_sync), the same
    generated-docs discipline as docs/config.md."""
    lines = [
        "| cache | scope | coherence | keyed by | invalidation |",
        "|---|---|---|---|---|",
    ]
    for e in CACHES:
        inval = "; ".join(e.invalidation)
        lines.append(
            f"| `{e.name}` | {e.scope} | {e.coherence} | {e.keyed_by} "
            f"| {inval} |"
        )
    return "\n".join(lines)


def docs_path() -> pathlib.Path:
    """The port's analysis page, inside the package (the repo's
    ``docs/analysis.md`` is the reference's)."""
    return _package_root() / "ballista_tpu_torch" / "docs" / "analysis.md"


def docs_in_sync() -> str | None:
    """None when docs/analysis.md embeds the generated inventory table
    verbatim, else the failure message."""
    try:
        text = docs_path().read_text()
    except OSError as e:
        return f"ballista_tpu_torch/docs/analysis.md unreadable: {e}"
    if render_inventory() not in text:
        return (
            "ballista_tpu_torch/docs/analysis.md cache inventory is out of sync with "
            "analysis/cachereg.py (paste render_inventory() output)"
        )
    return None
