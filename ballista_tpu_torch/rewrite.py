"""Certified plan rewrites: the ONLY sanctioned way to mutate a plan
(port of ``ballista_tpu/rewrite.py``; the typed ops, the certificate and
:func:`apply_rewrite` are the reference's, over the port's operators).

Every runtime re-plan must be provably semantics-preserving before the
scheduler accepts it. This module provides

- **typed rewrite ops** over the copy-on-write stage seam: flip a
  hash-join build side, switch a partitioned join to broadcast, coalesce
  or split a consumer's shuffle buckets, inject or remove an exchange.
  Each op consumes a job's stage list (``distributed_plan.QueryStage`` in
  dependency order) and produces a NEW stage list — untouched stages
  share their plan objects, rewritten stages get fresh plans built from
  shared subtrees, and the input templates are never mutated (exactly the
  discipline ``remove_unresolved_shuffles`` established for resolution).
- a machine-checkable **certificate** (:func:`certify`): six named
  clauses proving schema equivalence, column-resolution preservation,
  partition-function compatibility (bucket-count agreement across every
  reader/writer pair and across partitioned-join sides), device-program
  closure (``compilecache/registry.py``: a rewrite cannot bring in an
  operator whose device programs are not declared), float-sensitivity (a
  MULTISET_EXACT rewrite whose ULP-drift-exposed region feeds a float
  EQUALITY — a float join key or a non-literal float ``=`` predicate —
  is rejected: a last-ULP shift there changes the result SET, the TPC-H
  q15 ``total_revenue = (select max(...))`` shape), and stage-DAG
  well-formedness via the verifier's ``verify_stages``. The certificate
  is re-derivable from the (old, new) stage pair alone, so
  ``SchedulerServer`` re-runs it before accepting a rewrite rather than
  trusting the producer.
- :func:`apply_rewrite` — apply + certify in one step, raising the typed
  :class:`~ballista_tpu_torch.errors.RewriteRejected` (carrying the
  failing clause name) when any clause fails, so an uncertifiable rewrite
  can never reach scheduling.

The static half of the contract is ``analysis/eqlint.py``: direct writes
to structural plan fields anywhere outside this module (and the
``exec.base.replace_children`` primitive it builds on) are lint findings.
The dynamic half is the replay witness (``analysis/replay.py``,
``BALLISTA_REPLAY_WITNESS``): content hashes proving accepted rewrites
preserve results to the exactness class their certificate declares
(``BIT_EXACT`` for order/batching-preserving ops, ``MULTISET_EXACT``
where re-positioned rows re-associate float folds in the last ULP).
"""

from __future__ import annotations

import copy
import dataclasses

from ballista_tpu_torch.distributed_plan import (
    QueryStage,
    UnresolvedShuffleExec,
    find_unresolved_shuffles,
)
from ballista_tpu_torch.errors import PlanVerificationError, RewriteRejected
from ballista_tpu_torch.exec.base import ExecutionPlan, replace_children

CERT_CLAUSES = (
    "schema-equivalence",
    "column-resolution",
    "partition-compat",
    "compile-vocab",
    "float-sensitivity",
    "stage-dag",
)

# Exactness classification every certificate carries. BIT_EXACT rewrites
# preserve each task's input row STREAM (order and batching), so results
# are bit-identical — exchange injection/removal qualifies. MULTISET_EXACT
# rewrites preserve row multisets but move rows across tasks/positions
# (re-bucketing, build-side changes); float folds then re-associate by
# position (the port's dense float sums follow the partitioning), so
# float aggregates downstream may differ in the final ULP. Integer,
# count and decimal money results stay bit-identical either way. The replay witness forgets downstream
# hashes across a MULTISET_EXACT rewrite for exactly this reason.
BIT_EXACT = "bit-exact"
MULTISET_EXACT = "multiset-exact"


# -- copy-on-write tree surgery ----------------------------------------------


def rebuild(plan: ExecutionPlan, children: list[ExecutionPlan]) -> ExecutionPlan:
    """Copy-on-write child rebind: identity-unchanged children return the
    node itself; otherwise a shallow copy is rebound so the original tree
    stays pristine."""
    if all(a is b for a, b in zip(plan.children(), children)):
        return plan
    return replace_children(copy.copy(plan), children)


def transform(plan: ExecutionPlan, fn) -> ExecutionPlan:
    """Bottom-up copy-on-write map: ``fn`` sees each node (with already-
    transformed children) and returns it or a replacement."""
    children = [transform(c, fn) for c in plan.children()]
    return fn(rebuild(plan, children))


def replace_node(
    plan: ExecutionPlan, target: ExecutionPlan, replacement: ExecutionPlan
) -> ExecutionPlan:
    """Copy-on-write replacement of one node located by identity."""
    if plan is target:
        return replacement
    children = [replace_node(c, target, replacement) for c in plan.children()]
    return rebuild(plan, children)


def find_nodes(plan: ExecutionPlan, pred) -> list[ExecutionPlan]:
    """Preorder nodes matching ``pred`` — the occurrence addressing every
    typed op uses (occurrence N = the Nth preorder match)."""
    out: list[ExecutionPlan] = []

    def walk(p: ExecutionPlan) -> None:
        if pred(p):
            out.append(p)
        for c in p.children():
            walk(c)

    walk(plan)
    return out


def _reject(clause: str, message: str, stage_ids: tuple = ()):
    raise RewriteRejected(message, clause=clause, stage_ids=stage_ids)


def _stage(stages: list[QueryStage], stage_id: int) -> QueryStage:
    for s in stages:
        if s.stage_id == stage_id:
            return s
    _reject(
        "op-applicability",
        f"stage {stage_id} does not exist (stages: "
        f"{sorted(s.stage_id for s in stages)})",
        (stage_id,),
    )


def _replace_stage(
    stages: list[QueryStage], stage_id: int, new_plan: ExecutionPlan
) -> list[QueryStage]:
    return [
        QueryStage(s.job_id, s.stage_id, new_plan)
        if s.stage_id == stage_id
        else s
        for s in stages
    ]


# -- typed rewrite ops --------------------------------------------------------


class RewriteOp:
    """A typed, declarative plan rewrite. ``apply`` returns the full NEW
    stage list (dependency order preserved); it never mutates its input.
    Use :func:`apply_rewrite` to get the certificate alongside."""

    # conservative default: preserves row multisets, may permute rows
    # across tasks/positions (see BIT_EXACT/MULTISET_EXACT above)
    exactness = MULTISET_EXACT

    def apply(self, stages: list[QueryStage]) -> list[QueryStage]:
        raise NotImplementedError

    def describe(self) -> str:
        return repr(self)


@dataclasses.dataclass(frozen=True)
class FlipJoinBuildSide(RewriteOp):
    """Swap the build/probe sides of the ``occurrence``-th collect-mode
    INNER hash join in ``stage_id``, wrapping the flipped join in a
    projection that restores the original column order (a bare flip
    changes the output schema: left fields precede right fields). The
    AQE motivation: runtime stats showing the 'build' side is the larger
    one (SURVEY/PAPERS.md: the classic CBO mis-estimate)."""

    stage_id: int
    occurrence: int = 0

    def apply(self, stages: list[QueryStage]) -> list[QueryStage]:
        from ballista_tpu_torch.exec.joins import HashJoinExec
        from ballista_tpu_torch.exec.pipeline import ProjectionExec
        from ballista_tpu_torch.expr import logical as L
        from ballista_tpu_torch.plan.logical import JoinType

        stage = _stage(stages, self.stage_id)
        joins = find_nodes(
            stage.plan, lambda p: isinstance(p, HashJoinExec)
        )
        if self.occurrence >= len(joins):
            _reject(
                "op-applicability",
                f"stage {self.stage_id} has {len(joins)} hash joins; "
                f"occurrence {self.occurrence} does not exist",
                (self.stage_id,),
            )
        join = joins[self.occurrence]
        if join.join_type != JoinType.INNER or join.partition_mode != "collect":
            _reject(
                "op-applicability",
                "build-side flip requires a collect-mode INNER join, got "
                f"{join.join_type.value}/{join.partition_mode} (LEFT/SEMI/"
                "ANTI joins are not commutative on device)",
                (self.stage_id,),
            )
        names = join.schema().names
        if len(set(names)) != len(names):
            _reject(
                "op-applicability",
                "flip needs a column-order-restoring projection, but the "
                f"join output has duplicate column names: {names}",
                (self.stage_id,),
            )
        flipped = HashJoinExec(
            join.right,
            join.left,
            [(b, a) for a, b in join.on],
            JoinType.INNER,
            join.filter,
            partition_mode="collect",
        )
        restored = ProjectionExec(flipped, [L.Column(n) for n in names])
        new_plan = replace_node(stage.plan, join, restored)
        return _replace_stage(stages, self.stage_id, new_plan)


@dataclasses.dataclass(frozen=True)
class SwitchToBroadcast(RewriteOp):
    """Convert the ``occurrence``-th PARTITIONED hash join in ``stage_id``
    to a broadcast (collect-mode) join: the build-side producer stage is
    rewritten to a single unkeyed output partition every probe task
    collects whole, and the probe side keeps its bucketing (so the
    stage's task count is unchanged). The AQE motivation: a build side
    that turned out small enough to broadcast beats re-shuffling the
    probe side."""

    stage_id: int
    occurrence: int = 0

    def apply(self, stages: list[QueryStage]) -> list[QueryStage]:
        from ballista_tpu_torch.exec.joins import HashJoinExec
        from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec

        stage = _stage(stages, self.stage_id)
        joins = find_nodes(
            stage.plan,
            lambda p: isinstance(p, HashJoinExec)
            and p.partition_mode == "partitioned",
        )
        if self.occurrence >= len(joins):
            _reject(
                "op-applicability",
                f"stage {self.stage_id} has {len(joins)} partitioned hash "
                f"joins; occurrence {self.occurrence} does not exist",
                (self.stage_id,),
            )
        join = joins[self.occurrence]
        build = join.right
        if not isinstance(build, UnresolvedShuffleExec):
            _reject(
                "op-applicability",
                "broadcast switch needs the build side to be a direct "
                f"stage read, got {type(build).__name__}",
                (self.stage_id,),
            )
        producer = _stage(stages, build.stage_id)
        readers = [
            u
            for s in stages
            for u in find_unresolved_shuffles(s.plan)
            if u.stage_id == build.stage_id
        ]
        if len(readers) != 1:
            _reject(
                "op-applicability",
                f"build stage {build.stage_id} has {len(readers)} readers; "
                "re-bucketing it to a broadcast would break the others",
                (self.stage_id, build.stage_id),
            )
        new_writer = ShuffleWriterExec(
            producer.job_id, producer.stage_id, producer.plan.input, [], 1
        )
        new_build = UnresolvedShuffleExec(
            build.stage_id, build.schema(), build.input_partition_count, 1
        )
        new_join = HashJoinExec(
            join.left,
            new_build,
            join.on,
            join.join_type,
            join.filter,
            partition_mode="collect",
        )
        out = _replace_stage(
            stages, self.stage_id, replace_node(stage.plan, join, new_join)
        )
        return _replace_stage(out, producer.stage_id, new_writer)


def _set_bucket_count(
    stages: list[QueryStage], consumer_stage_id: int, new_n: int
) -> list[QueryStage]:
    """Shared body of coalesce/split: re-bucket every KEYED producer
    feeding ``consumer_stage_id`` to ``new_n`` output partitions and fix
    the consumer's readers to agree. Re-bucketing all keyed producers of
    one consumer together is what keeps partitioned joins on the
    partition-compat clause (both sides must present one bucket count)."""
    from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec

    if new_n < 1:
        _reject(
            "op-applicability", f"bucket count must be >= 1, got {new_n}"
        )
    consumer = _stage(stages, consumer_stage_id)
    by_id = {s.stage_id: s for s in stages}
    keyed = [
        u
        for u in find_unresolved_shuffles(consumer.plan)
        if by_id[u.stage_id].plan.partition_keys
    ]
    if not keyed:
        _reject(
            "op-applicability",
            f"stage {consumer_stage_id} reads no keyed (hash-bucketed) "
            "producers; nothing to re-bucket",
            (consumer_stage_id,),
        )
    producer_ids = {u.stage_id for u in keyed}
    for s in stages:
        if s.stage_id == consumer_stage_id:
            continue
        hit = [
            u.stage_id
            for u in find_unresolved_shuffles(s.plan)
            if u.stage_id in producer_ids
        ]
        if hit:
            _reject(
                "op-applicability",
                f"producers {sorted(set(hit))} also feed stage "
                f"{s.stage_id}; re-bucketing would desync its readers",
                (consumer_stage_id, s.stage_id),
            )

    def fix_reader(node: ExecutionPlan) -> ExecutionPlan:
        if (
            isinstance(node, UnresolvedShuffleExec)
            and node.stage_id in producer_ids
        ):
            return UnresolvedShuffleExec(
                node.stage_id,
                node.schema(),
                node.input_partition_count,
                new_n,
            )
        return node

    out = _replace_stage(
        stages, consumer_stage_id, transform(consumer.plan, fix_reader)
    )
    for pid in sorted(producer_ids):
        w = by_id[pid].plan
        out = _replace_stage(
            out,
            pid,
            ShuffleWriterExec(
                by_id[pid].job_id, pid, w.input, list(w.partition_keys), new_n
            ),
        )
    return out


@dataclasses.dataclass(frozen=True)
class CoalesceShufflePartitions(RewriteOp):
    """Shrink the hash-bucket count feeding consumer ``stage_id`` to
    ``new_n`` (every keyed producer re-buckets together). The AQE
    motivation: runtime stats showing tiny shuffle partitions — fewer,
    fuller buckets amortize per-task costs."""

    stage_id: int
    new_n: int

    def apply(self, stages: list[QueryStage]) -> list[QueryStage]:
        current = _stage(stages, self.stage_id).input_partition_count
        if self.new_n >= current:
            _reject(
                "op-applicability",
                f"coalesce must shrink the bucket count: {current} -> "
                f"{self.new_n}",
                (self.stage_id,),
            )
        return _set_bucket_count(stages, self.stage_id, self.new_n)


@dataclasses.dataclass(frozen=True)
class SplitShufflePartitions(RewriteOp):
    """Grow the hash-bucket count feeding consumer ``stage_id`` to
    ``new_n`` — the skew remedy: a hot bucket splits across more tasks.
    (Same machinery as coalesce; both sides of a partitioned join
    re-bucket together so partition-compat holds.)"""

    stage_id: int
    new_n: int

    def apply(self, stages: list[QueryStage]) -> list[QueryStage]:
        current = _stage(stages, self.stage_id).input_partition_count
        if self.new_n <= current:
            _reject(
                "op-applicability",
                f"split must grow the bucket count: {current} -> "
                f"{self.new_n}",
                (self.stage_id,),
            )
        return _set_bucket_count(stages, self.stage_id, self.new_n)


@dataclasses.dataclass(frozen=True)
class InjectExchange(RewriteOp):
    """Materialize the ``occurrence``-th single-partition subtree of
    ``stage_id`` as its own stage (an unkeyed single-output exchange): the
    subtree computes once, its output is fetched by the consumer instead
    of being recomputed inside every retry/attempt of the consumer task.
    Only single-partition subtrees are eligible — materializing one
    preserves the consumer's task structure exactly."""

    stage_id: int
    occurrence: int = 0
    exactness = BIT_EXACT  # per-task row streams are unchanged

    def apply(self, stages: list[QueryStage]) -> list[QueryStage]:
        from ballista_tpu_torch.exec.base import UnknownPartitioning
        from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec

        stage = _stage(stages, self.stage_id)

        def eligible(p: ExecutionPlan) -> bool:
            if p is stage.plan or isinstance(p, UnresolvedShuffleExec):
                return False
            part = p.output_partitioning()
            return isinstance(
                part, UnknownPartitioning
            ) and part.n == 1

        nodes = find_nodes(stage.plan, eligible)
        if self.occurrence >= len(nodes):
            _reject(
                "op-applicability",
                f"stage {self.stage_id} has {len(nodes)} single-partition "
                f"subtrees; occurrence {self.occurrence} does not exist",
                (self.stage_id,),
            )
        target = nodes[self.occurrence]
        new_id = max(s.stage_id for s in stages) + 1
        writer = ShuffleWriterExec(stage.job_id, new_id, target, [], 1)
        placeholder = UnresolvedShuffleExec(new_id, target.schema(), 1, 1)
        new_plan = replace_node(stage.plan, target, placeholder)
        out: list[QueryStage] = []
        for s in stages:
            if s.stage_id == self.stage_id:
                # the new producer slots in directly before its consumer,
                # which sat after all of the subtree's own dependencies —
                # dependency order is preserved
                out.append(QueryStage(stage.job_id, new_id, writer))
                out.append(QueryStage(s.job_id, s.stage_id, new_plan))
            else:
                out.append(s)
        return out


@dataclasses.dataclass(frozen=True)
class RemoveExchange(RewriteOp):
    """Inline producer stage ``stage_id`` (an unkeyed single-output
    exchange with exactly one reader) into its consumer: the fragment
    executes inside the consumer task instead of materializing through a
    shuffle file — the inverse of :class:`InjectExchange`, and the
    small-build-side remedy when the materialization round trip costs
    more than recomputing the fragment."""

    stage_id: int
    exactness = BIT_EXACT  # per-task row streams are unchanged

    def apply(self, stages: list[QueryStage]) -> list[QueryStage]:
        from ballista_tpu_torch.exec.pipeline import CoalescePartitionsExec

        producer = _stage(stages, self.stage_id)
        w = producer.plan
        if w.partition_keys or w.output_partitions != 1:
            _reject(
                "op-applicability",
                f"stage {self.stage_id} is a keyed/multi-output exchange; "
                "only unkeyed single-output exchanges can be inlined",
                (self.stage_id,),
            )
        consumers = [
            s
            for s in stages
            if any(
                u.stage_id == self.stage_id
                for u in find_unresolved_shuffles(s.plan)
            )
        ]
        if len(consumers) != 1:
            _reject(
                "op-applicability",
                f"stage {self.stage_id} has {len(consumers)} consumers; "
                "inlining needs exactly one",
                (self.stage_id,),
            )
        consumer = consumers[0]
        readers = [
            u
            for u in find_unresolved_shuffles(consumer.plan)
            if u.stage_id == self.stage_id
        ]
        if len(readers) != 1:
            _reject(
                "op-applicability",
                f"consumer stage {consumer.stage_id} reads stage "
                f"{self.stage_id} {len(readers)} times; inlining would "
                "execute the fragment once per read",
                (self.stage_id, consumer.stage_id),
            )
        frag = w.input
        inline = (
            frag
            if frag.output_partitioning().n == 1
            else CoalescePartitionsExec(frag)
        )
        new_plan = replace_node(consumer.plan, readers[0], inline)
        return [
            QueryStage(consumer.job_id, consumer.stage_id, new_plan)
            if s.stage_id == consumer.stage_id
            else s
            for s in stages
            if s.stage_id != self.stage_id
        ]


# -- the certificate ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CertClause:
    name: str
    ok: bool
    detail: str = ""

    def __str__(self) -> str:
        return f"{self.name}: {'OK' if self.ok else 'FAIL'}" + (
            f" — {self.detail}" if self.detail else ""
        )


@dataclasses.dataclass(frozen=True)
class RewriteCertificate:
    """The machine-checkable proof attached to a rewrite. Derived purely
    from the (old, new) stage lists (see :func:`certify`), so any holder
    of both — in particular the scheduler's acceptance gate — can
    re-derive and compare rather than trust the producer's copy."""

    op: str
    job_id: str
    rewritten_stages: tuple[int, ...]  # present in both, plan changed
    added_stages: tuple[int, ...]
    removed_stages: tuple[int, ...]
    bucket_changed_stages: tuple[int, ...]  # output partition count changed
    # BIT_EXACT | MULTISET_EXACT (see module constants): what equality the
    # certificate promises for results downstream of the rewrite
    exactness: str
    clauses: tuple[CertClause, ...]

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.clauses)

    @property
    def failing(self) -> CertClause | None:
        return next((c for c in self.clauses if not c.ok), None)

    def summary(self) -> str:
        head = (
            f"VALID [{self.exactness}]"
            if self.ok
            else f"REJECTED ({self.failing.name})"
        )
        touched = ", ".join(
            f"{k}={list(v)}"
            for k, v in (
                ("rewritten", self.rewritten_stages),
                ("added", self.added_stages),
                ("removed", self.removed_stages),
            )
            if v
        )
        return f"certificate {head} for {self.op}: {touched or 'no-op'}"


def _schema_sig(plan: ExecutionPlan):
    return tuple((f.name, f.dtype, f.nullable) for f in plan.schema())


def _float_equality_hazards(plan: ExecutionPlan) -> list[str]:
    """Float-equality sites in one stage plan: hash-join keys of floating
    dtype, and non-literal ``=``/``!=`` comparisons with a floating
    operand inside filter predicates or join residual filters. Literal
    comparisons (``l_discount = 0.06``) are exempt: scan values do not
    drift — only DERIVED floats do."""
    from ballista_tpu_torch.datatypes import Schema
    from ballista_tpu_torch.exec.joins import HashJoinExec
    from ballista_tpu_torch.exec.pipeline import FilterExec
    from ballista_tpu_torch.expr import logical as L

    out: list[str] = []

    def expr_hazards(expr, schema) -> None:
        if isinstance(expr, L.BinaryExpr) and expr.op in (
            L.Operator.EQ,
            L.Operator.NEQ,
        ):
            sides = (expr.left, expr.right)
            if not any(
                isinstance(s, (L.Literal, L.IntervalLiteral))
                for s in sides
            ):
                try:
                    floaty = any(
                        s.data_type(schema).is_floating for s in sides
                    )
                except Exception:  # noqa: BLE001 — untypeable operands
                    # cannot be proven safe; treat as hazardous
                    floaty = True
                if floaty:
                    out.append(
                        f"non-literal float equality {expr.name()!r}"
                    )
        for c in expr.children():
            expr_hazards(c, schema)

    for node in find_nodes(plan, lambda p: True):
        if isinstance(node, HashJoinExec):
            ls, rs = node.left.schema(), node.right.schema()
            for a, b in node.on:
                try:
                    if (
                        a.data_type(ls).is_floating
                        or b.data_type(rs).is_floating
                    ):
                        out.append(
                            f"float join key {a.name()} = {b.name()}"
                        )
                except Exception:  # noqa: BLE001
                    out.append(f"untypeable join key {a.name()}")
            if node.filter is not None:
                expr_hazards(
                    node.filter,
                    Schema(list(ls.fields) + list(rs.fields)),
                )
        elif isinstance(node, FilterExec):
            expr_hazards(node.predicate, node.input.schema())
    return out


def certify(
    old_stages: list[QueryStage],
    new_stages: list[QueryStage],
    op: RewriteOp | str = "",
    job_id: str = "",
) -> RewriteCertificate:
    """Derive the six-clause certificate for an (old, new) stage-list
    pair. Never raises on a failing clause — the clause records the
    failure and ``ok`` goes False (callers that must not proceed use
    :func:`apply_rewrite`, which raises :class:`RewriteRejected`)."""
    old_by = {s.stage_id: s for s in old_stages}
    new_by = {s.stage_id: s for s in new_stages}
    rewritten = tuple(
        sid
        for sid in sorted(new_by)
        if sid in old_by and new_by[sid].plan is not old_by[sid].plan
    )
    added = tuple(sorted(set(new_by) - set(old_by)))
    removed = tuple(sorted(set(old_by) - set(new_by)))
    bucket_changed = tuple(
        sid
        for sid in rewritten
        if new_by[sid].plan.output_partitions
        != old_by[sid].plan.output_partitions
    )
    clauses: list[CertClause] = []

    # 1) schema-equivalence: the job's observable output — the terminal
    # stage's schema — and every surviving rewritten stage's root schema
    # are unchanged (a rewrite that changes what a stage PRODUCES is a
    # different query, not an optimization).
    try:
        probs = []
        if not new_stages:
            probs.append("rewrite produced an empty stage list")
        elif old_stages and _schema_sig(old_stages[-1].plan) != _schema_sig(
            new_stages[-1].plan
        ):
            probs.append(
                "terminal stage schema changed: "
                f"{_schema_sig(old_stages[-1].plan)} -> "
                f"{_schema_sig(new_stages[-1].plan)}"
            )
        for sid in rewritten:
            if _schema_sig(old_by[sid].plan) != _schema_sig(new_by[sid].plan):
                probs.append(f"stage {sid} output schema changed")
        clauses.append(
            CertClause("schema-equivalence", not probs, "; ".join(probs))
        )
    except Exception as e:  # noqa: BLE001 — a schema that cannot even be
        # computed fails the clause rather than crashing certification
        clauses.append(
            CertClause(
                "schema-equivalence", False, f"schema computation failed: {e}"
            )
        )

    # 2) column-resolution: the planlint physical walk over every touched
    # stage (resolves every expression against its input schema with the
    # engine's own lookup rule, plus dtype legality).
    from ballista_tpu_torch.analysis import verify_physical

    res_probs = []
    for sid in rewritten + added:
        try:
            verify_physical(new_by[sid].plan)
        except PlanVerificationError as e:
            res_probs.append(f"stage {sid}: {e.reason}")
        except Exception as e:  # noqa: BLE001
            res_probs.append(f"stage {sid}: {type(e).__name__}: {e}")
    clauses.append(
        CertClause("column-resolution", not res_probs, "; ".join(res_probs))
    )

    # 3) partition-compat: bucket-count agreement across every
    # reader/writer pair, and across both sides of every partitioned
    # join (verify_stages re-checks the former; the explicit clause
    # pinpoints the violated pair when a rewrite desyncs one).
    from ballista_tpu_torch.exec.joins import HashJoinExec

    part_probs = []
    for s in new_stages:
        for u in find_unresolved_shuffles(s.plan):
            ref = new_by.get(u.stage_id)
            if ref is None:
                part_probs.append(
                    f"stage {s.stage_id} reads missing stage {u.stage_id}"
                )
            elif ref.plan.output_partitions != u.output_partition_count:
                part_probs.append(
                    f"stage {s.stage_id} expects {u.output_partition_count} "
                    f"buckets of stage {u.stage_id}, writer produces "
                    f"{ref.plan.output_partitions}"
                )
        for j in find_nodes(
            s.plan,
            lambda p: isinstance(p, HashJoinExec)
            and p.partition_mode == "partitioned",
        ):
            nl = j.left.output_partitioning().n
            nr = j.right.output_partitioning().n
            if nl != nr:
                part_probs.append(
                    f"stage {s.stage_id} partitioned join sides disagree: "
                    f"left={nl}, right={nr}"
                )
    clauses.append(
        CertClause("partition-compat", not part_probs, "; ".join(part_probs))
    )

    # 4) compile-vocab: every operator of every touched stage must map to
    # its declared device programs (compilecache/registry.py) — a rewrite
    # must not bring in an operator with an undeclared device surface.
    from ballista_tpu_torch.compilecache import registry

    vocab_probs = []
    for sid in rewritten + added:
        vocab_probs += [
            f"stage {sid}: {p}" for p in registry.check_plan(new_by[sid].plan)
        ]
    clauses.append(
        CertClause("compile-vocab", not vocab_probs, "; ".join(vocab_probs))
    )

    # 5) float-sensitivity: only for MULTISET_EXACT ops — the touched
    # stages and their transitive consumers are exposed to last-ULP float
    # drift (tiled reductions re-associate when rows move), which is
    # harmless in a float VALUE but flips a float EQUALITY: a float join
    # key or a non-literal float =/!= predicate downstream turns ULP
    # drift into a changed result SET (q15: total_revenue = max(...)).
    exactness = op.exactness if isinstance(op, RewriteOp) else MULTISET_EXACT
    fprobs: list[str] = []
    if exactness == MULTISET_EXACT and (rewritten or added):
        exposed = set(rewritten) | set(added)
        consumers: dict[int, set[int]] = {}
        for s in new_stages:
            for u in find_unresolved_shuffles(s.plan):
                consumers.setdefault(u.stage_id, set()).add(s.stage_id)
        frontier = set(exposed)
        while frontier:
            frontier = {
                c for sid in frontier for c in consumers.get(sid, set())
            } - exposed
            exposed |= frontier
        for s in new_stages:
            if s.stage_id in exposed:
                fprobs += [
                    f"stage {s.stage_id}: {p}"
                    for p in _float_equality_hazards(s.plan)
                ]
    clauses.append(
        CertClause("float-sensitivity", not fprobs, "; ".join(fprobs))
    )

    # 6) stage-dag: the full planlint stage verifier over the rewritten
    # DAG (unique ids, dependency-ordered references, reader/writer
    # schema + partition agreement, per-stage physical verification).
    from ballista_tpu_torch.analysis import verify_stages

    try:
        rep = verify_stages(new_stages)
        clauses.append(CertClause("stage-dag", True, rep.summary()))
    except PlanVerificationError as e:
        clauses.append(CertClause("stage-dag", False, e.reason))
    except Exception as e:  # noqa: BLE001
        clauses.append(
            CertClause("stage-dag", False, f"{type(e).__name__}: {e}")
        )

    return RewriteCertificate(
        op=op.describe() if isinstance(op, RewriteOp) else str(op),
        job_id=job_id or (new_stages[0].job_id if new_stages else ""),
        rewritten_stages=rewritten,
        added_stages=added,
        removed_stages=removed,
        bucket_changed_stages=bucket_changed,
        exactness=(
            op.exactness if isinstance(op, RewriteOp) else MULTISET_EXACT
        ),
        clauses=tuple(clauses),
    )


@dataclasses.dataclass(frozen=True)
class CertifiedRewrite:
    stages: list[QueryStage]
    certificate: RewriteCertificate


def apply_rewrite(
    stages: list[QueryStage], op: RewriteOp, job_id: str = ""
) -> CertifiedRewrite:
    """Apply ``op`` and certify the result; raises
    :class:`RewriteRejected` (with the failing clause) instead of ever
    returning an uncertified stage list. The input list and its plans are
    never mutated — a rejection leaves the pristine templates untouched
    by construction."""
    new_stages = op.apply(list(stages))
    cert = certify(stages, new_stages, op, job_id)
    if not cert.ok:
        c = cert.failing
        raise RewriteRejected(
            f"{op.describe()}: {c.detail or c.name}",
            clause=c.name,
            stage_ids=cert.rewritten_stages
            + cert.added_stages
            + cert.removed_stages,
        )
    return CertifiedRewrite(new_stages, cert)
