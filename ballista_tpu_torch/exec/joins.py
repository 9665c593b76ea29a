"""Hash join, union, cross join and the empty relation, collect mode (port
of ``HashJoinExec``, ``UnionExec``, ``CrossJoinExec`` and ``EmptyExec`` in
``ballista_tpu/exec/joins.py``).

The build side is collected whole (broadcast within the process), sorted
once by packed key and probed batch by batch with the binary-search kernel
(``ops/join.py``). LEFT, SEMI and ANTI keep the left input as the probe
side. INNER builds the right side; if the right side has duplicate keys and
the left has none, it builds the left and streams the right through it; if
both have duplicates it runs the m:n expansion. The expansion allocates
``ballista.tpu.join_expansion`` output rows per probe row; a join that needs
more raises a CapacityError at the task boundary and the run is retried
with that join's capacity grown to what it needed (kept per join and
partition, apart from the aggregates' capacity), so no row is ever dropped.

A residual join filter sees probe ++ build columns. On a unique build it is
evaluated on the LEFT-probed batch; on a duplicated build, on every
expanded pair, and SEMI and ANTI then keep a probe row when any pair
passes. LEFT nulls the build side of a row whose pairs all fail.

Build strategies (duplicate and contiguity flags) and probe-table sizes
are learned into the plan cache: a warm run takes them without a host
sync and validates them with deferred speculation flags.

Partitioned mode (``partition_mode="partitioned"``, planned by the
distributed planner over a hash repartition of both sides) joins each
partition's bucket on its own, duplicate build keys through the m:n
expansion. Under a device-memory budget (``ballista.tpu.hbm_budget_mb``) a
collect-mode join collects its build side incrementally; once it crosses
the budget, both sides are hash-spilled to host Arrow IPC buckets and the
join runs bucket range by bucket range (``_grace_build``,
``_execute_grace``) for INNER, LEFT, SEMI and ANTI.

Built tables are kept across runs on the plan instance (``_build_cache``),
under ``ballista.tpu.build_cache_mb``: a warm collect-mode join reuses the
sorted build side an earlier clean run made, and the budget check of
``hbm_budget_mb`` is skipped when one is cached. A warm INNER join whose
right side was learned to hold duplicates and whose left side was learned
to be unique (integer keys) builds the left side (or takes it from the
cache) and streams the right side through it without collecting it.

Four output sites go through the adaptive capacity shrink
(``exec/shrink.maybe_shrink``), as in the reference: the grace passes
(site ``display() + "|grace"``), the probe loop of LEFT, SEMI, ANTI and
partitioned joins, and the two streamed INNER flips, learned and cold
(probe partition 0). A selective join (q18's SEMI against a small HAVING
set) then hands the rest of the plan a batch at the data's scale. The
unique-build INNER probe and the m:n expansion do not shrink.
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterator

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch, Dictionary, round_capacity
from ballista_tpu_torch.columnar.dict_util import merge_many, remap_codes
from ballista_tpu_torch.compilecache.tracecache import expr_key, schema_key, shared_callable
from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.errors import ExecutionError, PlanError
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, UnknownPartitioning
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.expr.physical import compile_expr
from ballista_tpu_torch.ops.compact import compact
from ballista_tpu_torch.ops.concat import concat_batches
from ballista_tpu_torch.ops.join import (
    LUT_MAX_DOMAIN,
    BuildTable,
    JoinSide,
    attach_lut,
    build_side,
    expand_join,
    lut_stale,
    probe_counts,
    probe_side,
)
from ballista_tpu_torch.plan.logical import JoinType


def _collect(plan: ExecutionPlan, ctx: TaskContext) -> DeviceBatch:
    """Every partition of ``plan``, concatenated into one batch."""
    batches = []
    for p in range(plan.output_partitioning().n):
        batches.extend(plan.execute(p, ctx))
    if not batches:
        return DeviceBatch.empty(plan.schema(), device=ctx.device)
    return concat_batches(batches)


def _collect_partition(plan: ExecutionPlan, ctx: TaskContext, partition: int) -> DeviceBatch:
    """Partitioned mode's build side: only this partition's hash bucket."""
    batches = list(plan.execute(partition, ctx))
    if not batches:
        return DeviceBatch.empty(plan.schema(), device=ctx.device)
    return concat_batches(batches)


class HashJoinExec(ExecutionPlan):
    _KIND = {
        JoinType.INNER: JoinSide.INNER,
        JoinType.LEFT: JoinSide.LEFT,
        JoinType.SEMI: JoinSide.SEMI,
        JoinType.ANTI: JoinSide.ANTI,
    }
    # Probes below this capacity do not pay for a direct-address table.
    _LUT_MIN_PROBE = 1 << 17

    def __init__(
        self,
        left: ExecutionPlan,
        right: ExecutionPlan,
        on: list[tuple[L.Expr, L.Expr]],
        join_type: JoinType,
        filter: L.Expr | None = None,
        partition_mode: str = "collect",
    ) -> None:
        """``partition_mode``: "collect" broadcasts the whole build side to
        every probe partition; "partitioned" assumes both inputs are
        hash-partitioned on the join keys, and each partition joins its own
        bucket."""
        super().__init__()
        if partition_mode not in ("collect", "partitioned"):
            raise PlanError(f"bad join partition mode {partition_mode!r}")
        self.left = left
        self.right = right
        self.on = list(on)
        self.join_type = join_type
        self.filter = filter
        self.partition_mode = partition_mode
        # built tables kept across runs, by slot (see _build_cache_put)
        self._build_cache: dict = {}
        # the right side's strategy flags are the same for every partition:
        # computed once per run without a plan cache
        self._decide_flags: tuple | None = None
        self._decide_from_cache = False
        self._plan_text: str | None = None  # display(), for capacity keys
        self._filter_key: tuple | None = None  # see _passes
        ls, rs = left.schema(), right.schema()
        for a, b in self.on:
            if not (isinstance(a, L.Column) and isinstance(b, L.Column)):
                raise PlanError("join keys must be columns (planner projects)")
        if join_type in (JoinType.SEMI, JoinType.ANTI):
            self._schema = ls
        elif join_type == JoinType.LEFT:
            self._schema = ls.join(Schema([Field(f.name, f.dtype, True) for f in rs]))
        elif join_type == JoinType.INNER:
            self._schema = ls.join(rs)
        else:
            raise PlanError(f"join type {join_type} not supported on device yet")

    def schema(self) -> Schema:
        return self._schema

    def children(self) -> list[ExecutionPlan]:
        return [self.left, self.right]

    def output_partitioning(self):
        return self.left.output_partitioning()

    def describe(self) -> str:
        on = ", ".join(f"{a.name()} = {b.name()}" for a, b in self.on)
        f = f", filter={self.filter.name()}" if self.filter is not None else ""
        return f"HashJoinExec({self.join_type.value}, {self.partition_mode}): on=[{on}]{f}"

    # -- dictionaries ---------------------------------------------------------
    def _unify_key_dicts(
        self, build: DeviceBatch, probe: DeviceBatch,
        build_keys: list[int], probe_keys: list[int],
    ) -> tuple[DeviceBatch, DeviceBatch]:
        """String join keys must share a dictionary; remap both sides onto
        the merged one (returns the inputs themselves when nothing
        changed)."""
        for bi, pi in zip(build_keys, probe_keys):
            bf = build.schema.fields[bi]
            pf = probe.schema.fields[pi]
            if bf.dtype != DataType.STRING and pf.dtype != DataType.STRING:
                continue
            bd = build.dictionaries.get(bf.name)
            pd_ = probe.dictionaries.get(pf.name)
            if bd is None or pd_ is None:
                raise ExecutionError(f"string join key {bf.name!r} missing dictionary")
            if bd.values == pd_.values:
                continue
            merged, (rb, rp) = merge_many((bd, pd_))
            bcols = list(build.columns)
            bcols[bi] = remap_codes(build.columns[bi], rb)
            build = DeviceBatch(
                schema=build.schema, columns=tuple(bcols), valid=build.valid,
                nulls=build.nulls, dictionaries={**build.dictionaries, bf.name: merged},
            )
            pcols = list(probe.columns)
            pcols[pi] = remap_codes(probe.columns[pi], rp)
            probe = DeviceBatch(
                schema=probe.schema, columns=tuple(pcols), valid=probe.valid,
                nulls=probe.nulls, dictionaries={**probe.dictionaries, pf.name: merged},
            )
        return build, probe

    # -- cross-run build-table cache ------------------------------------------
    # A warm run would collect and sort every build side again (and a SEMI
    # build re-runs its whole subquery: q18's HAVING aggregate). Built
    # tables are kept on this plan instance, which the context's physical
    # plan cache keys by the registered data and the settings: new data or
    # settings give a new instance, and the old tables go with the old one.
    # Admission is bounded by ballista.tpu.build_cache_mb through a tally in
    # the plan cache that all of the context's plans share. String-keyed
    # builds are not kept: a probe's dictionary unification can rebuild them.

    _CACHE_SLOTS = (("bt_probe", None), ("bt_right",), ("bt_flip",))

    def _build_cache_put(
        self, ctx: TaskContext, slot: tuple, build_batch: DeviceBatch,
        bt: BuildTable | None, key_idxs: list[int],
    ) -> None:
        """Offer a built table for ``slot``; it is stored at the run's clean
        task boundary, if the tally leaves room for it. Its size counts the
        build batch, the sorted batch, the packed and the sorted key columns
        and a direct-address table attached by then (one attached later is
        not counted, as in the reference)."""
        if slot in self._build_cache or bt is None:
            return
        cache = ctx.plan_cache
        if cache is None or not ctx.cache_builds:
            return
        if any(build_batch.schema.fields[i].dtype == DataType.STRING for i in key_idxs):
            return
        budget = ctx.config.build_cache_mb() << 20
        if budget <= 0:
            return
        size = sum(c.nbytes for c in build_batch.columns)
        size += sum(c.nbytes for c in bt.batch.columns)
        size += bt.keys.nbytes + sum(c.nbytes for c in bt.key_cols)
        if bt.lut2 is not None:
            size += bt.lut2.nbytes

        def commit() -> None:
            # only at a clean task boundary: a run that fails its deferred
            # checks (an overflowed aggregate under a SEMI build, a stale
            # speculation) built this table from truncated input
            if slot in self._build_cache:
                return
            used = cache.get("__build_cache_bytes__", 0)
            if used + size > budget:
                self.metrics.add("build_cache_skip")
                return
            cache["__build_cache_bytes__"] = used + size
            self._build_cache[slot] = (build_batch, bt)
            self.metrics.add("build_cache_store")

        ctx.defer_commit(commit)

    # -- execution ------------------------------------------------------------
    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        ls, rs = self.left.schema(), self.right.schema()
        left_keys = [L.resolve_field_index(ls, a.cname) for a, _ in self.on]
        right_keys = [L.resolve_field_index(rs, b.cname) for _, b in self.on]
        if self.partition_mode == "partitioned":
            # both inputs are hash-partitioned on the keys: this partition's
            # bucket joins on its own, duplicate build keys by expansion
            yield from self._probe_loop(
                partition, ctx, lambda: _collect_partition(self.right, ctx, partition),
                left_keys, right_keys, self._KIND[self.join_type],
            )
            return
        learned = (
            self._learned_flip(ctx, left_keys, right_keys)
            if self.join_type == JoinType.INNER else None
        )
        budget = ctx.config.hbm_budget_mb() << 20
        if budget and learned is None and not any(s in self._build_cache for s in self._CACHE_SLOTS):
            # no budget check where a warm path already settled it: a
            # learned flip builds the unique left side and streams the right
            # (the check would collect or spill the whole right subtree),
            # and a cached table fitted the card when it was admitted
            grace = self._grace_build(ctx, right_keys, budget)
            if grace is not None:
                yield from self._execute_grace(partition, ctx, grace, left_keys, right_keys)
                return
        try:
            if self.join_type == JoinType.INNER:
                yield from self._execute_inner(partition, ctx, left_keys, right_keys, learned)
                return
            # LEFT/SEMI/ANTI: the left side is preserved, so it probes
            yield from self._probe_loop(
                partition, ctx, lambda: self._collect_right(ctx),
                left_keys, right_keys, self._KIND[self.join_type],
            )
        finally:
            # drop an unconsumed stash of the budget check on every exit (an
            # empty probe side, an error, a LIMIT that stops early), or the
            # collected build side stays pinned on this plan instance, which
            # outlives the run in the context's plan cache
            c = getattr(self, "_grace_under", None)
            if c is not None and c[0] is ctx:
                self._grace_under = None

    # -- grace-hash out-of-core path ------------------------------------------
    # Bucket fan-out of the spill files. K passes (a power of two dividing
    # it, chosen once the build side's size is known) take consecutive
    # bucket ranges of both sides; equal keys share a bucket on both.
    _GRACE_BUCKETS = 64

    def _collect_right(self, ctx: TaskContext) -> DeviceBatch:
        """The collected build side: the batch the budget check collected
        when it found the side fits (one-shot: the stash is dropped when
        taken), else a fresh collection."""
        c = getattr(self, "_grace_under", None)
        if c is not None and c[0] is ctx:
            self._grace_under = None
            return c[1]
        return _collect(self.right, ctx)

    def _grace_build(self, ctx: TaskContext, right_keys: list[int], budget: int):
        """Collect the build side under the device budget. Returns None
        when it fits (stashing the collected batch for the in-memory
        paths), else (spill set, K passes): the batches collected so far and
        the rest of the stream are hash-routed to host bucket files. Decided
        once per task context: every probe partition shares the spilled
        build side."""
        cached = getattr(self, "_grace_cache", None)
        if cached is not None and cached[0] is ctx:
            return cached[1]
        from ballista_tpu_torch.exec.spill import (
            choose_passes,
            device_nbytes,
            spill_batch_by_keys,
        )

        keys = tuple(right_keys)
        batches: list[DeviceBatch] = []
        nbytes = 0
        sset = None
        spilled = 0
        with self.metrics.time("build_time"):
            for p in range(self.right.output_partitioning().n):
                for b in self.right.execute(p, ctx):
                    nbytes += device_nbytes(b)
                    if sset is None and nbytes * 2 > budget:
                        # crossed the budget (a build table costs about twice
                        # the side: the sorted copy and the key arrays):
                        # drain what is resident and spill from here on
                        sset = ctx.spill_manager().new_set(
                            f"join-build-{id(self):x}", self._GRACE_BUCKETS
                        )
                        for prev in batches:
                            spilled += spill_batch_by_keys(sset, prev, keys)
                        batches.clear()
                    if sset is None:
                        batches.append(b)
                    else:
                        spilled += spill_batch_by_keys(sset, b, keys)
        if sset is None:
            build = (
                concat_batches(batches) if batches
                else DeviceBatch.empty(self.right.schema(), device=ctx.device)
            )
            self._grace_under = (ctx, build)
            self._grace_cache = (ctx, None)
            return None
        sset.finish_writes()
        self.metrics.add("spill_bytes", spilled)
        k = choose_passes(nbytes, budget, self._GRACE_BUCKETS)
        # once per decision, not per probe partition: plan_counters sums
        # the operators' counters
        self.metrics.add("spill_passes", k)
        self._grace_cache = (ctx, (sset, k))
        return (sset, k)

    def _execute_grace(
        self, partition: int, ctx: TaskContext, grace: tuple,
        left_keys: list[int], right_keys: list[int],
    ) -> Iterator[DeviceBatch]:
        """The grace-hash join: this partition's probe rows are hash-routed
        to bucket files aligned with the build side's; each pass loads one
        bucket range of the build side, builds it with the ordinary kernels
        and streams that range's probe rows through the ordinary probe or
        expansion. Equal keys share a bucket, so the passes' outputs
        together are the one-shot join for INNER, LEFT, SEMI and ANTI (a
        preserved probe row lies in exactly one bucket)."""
        from ballista_tpu_torch.columnar.arrow_interop import table_from_arrow
        from ballista_tpu_torch.exec.shrink import maybe_shrink
        from ballista_tpu_torch.exec.spill import spill_batch_by_keys, tables_string_dicts

        sset, k = grace
        kind = self._KIND[self.join_type]
        pset = ctx.spill_manager().new_set(
            f"join-probe-{id(self):x}-{partition}", self._GRACE_BUCKETS
        )
        spilled = 0
        with self.metrics.time("spill_time"):
            for b in self.left.execute(partition, ctx):
                spilled += spill_batch_by_keys(pset, b, tuple(left_keys))
        pset.finish_writes()
        self.metrics.add("spill_bytes", spilled)
        batch_rows = ctx.config.tpu_batch_rows()
        group = self._GRACE_BUCKETS // k
        site = self.display() + "|grace"
        for pass_i in range(k):
            buckets = range(pass_i * group, (pass_i + 1) * group)
            ptabs = [t for bk in buckets if (t := pset.read(bk)) is not None and t.num_rows]
            if not ptabs:
                continue  # no probe rows: nothing to emit for any kind
            # one union dictionary for the pass, so every probe chunk shares
            # codes (per-chunk dictionaries would rebuild the build side at
            # every chunk's unification)
            pass_dicts = tables_string_dicts(ptabs)

            def probe_batches(ptabs=ptabs, pass_dicts=pass_dicts):
                # one batch_rows chunk at a time: K bounds the build side's
                # residency, not the probe side's; narrowing off on both
                # sides, so their key columns share one width
                for t in ptabs:
                    for off in range(0, t.num_rows, batch_rows):
                        yield from table_from_arrow(
                            t.slice(off, batch_rows), batch_rows, frozenset(),
                            device=ctx.device, fixed_dicts=pass_dicts,
                        )

            btabs = [t for bk in buckets if (t := sset.read(bk)) is not None and t.num_rows]
            if not btabs:
                # an empty build range: INNER and SEMI emit nothing, ANTI
                # keeps every probe row, LEFT nulls the build side
                if kind in (JoinSide.INNER, JoinSide.SEMI):
                    continue
                for pb in probe_batches():
                    yield pb if kind == JoinSide.ANTI else self._null_extend(pb)
                continue
            with self.metrics.time("build_time"):
                parts: list[DeviceBatch] = []
                for t in btabs:
                    parts.extend(table_from_arrow(t, 1 << 62, frozenset(), device=ctx.device))
                bb = concat_batches(parts)
                bt = build_side(bb, right_keys)
            for pb in probe_batches():
                bb2, pb2 = self._unify_key_dicts(bb, pb, right_keys, left_keys)
                if bb2 is not bb:
                    with self.metrics.time("build_time"):
                        bt = build_side(bb2, right_keys)
                    bb = bb2
                out = self._probe_or_expand(bt, pb2, left_keys, kind, ctx, None, partition)
                if kind in (JoinSide.INNER, JoinSide.LEFT):
                    out = self._restore_column_order(out, pb2, build_is_right=True)
                self.metrics.add("output_batches")
                yield maybe_shrink(out, ctx, site, partition)
        pset.close()

    def _null_extend(self, pb: DeviceBatch) -> DeviceBatch:
        """LEFT-join rows of an empty build range: the probe columns as they
        are, every build column null."""
        cols, nulls = list(pb.columns), list(pb.nulls)
        dicts = dict(pb.dictionaries)
        for f in self.right.schema():
            cols.append(torch.zeros(pb.capacity, dtype=f.dtype.to_torch(), device=pb.device))
            nulls.append(torch.ones(pb.capacity, dtype=torch.bool, device=pb.device))
            if f.dtype == DataType.STRING:
                dicts[f.name] = Dictionary(())
        return DeviceBatch(
            schema=self._schema, columns=tuple(cols), valid=pb.valid,
            nulls=tuple(nulls), dictionaries=dicts,
        )

    def _probe_loop(
        self, partition: int, ctx: TaskContext,
        collect_build: Callable[[], DeviceBatch],
        left_keys: list[int], right_keys: list[int], kind: JoinSide,
    ) -> Iterator[DeviceBatch]:
        """Probe each left batch against the collected right side: unify
        key dictionaries per batch (rebuilding only when that changed the
        build side), then probe or expand and relabel to the plan schema.
        The built table is kept across runs (a SEMI build may be a whole
        subquery). A selective join (q18's SEMI against a small HAVING set)
        leaves a near-empty batch at the probe's capacity: it is shrunk."""
        from ballista_tpu_torch.exec.shrink import maybe_shrink

        slot = ("bt_probe", partition if self.partition_mode == "partitioned" else None)
        build_batch, bt = self._build_cache.get(slot, (None, None))
        fp = self._strategy_key(self.right, right_keys, partition)
        site = None
        for b in self.left.execute(partition, ctx):
            if build_batch is None:
                with self.metrics.time("build_time"):
                    build_batch = collect_build()
            bb, pb = self._unify_key_dicts(build_batch, b, right_keys, left_keys)
            if bt is None or bb is not build_batch:
                with self.metrics.time("build_time"):
                    bt = build_side(bb, right_keys)
                build_batch = bb
                self._build_cache_put(ctx, slot, build_batch, bt, right_keys)
            out = self._probe_or_expand(bt, pb, left_keys, kind, ctx, fp, partition)
            if kind in (JoinSide.INNER, JoinSide.LEFT):
                out = self._restore_column_order(out, pb, build_is_right=True)
            self.metrics.add("output_batches")
            if site is None:
                site = self.display()
            yield maybe_shrink(out, ctx, site, partition)

    def _learned_flip(self, ctx: TaskContext, left_keys: list[int], right_keys: list[int]):
        """(left strategy key, left flags) when the plan cache has learned
        that the right side cannot serve as a unique build (duplicates or a
        collision overflow) and the left side can, with integer keys (no
        dictionary unification, so the collected right side would only
        decide); else None. Consulted before the budget check, which would
        collect or spill the whole right subtree."""
        cache = ctx.plan_cache
        if cache is None:
            return None
        ls, rs = self.left.schema(), self.right.schema()
        if any(ls.fields[i].dtype == DataType.STRING for i in left_keys) or any(
            rs.fields[i].dtype == DataType.STRING for i in right_keys
        ):
            return None
        rflags = cache.get(self._strategy_key(self.right, right_keys))
        if rflags is None or not (rflags[0] or rflags[1]):
            return None
        lfp = self._strategy_key(self.left, left_keys)
        lflags = cache.get(lfp)
        if lflags is None or lflags[0] or lflags[1]:
            return None
        return lfp, lflags

    def _execute_learned_flip(
        self, partition: int, ctx: TaskContext, left_keys: list[int], right_keys: list[int],
        learned: tuple,
    ) -> Iterator[DeviceBatch]:
        """The learned flip: build the unique left side (or take it from the
        cache) and stream the right side through it, partition by
        partition, from probe partition 0. The left side's uniqueness is
        validated at the task boundary (stale: the retry drops the entry
        and takes the general path); the right side's duplicates need no
        check, since a unique build serves any probe side."""
        from ballista_tpu_torch.exec.shrink import maybe_shrink

        lfp, lflags = learned
        if partition != 0:
            return
        cached = self._build_cache.get(("bt_flip",))
        if cached is not None:
            lbt = cached[1]
        else:
            with self.metrics.time("build_time"):
                left_batch = _collect(self.left, ctx)
                lbt = build_side(left_batch, left_keys)
            self._build_cache_put(ctx, ("bt_flip",), left_batch, lbt, left_keys)
        ctx.defer_speculation(
            lbt.spec_flag(),
            "cached join build strategy went stale (flip side no longer unique)",
            [lfp, ("join_lut", lfp)],
        )
        contig = self._contig_probe(lbt, lflags, True, ctx, lfp)
        site = self.display()
        for p in range(self.right.output_partitioning().n):
            for b in self.right.execute(p, ctx):
                if not contig:
                    # offered batch by batch: the cold path offers the
                    # collected side's capacity, which the stream never has
                    self._maybe_attach_lut(lbt, b.capacity, ctx, lfp)
                joined = self._probe(lbt, b, right_keys, JoinSide.INNER, contig)
                self.metrics.add("output_batches")
                out = self._restore_column_order(joined, b, build_is_right=False)
                yield maybe_shrink(out, ctx, site, 0)

    def _execute_inner(
        self, partition: int, ctx: TaskContext, left_keys: list[int], right_keys: list[int],
        learned: tuple | None = None,
    ) -> Iterator[DeviceBatch]:
        """INNER: build the right side. If it has duplicate keys, flip to a
        unique left side (fixed-capacity probe, no expansion); if both sides
        have duplicates, run the m:n expansion. ``learned`` is execute()'s
        ``_learned_flip``: the flip without collecting the right side."""
        if learned is not None:
            yield from self._execute_learned_flip(partition, ctx, left_keys, right_keys, learned)
            return
        ls, rs = self.left.schema(), self.right.schema()
        cached_r = self._build_cache.get(("bt_right",))
        if cached_r is not None:
            right_batch = cached_r[0]
        else:
            with self.metrics.time("build_time"):
                right_batch = self._collect_right(ctx)
        iter_left = iter(self.left.execute(partition, ctx))
        first = next(iter_left, None)
        if first is None:
            return

        # The strategy comes from the right side before dictionary
        # unification, so every partition takes the same branch. Its flags
        # come from the plan cache (no sync; validated by deferred flags),
        # this run's memo, or a build read by the host.
        cache = ctx.plan_cache
        fp = self._strategy_key(self.right, right_keys)
        decide: BuildTable | None = None
        flags, from_cache = None, False
        if cache is not None:
            # the cache is authoritative when present: a speculation miss
            # invalidates it, so the per-run memo must not replay it
            got = cache.get(fp)
            if got is not None:
                flags, from_cache = got, True
        elif self._decide_flags is not None:
            flags, from_cache = self._decide_flags, self._decide_from_cache
        if flags is None:
            with self.metrics.time("build_time"):
                decide = build_side(right_batch, right_keys)
            flags = decide.flags()
            if cache is not None:
                cache[fp] = flags
        self._decide_flags, self._decide_from_cache = flags, from_cache
        bt_dups, bt_ovf = flags[0], flags[1]
        if bt_dups or bt_ovf:
            # The right side cannot serve as a unique build. All output
            # comes from partition 0, the same on every partition.
            if partition != 0:
                return
            with self.metrics.time("build_time"):
                left_batch = _collect(self.left, ctx)
            lb, rb = self._unify_key_dicts(left_batch, right_batch, left_keys, right_keys)
            with self.metrics.time("build_time"):
                lbt = build_side(lb, left_keys)
            lfp = self._strategy_key(self.left, left_keys)
            lflags = cache.get(lfp) if cache is not None else None
            l_from_cache = lflags is not None
            if lflags is None:
                lflags = lbt.flags()
                if cache is not None:
                    cache[lfp] = lflags
            if not lflags[0] and not lflags[1]:
                # flip: build the unique left side, probe with the right
                if l_from_cache:
                    ctx.defer_speculation(
                        lbt.spec_flag(),
                        "cached join build strategy went stale (flip side no "
                        "longer unique)",
                        [lfp, ("join_lut", lfp)],
                    )
                contig = self._contig_probe(lbt, lflags, l_from_cache, ctx, lfp)
                if not contig:
                    self._maybe_attach_lut(lbt, rb.capacity, ctx, lfp)
                key_strings = any(
                    ls.fields[i].dtype == DataType.STRING for i in left_keys
                ) or any(rs.fields[i].dtype == DataType.STRING for i in right_keys)
                if key_strings:
                    # string keys were unified against the collected right:
                    # probe it in one piece
                    joined = self._probe(lbt, rb, right_keys, JoinSide.INNER, contig)
                    self.metrics.add("output_batches")
                    yield self._restore_column_order(joined, rb, build_is_right=False)
                    return
                # int keys: stream the right side batch by batch (probing
                # the collected fact side whole would allocate every gather
                # at its full capacity); the collected copy only decided
                from ballista_tpu_torch.exec.shrink import maybe_shrink

                right_batch = rb = lb = decide = None
                site = self.display()
                for p in range(self.right.output_partitioning().n):
                    for b in self.right.execute(p, ctx):
                        joined = self._probe(lbt, b, right_keys, JoinSide.INNER, contig)
                        self.metrics.add("output_batches")
                        out = self._restore_column_order(joined, b, build_is_right=False)
                        yield maybe_shrink(out, ctx, site, 0)
                return
            # both sides duplicated: m:n expansion, building a side whose
            # runs can be counted (no collision overflow)
            if bt_ovf and not lflags[1]:
                if l_from_cache:
                    ctx.defer_speculation(
                        lbt.run_overflow,
                        "cached join build strategy went stale (collision "
                        "overflow appeared)",
                        [lfp, ("join_lut", lfp)],
                    )
                self._maybe_attach_lut(lbt, rb.capacity, ctx, lfp)
                joined = self._expand(lbt, rb, right_keys, JoinSide.INNER, ctx, lfp, partition)
                out = self._restore_column_order(joined, rb, build_is_right=False)
            else:
                with self.metrics.time("build_time"):
                    rbt = build_side(rb, right_keys)
                if from_cache:
                    ctx.defer_speculation(
                        rbt.run_overflow,
                        "cached join build strategy went stale (collision "
                        "overflow appeared)",
                        [fp, ("join_lut", fp)],
                    )
                else:
                    ctx.defer_check(
                        rbt.run_overflow,
                        "join build side has a packed-hash collision run "
                        "longer than the probe window; use an integer join "
                        "key or reduce build size",
                    )
                self._maybe_attach_lut(rbt, lb.capacity, ctx, fp)
                joined = self._expand(rbt, lb, left_keys, JoinSide.INNER, ctx, fp, partition)
                out = self._restore_column_order(joined, lb, build_is_right=True)
            self.metrics.add("output_batches")
            yield out
            return

        def validate(bt: BuildTable) -> None:
            # a stale cached decision retries; a contradiction within the
            # run (dictionary unification made duplicates) fails loudly
            if from_cache:
                ctx.defer_speculation(
                    bt.spec_flag(),
                    "cached join build strategy went stale (build side no "
                    "longer unique)",
                    [fp, ("join_lut", fp)],
                )
            else:
                ctx.defer_check(
                    bt.spec_flag(),
                    "join build side has duplicate keys or a packed-hash "
                    "collision run after dictionary unification; use integer "
                    "join keys",
                )

        bb, _ = self._unify_key_dicts(right_batch, first, right_keys, left_keys)
        if bb is right_batch and cached_r is not None:
            bt = cached_r[1]  # built by an earlier run: no collect, no sort
            validate(bt)
        elif bb is right_batch and decide is not None:
            bt = decide  # unification changed nothing: reuse the decision build
            self._build_cache_put(ctx, ("bt_right",), right_batch, bt, right_keys)
        else:
            with self.metrics.time("build_time"):
                bt = build_side(bb, right_keys)
            validate(bt)
            if bb is right_batch:
                self._build_cache_put(ctx, ("bt_right",), right_batch, bt, right_keys)
        base = bb
        # the contiguous probe holds only while bt is the build the flags
        # describe: unification remaps codes, which can open holes
        contig = (
            self._contig_probe(bt, flags, from_cache, ctx, fp)
            if bb is right_batch else False
        )
        for b in itertools.chain([first], iter_left):
            bb2, pb = self._unify_key_dicts(base, b, right_keys, left_keys)
            if bb2 is not base:
                with self.metrics.time("build_time"):
                    bt = build_side(bb2, right_keys)
                validate(bt)
                contig = False
                base = bb2
            if not contig:
                self._maybe_attach_lut(bt, pb.capacity, ctx, fp)
            joined = self._probe(bt, pb, left_keys, JoinSide.INNER, contig)
            self.metrics.add("output_batches")
            yield self._restore_column_order(joined, pb, build_is_right=True)

    def _maybe_attach_lut(self, bt: BuildTable, probe_cap: int, ctx: TaskContext, fp) -> None:
        """Attach a direct-address probe table when the build has an exact
        int key over a bounded domain and the probe is big. The domain comes
        from the build's flags (cold) or the plan cache (warm, validated by
        a deferred flag, so an outgrown domain retries instead of dropping
        matches)."""
        if bt.lut2 is not None or bt.mode != "exact" or probe_cap < self._LUT_MIN_PROBE:
            return
        cache, key = ctx.plan_cache, ("join_lut", fp)
        if fp is None or any(
            bt.batch.schema.fields[i].dtype == DataType.STRING for i in bt.key_idxs
        ):
            # a grace pass (no strategy key: each pass builds other rows), or
            # dictionary-coded key domains, which grow as probes unify new
            # strings in: a cached domain would go stale every run, so these
            # take the build's own flags each time
            cache = None
        cached = cache.get(key) if cache is not None else None
        if cached == 0:  # learned: contiguous, or the domain is too wide
            return
        if cached is not None:
            attach_lut(bt, cached)
            ctx.defer_speculation(
                lut_stale(bt, cached),
                "cached join probe-table domain went stale (keys outgrew it)",
                [key],
            )
            return
        _, _, contig, lo, hi = bt.flags()
        domain = hi - lo + 1
        if contig or domain <= 0 or domain > LUT_MAX_DOMAIN:
            if cache is not None:
                cache[key] = 0
            return
        size = round_capacity(domain)
        attach_lut(bt, size)
        if cache is not None:
            cache[key] = size

    def _strategy_key(
        self, side_plan: ExecutionPlan, keys: list[int], partition: int | None = None
    ) -> tuple:
        """Plan-cache key of a build side: its plan's display and key
        indexes, and in partitioned mode the bucket (each bucket's build
        rows differ). A speculation key only: staleness is caught by
        deferred validation flags."""
        bucket = partition if self.partition_mode == "partitioned" else None
        return ("join_flags", "", side_plan.display(), tuple(keys), bucket)

    def _probe_or_expand(
        self, bt: BuildTable, probe: DeviceBatch, probe_keys: list[int],
        kind: JoinSide, ctx: TaskContext, fp, partition: int,
    ) -> DeviceBatch:
        """Unique build: the fixed-capacity probe; duplicated build: the m:n
        expansion. With a plan cache the branch comes from cached flags,
        validated later, with no host sync. A grace pass (``fp`` None)
        takes its build's own flags."""
        cache = ctx.plan_cache if fp is not None else None
        cached = cache.get(fp) if cache is not None else None
        if cached is not None:
            if not cached[0]:
                ctx.defer_speculation(
                    bt.spec_flag(),
                    "cached join build strategy went stale (build side no "
                    "longer unique)",
                    [fp, ("join_lut", fp)],
                )
                contig = self._contig_probe(bt, cached, True, ctx, fp)
                if not contig:
                    self._maybe_attach_lut(bt, probe.capacity, ctx, fp)
                return self._probe(bt, probe, probe_keys, kind, contig)
            # the expansion also serves a unique build; only a collision
            # overflow invalidates it
            ctx.defer_speculation(
                bt.run_overflow,
                "cached join build strategy went stale (collision overflow "
                "appeared)",
                [fp, ("join_lut", fp)],
            )
            self._maybe_attach_lut(bt, probe.capacity, ctx, fp)
            return self._expand(bt, probe, probe_keys, kind, ctx, fp, partition)
        flags = bt.flags()
        dups, overflow = flags[0], flags[1]
        if cache is not None and not overflow:
            # an overflowing build is a hard error below; caching it would
            # only add a wasted speculative run to every later query
            cache[fp] = flags
        if overflow:
            bt.check_overflow()
        if not dups:
            contig = self._contig_probe(bt, flags, False, ctx, fp)
            if not contig:
                self._maybe_attach_lut(bt, probe.capacity, ctx, fp)
            return self._probe(bt, probe, probe_keys, kind, contig)
        self._maybe_attach_lut(bt, probe.capacity, ctx, fp)
        return self._expand(bt, probe, probe_keys, kind, ctx, fp, partition)

    def _expand(
        self, bt: BuildTable, probe: DeviceBatch, probe_keys: list[int],
        kind: JoinSide, ctx: TaskContext, fp, partition: int,
    ) -> DeviceBatch:
        """Expansion join: count the matches of each probe row, then
        materialize into ``join_expansion`` rows per probe row, or into the
        capacity an earlier retry grew for this join, build side and
        partition (its site key). A join that needs more fails its deferred
        check with the rows it needs, and the retry loop grows that site
        alone and runs again. SEMI and ANTI need only the match count."""
        with self.metrics.time("probe_time"):
            first, count, _ = probe_counts(bt, probe, probe_keys)
        if kind in (JoinSide.SEMI, JoinSide.ANTI) and self.filter is None:
            m = count > 0
            return probe.with_valid(probe.valid & (m if kind == JoinSide.SEMI else ~m))
        if kind == JoinSide.LEFT:  # unmatched live probe rows emit one row
            eff = torch.where(probe.valid, count.clamp(min=1), 0)
        else:  # INNER, or SEMI/ANTI with a residual filter: pairs only
            eff = count
        if self._plan_text is None:
            self._plan_text = self.display()
        site = ("expand_cap", self._plan_text, fp, kind.name, partition)
        out_cap = max(
            round_capacity(probe.capacity * ctx.config.join_expansion()),
            ctx.site_capacity.get(site, 0),
        )
        total = eff.sum()
        ctx.defer_check(
            total > out_cap,
            "join expansion exceeded its output capacity; raise "
            "ballista.tpu.join_expansion",
            required=total, site=site,
        )
        ekind = JoinSide.LEFT if kind == JoinSide.LEFT else JoinSide.INNER
        with self.metrics.time("probe_time"):
            out, i, k, real = expand_join(bt, probe, first, count, eff, out_cap, ekind)
            if self.filter is None:
                return out
            passes = self._passes(out) & real
            if kind == JoinSide.INNER:
                return out.with_valid(out.valid & passes)
            # whether any pair of each probe row passes: its pairs are the
            # output rows [end - eff, end), so a prefix count of the passing
            # rows answers without atomics (the unused tail of the output
            # all points at the last probe row)
            end = torch.cumsum(eff, 0).clamp(max=out_cap)
            before = torch.cat([
                torch.zeros(1, dtype=torch.int64, device=probe.device),
                torch.cumsum(passes.to(torch.int64), 0),
            ])
            ap = before[end] > before[(end - eff).clamp(min=0)]
            if kind == JoinSide.SEMI:
                return probe.with_valid(probe.valid & ap)
            if kind == JoinSide.ANTI:
                return probe.with_valid(probe.valid & ~ap)
            # LEFT: keep the passing pairs; a probe row with none keeps its
            # first row, the build side nulled (q13's LEFT JOIN ... ON key
            # AND residual)
            null_row = (k == 0) & ~ap[i] & out.valid
            return self._null_build_side(
                out, len(probe.schema), ~passes, out.valid & (passes | null_row)
            )

    def _passes(self, joined: DeviceBatch) -> torch.Tensor:
        """The residual filter over probe ++ build rows (NULL fails). Its
        compiled expression is shared across batches and plan instances
        by the filter, the joined schema (either side may probe) and the
        device (``compilecache.tracecache``); the filter's key, a walk of
        its tree, is taken once per operator."""
        if self._filter_key is None:
            self._filter_key = ("join_filter", expr_key(self.filter))
        key = self._filter_key + (schema_key(joined.schema), str(joined.device))
        filt, schema = self.filter, joined.schema
        phys = shared_callable(key, lambda: compile_expr(filt, schema).evaluate)
        cv = phys(joined)
        passes = cv.values.to(torch.bool)
        return passes if cv.nulls is None else passes & ~cv.nulls

    @staticmethod
    def _null_build_side(
        joined: DeviceBatch, n_probe: int, miss: torch.Tensor, valid: torch.Tensor
    ) -> DeviceBatch:
        nulls = list(joined.nulls)
        for c in range(n_probe, len(joined.schema)):
            nulls[c] = miss if nulls[c] is None else (nulls[c] | miss)
        return DeviceBatch(
            schema=joined.schema, columns=joined.columns, valid=valid,
            nulls=tuple(nulls), dictionaries=dict(joined.dictionaries),
        )

    def _contig_probe(self, bt: BuildTable, flags: tuple, from_cache: bool, ctx: TaskContext, fp) -> bool:
        """Whether to take the contiguous-key probe. Fresh flags are
        authoritative for this build; cached ones get a deferred validation
        against the build's device flag."""
        contig = bool(flags[2])
        if contig and from_cache:
            ctx.defer_speculation(
                ~bt.contiguous,
                "cached contiguous-build-key speculation went stale",
                [fp, ("join_lut", fp)],
            )
        return contig

    def _probe(
        self, bt: BuildTable, probe: DeviceBatch, probe_keys: list[int],
        kind: JoinSide, contiguous: bool,
    ) -> DeviceBatch:
        """The fixed-capacity probe of a unique build, with the residual
        filter applied to the match semantics of ``kind``."""
        with self.metrics.time("probe_time"):
            if self.filter is None:
                return probe_side(bt, probe, probe_keys, kind, contiguous=contiguous)
            # join LEFT-like first so the filter sees both sides
            joined = probe_side(bt, probe, probe_keys, JoinSide.LEFT, contiguous=contiguous)
            matched = probe_side(bt, probe, probe_keys, JoinSide.INNER, contiguous=contiguous).valid
            full_match = matched & self._passes(joined)
            if kind == JoinSide.SEMI:
                return probe.with_valid(probe.valid & full_match)
            if kind == JoinSide.ANTI:
                return probe.with_valid(probe.valid & ~full_match)
            if kind == JoinSide.INNER:
                return joined.with_valid(full_match)
            # LEFT: every probe row stays; no full match nulls the build side
            return self._null_build_side(joined, len(probe.schema), ~full_match, probe.valid)

    def _restore_column_order(
        self, joined: DeviceBatch, probe: DeviceBatch, build_is_right: bool
    ) -> DeviceBatch:
        """The kernels emit probe ++ build; the plan schema is left ++
        right."""
        cols, nulls = joined.columns, joined.nulls
        if not build_is_right:
            n_probe = len(probe.schema)
            cols = cols[n_probe:] + cols[:n_probe]
            nulls = nulls[n_probe:] + nulls[:n_probe]
        return DeviceBatch(
            schema=self._schema,
            columns=cols,
            valid=joined.valid,
            nulls=nulls,
            dictionaries=self._rename_dicts(joined),
        )

    @staticmethod
    def _rename_dicts(joined: DeviceBatch) -> dict:
        # dictionaries are keyed by name; reordering columns leaves them
        return dict(joined.dictionaries)


class UnionExec(ExecutionPlan):
    """UNION ALL: the inputs' partitions one after another, positionally;
    every batch takes the first input's column names (and its dictionaries
    follow the renamed columns)."""

    def __init__(self, inputs: list[ExecutionPlan]) -> None:
        super().__init__()
        self.inputs = list(inputs)
        self._schema = inputs[0].schema()

    def schema(self) -> Schema:
        return self._schema

    def children(self) -> list[ExecutionPlan]:
        return list(self.inputs)

    def output_partitioning(self):
        return UnknownPartitioning(sum(i.output_partitioning().n for i in self.inputs))

    def describe(self) -> str:
        return f"UnionExec: {len(self.inputs)} inputs"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        p = partition
        for child in self.inputs:
            n = child.output_partitioning().n
            if p < n:
                for b in child.execute(p, ctx):
                    if b.schema.names != self._schema.names:
                        b = DeviceBatch(
                            schema=self._schema,
                            columns=b.columns,
                            valid=b.valid,
                            nulls=b.nulls,
                            dictionaries={
                                self._schema.fields[b.schema.index_of(k)].name: v
                                for k, v in b.dictionaries.items()
                            },
                        )
                    yield b
                return
            p -= n
        raise ExecutionError(f"union partition {partition} out of range")


class EmptyExec(ExecutionPlan):
    """No rows, or one row of zeros (``SELECT`` of literals alone)."""

    def __init__(self, produce_one_row: bool, schema: Schema) -> None:
        super().__init__()
        self.produce_one_row = produce_one_row
        self._schema = schema

    def schema(self) -> Schema:
        return self._schema

    def describe(self) -> str:
        return f"EmptyExec: rows={1 if self.produce_one_row else 0}"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        import numpy as np

        if not self.produce_one_row:
            yield DeviceBatch.empty(self._schema, device=ctx.device)
            return
        arrays = [np.zeros(1, f.dtype.to_np()) for f in self._schema]
        yield DeviceBatch.from_host(self._schema, arrays, num_rows=1, device=ctx.device)


class CrossJoinExec(ExecutionPlan):
    """Cross join with a one-row right side (what the optimizer leaves of an
    uncorrelated scalar subquery, q11 and q22): the row's columns are
    broadcast onto every row of the left side. Any other row count fails
    the run at the task boundary (general cross joins are not supported on
    the device)."""

    def __init__(self, left: ExecutionPlan, right: ExecutionPlan) -> None:
        super().__init__()
        self.left = left
        self.right = right
        self._schema = left.schema().join(right.schema())

    def schema(self) -> Schema:
        return self._schema

    def children(self) -> list[ExecutionPlan]:
        return [self.left, self.right]

    def output_partitioning(self):
        return self.left.output_partitioning()

    def describe(self) -> str:
        return "CrossJoinExec(broadcast-1-row)"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        one = compact(_collect(self.right, ctx))
        # checked with the run's other deferred flags: no host sync here
        ctx.defer_check(
            one.count_valid() != 1,
            "CrossJoinExec supports a 1-row broadcast side; general cross "
            "joins are not supported on device",
        )
        r_schema = self.right.schema()
        for b in self.left.execute(partition, ctx):
            cols, nulls = list(b.columns), list(b.nulls)
            dicts = dict(b.dictionaries)
            for i, f in enumerate(r_schema):
                # materialized: an expanded view has stride 0, which neither
                # a kernel's raw pointer nor an in-place op may see
                cols.append(one.columns[i][:1].expand(b.capacity).contiguous())
                m = one.nulls[i]
                nulls.append(None if m is None else m[:1].expand(b.capacity).contiguous())
                d = one.dictionaries.get(f.name)
                if d is not None:
                    dicts[f.name] = d
            yield DeviceBatch(
                schema=self._schema,
                columns=tuple(cols),
                valid=b.valid,
                nulls=tuple(nulls),
                dictionaries=dicts,
            )
