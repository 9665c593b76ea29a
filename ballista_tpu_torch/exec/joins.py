"""Hash-join operator, collect mode (port of ``HashJoinExec`` in
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

Build strategies (duplicate and contiguity flags) and probe-table sizes
are learned into the plan cache: a warm run takes them without a host
sync and validates them with deferred speculation flags.

Not ported yet, each raising ``NotImplementedError`` where a plan needs it:
residual join filters and ``UnionExec``, ``CrossJoinExec``, ``EmptyExec``
(ROADMAP queue 1, item 6); partitioned mode and the grace build under a
device-memory budget (item 8). Also waiting, with no effect on results:
the cross-run build-table cache and the learned flip that skips collecting
the right side (item 6).
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterator

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch, round_capacity
from ballista_tpu_torch.columnar.dict_util import merge_many, remap_codes
from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.errors import ExecutionError, PlanError
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext
from ballista_tpu_torch.expr import logical as L
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
        super().__init__()
        if partition_mode != "collect":
            raise NotImplementedError(
                "partitioned hash joins need hash repartition, not ported yet "
                "(ROADMAP queue 1, item 8)"
            )
        if filter is not None:
            raise NotImplementedError(
                "joins with a residual filter are not ported yet "
                "(ROADMAP queue 1, item 6)"
            )
        self.left = left
        self.right = right
        self.on = list(on)
        self.join_type = join_type
        self.filter = filter
        self.partition_mode = partition_mode
        # the right side's strategy flags are the same for every partition:
        # computed once per run without a plan cache
        self._decide_flags: tuple | None = None
        self._decide_from_cache = False
        self._plan_text: str | None = None  # display(), for capacity keys
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
        return f"HashJoinExec({self.join_type.value}, {self.partition_mode}): on=[{on}]"

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

    # -- execution ------------------------------------------------------------
    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        ls, rs = self.left.schema(), self.right.schema()
        left_keys = [L.resolve_field_index(ls, a.cname) for a, _ in self.on]
        right_keys = [L.resolve_field_index(rs, b.cname) for _, b in self.on]
        if self.join_type == JoinType.INNER:
            yield from self._execute_inner(partition, ctx, left_keys, right_keys)
            return
        # LEFT/SEMI/ANTI: the left side is preserved, so it probes
        yield from self._probe_loop(
            partition, ctx, lambda: _collect(self.right, ctx),
            left_keys, right_keys, self._KIND[self.join_type],
        )

    def _probe_loop(
        self, partition: int, ctx: TaskContext,
        collect_build: Callable[[], DeviceBatch],
        left_keys: list[int], right_keys: list[int], kind: JoinSide,
    ) -> Iterator[DeviceBatch]:
        """Probe each left batch against the collected right side: unify
        key dictionaries per batch (rebuilding only when that changed the
        build side), then probe or expand and relabel to the plan schema."""
        build_batch, bt = None, None
        fp = self._strategy_key(self.right, right_keys)
        for b in self.left.execute(partition, ctx):
            if build_batch is None:
                with self.metrics.time("build_time"):
                    build_batch = collect_build()
            bb, pb = self._unify_key_dicts(build_batch, b, right_keys, left_keys)
            if bt is None or bb is not build_batch:
                with self.metrics.time("build_time"):
                    bt = build_side(bb, right_keys)
                build_batch = bb
            out = self._probe_or_expand(bt, pb, left_keys, kind, ctx, fp, partition)
            if kind in (JoinSide.INNER, JoinSide.LEFT):
                out = self._restore_column_order(out, pb, build_is_right=True)
            self.metrics.add("output_batches")
            yield out

    def _execute_inner(
        self, partition: int, ctx: TaskContext, left_keys: list[int], right_keys: list[int]
    ) -> Iterator[DeviceBatch]:
        """INNER: build the right side. If it has duplicate keys, flip to a
        unique left side (fixed-capacity probe, no expansion); if both sides
        have duplicates, run the m:n expansion."""
        ls, rs = self.left.schema(), self.right.schema()
        with self.metrics.time("build_time"):
            right_batch = _collect(self.right, ctx)
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
                right_batch = rb = lb = decide = None
                for p in range(self.right.output_partitioning().n):
                    for b in self.right.execute(p, ctx):
                        joined = self._probe(lbt, b, right_keys, JoinSide.INNER, contig)
                        self.metrics.add("output_batches")
                        yield self._restore_column_order(joined, b, build_is_right=False)
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
        if bb is right_batch and decide is not None:
            bt = decide  # unification changed nothing: reuse the decision build
        else:
            with self.metrics.time("build_time"):
                bt = build_side(bb, right_keys)
            validate(bt)
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
        if any(bt.batch.schema.fields[i].dtype == DataType.STRING for i in bt.key_idxs):
            # dictionary-coded key domains grow as probes unify new strings
            # in: a cached domain would go stale every run, so these take
            # the build's own flags each time
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

    def _strategy_key(self, side_plan: ExecutionPlan, keys: list[int]) -> tuple:
        """Plan-cache key of a build side: its plan's display and key
        indexes. A speculation key only: staleness is caught by deferred
        validation flags."""
        return ("join_flags", "", side_plan.display(), tuple(keys), None)

    def _probe_or_expand(
        self, bt: BuildTable, probe: DeviceBatch, probe_keys: list[int],
        kind: JoinSide, ctx: TaskContext, fp, partition: int,
    ) -> DeviceBatch:
        """Unique build: the fixed-capacity probe; duplicated build: the m:n
        expansion. With a plan cache the branch comes from cached flags,
        validated later, with no host sync."""
        cache = ctx.plan_cache
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
        if kind in (JoinSide.SEMI, JoinSide.ANTI):
            m = count > 0
            return probe.with_valid(probe.valid & (m if kind == JoinSide.SEMI else ~m))
        if kind == JoinSide.LEFT:  # unmatched live probe rows emit one row
            eff = torch.where(probe.valid, count.clamp(min=1), 0)
        else:
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
        with self.metrics.time("probe_time"):
            out, _, _, _ = expand_join(bt, probe, first, count, eff, out_cap, kind)
        return out

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
        with self.metrics.time("probe_time"):
            return probe_side(bt, probe, probe_keys, kind, contiguous=contiguous)

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
