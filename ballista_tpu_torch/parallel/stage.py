"""Mesh stage programs: whole distributed stages over the shards of one
mesh (port of ``ballista_tpu/parallel/stage.py``).

The reference runs a repartitioned aggregate, a partitioned join, a
distributed sort or a partition-keyed window as ONE jitted ``shard_map``
per mesh: shard-local work, an ``all_to_all`` over ICI, shard-local work
again, with no host round-trip between the stages. Here every shard lies
on one device in the global layout (``parallel/mesh.py``): a step runs the
shard-local work on each block's view with the port's ops
(``ops/aggregate``, ``ops/join``, ``ops/sort``) and exchanges rows with
``parallel/collective`` (one permutation of the global layout). The step
functions (``aggregate_step``, ``topk_step``, ``sort_full_step``,
``window_step``, ``join_step``) are the device programs; eager torch
compiles nothing, so the reference's program cache has no counterpart.

Capacity discipline, the reference's: every capacity is fixed for a step;
bucket (sort, window), group (aggregate) and expansion (join) overflows
come back as per-shard flags, read
on the host after the step in ONE read (``_read``, the step's completion
barrier, as the reference's ``fetch_arrays``). Retryable overflows are
retried here with grown capacities (``MAX_MESH_RETRIES``): the runner
holds its inputs, so a retry re-runs the same step. A packed-hash
collision run past the probe window raises. ``retries`` counts the retries
of every runner.

The reference serialises its runner methods on a process-wide lock
because two ``shard_map`` programs from two threads could interleave their
``all_to_all`` rendezvous and deadlock. The port's exchange is a gather on
one device with no rendezvous, and a runner keeps no state between calls,
so there is no lock: two threads may run mesh stages on one runner at once
(``tests/test_torch_mesh_sql.py`` runs two mesh queries from two threads
on one context).

Join parity with the local kernels (``ops/join.py``): all three packing
modes (exact single-int key, exact2 two-int pack, hashed with
window-verified probes), m:n expansion for duplicate build keys, SEMI,
ANTI and LEFT, and INNER residual filters.
"""

from __future__ import annotations

import threading

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch, round_capacity
from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.errors import CapacityError, ExecutionError
from ballista_tpu_torch.ops.aggregate import AggOp, group_aggregate
from ballista_tpu_torch.ops.join import (
    JoinSide,
    _build_finish,
    _choose_pack_mode,
    _pack_key,
    expand_join,
    probe_counts,
)
from ballista_tpu_torch.ops.perm import multi_key_perm, take_batch
from ballista_tpu_torch.ops.search import searchsorted
from ballista_tpu_torch.ops.sort import SortKey, sort_perm
from ballista_tpu_torch.parallel.collective import exchange_by_key, exchange_by_pid
from ballista_tpu_torch.parallel.mesh import SHARD_AXIS, TorchMesh, check_layout

MAX_MESH_RETRIES = 6
SORT_SAMPLES = 64  # splitter samples a shard

# capacity retries of every runner (calls; task threads update it under the lock)
retries = 0
_count_lock = threading.Lock()


def _retried() -> None:
    global retries
    with _count_lock:
        retries += 1


def _read(flags: list[torch.Tensor]) -> list[list[int]]:  # devlint: disable=host-sync
    """A step's per-shard flags, all in one host read: by design the step's
    completion barrier and the retry decision (the reference's
    ``fetch_arrays``)."""
    return torch.stack([f.reshape(-1).to(torch.int64) for f in flags]).tolist()


def _sum_dtype_np(dtype: DataType) -> DataType:
    if dtype in (DataType.BOOL,) or dtype.is_integer:
        return DataType.INT64
    return DataType.FLOAT64


# -- per-shard views -----------------------------------------------------------


def _blocks(rows: int, n_dev: int) -> list[slice]:
    if rows % n_dev:
        raise ExecutionError(f"{rows} rows are not in the block layout of {n_dev} shards")
    cap = rows // n_dev
    return [slice(d * cap, (d + 1) * cap) for d in range(n_dev)]


def _at(ts, sl: slice) -> list:
    return [None if t is None else t[sl] for t in ts]


class _Blocks:
    """Per-shard outputs written into the global layout as each shard
    finishes, so a shard's own tensors are freed before the next shard runs
    (a concatenation at the end would hold every shard's outputs twice).
    A null mask that only some shards have is all false in the others."""

    def __init__(self, n_dev: int) -> None:
        self.n_dev = n_dev
        self.cols: list = []
        self.masks: list = []

    def put(self, d: int, cols, masks) -> None:
        if not self.cols:
            self.cols = [
                torch.empty(self.n_dev * c.shape[0], dtype=c.dtype, device=c.device) for c in cols
            ]
            self.masks = [None] * len(masks)
        for j, c in enumerate(cols):
            n = c.shape[0]
            self.cols[j][d * n:(d + 1) * n] = c
        for j, m in enumerate(masks):
            if m is not None:
                if self.masks[j] is None:
                    self.masks[j] = torch.zeros_like(self.cols[j], dtype=torch.bool)
                n = m.shape[0]
                self.masks[j][d * n:(d + 1) * n] = m

    def result(self) -> tuple[tuple, tuple]:
        return tuple(self.cols), tuple(self.masks)


def _shard(batch: DeviceBatch, sl: slice) -> DeviceBatch:
    return DeviceBatch(
        schema=batch.schema,
        columns=tuple(c[sl] for c in batch.columns),
        valid=batch.valid[sl],
        nulls=tuple(_at(batch.nulls, sl)),
        dictionaries=batch.dictionaries,
    )


# -- the steps (device programs) -----------------------------------------------


def aggregate_step(cols, nulls, valid, key_idxs, val_idxs, ops, n_dev: int, capacity: int):
    """Partial aggregate per shard -> exchange of the group states by key
    hash -> final merge per shard. Returns (cols, nulls, valid, group
    overflow, groups needed), the flags one a shard. A shard holds at most
    ``capacity`` states, so buckets of ``capacity`` slots never
    overflow."""
    n_keys = len(key_idxs)
    states, flags = _Blocks(n_dev), []
    for d, sl in enumerate(_blocks(valid.shape[0], n_dev)):
        p = group_aggregate(
            [cols[i][sl] for i in key_idxs], _at([nulls[i] for i in key_idxs], sl), valid[sl],
            [cols[i][sl] for i in val_idxs], _at([nulls[i] for i in val_idxs], sl),
            list(ops), capacity,
        )
        states.put(d, p.keys + p.values + [p.valid], p.key_nulls + p.value_nulls + [None])
        flags.append((p.overflow, p.n_groups.to(torch.int32)))
    st_cols, st_nulls = states.result()
    ex_cols, ex_nulls, ex_valid, _ = exchange_by_key(
        st_cols[:-1], st_nulls[:-1], st_cols[-1], tuple(range(n_keys)), SHARD_AXIS, n_dev, capacity,
    )
    del states, st_cols, st_nulls
    merge_ops = [op.merge_op for op in ops]
    out, grp_ovf, need = _Blocks(n_dev), [], []
    for d, sl in enumerate(_blocks(ex_valid.shape[0], n_dev)):
        f = group_aggregate(
            [c[sl] for c in ex_cols[:n_keys]], _at(ex_nulls[:n_keys], sl), ex_valid[sl],
            [c[sl] for c in ex_cols[n_keys:]], _at(ex_nulls[n_keys:], sl),
            merge_ops, capacity,
        )
        out.put(d, f.keys + f.values + [f.valid], f.key_nulls + f.value_nulls + [None])
        grp_ovf.append(flags[d][0] | f.overflow)
        need.append(torch.maximum(flags[d][1], f.n_groups.to(torch.int32)))
    out_cols, out_nulls = out.result()
    return out_cols[:-1], out_nulls[:-1], out_cols[-1], torch.stack(grp_ovf), torch.stack(need)


def topk_step(batch: DeviceBatch, keys: list[SortKey], k: int, n_dev: int) -> DeviceBatch:
    """Local sort and top-k on each shard, the candidates of every shard
    gathered (the reference's ``all_gather``), and the final merge of the
    ``k * N`` pool: one unsharded batch of ``min(k, pool)`` rows. Sorts
    with ``ops/sort.sort_perm``, so the order is SortExec's."""
    blocks = _blocks(batch.capacity, n_dev)
    shard_k = min(k, batch.capacity // n_dev)
    cand = _Blocks(n_dev)
    for d, sl in enumerate(blocks):
        shard = _shard(batch, sl)
        c, m, v = take_batch(
            list(shard.columns), list(shard.nulls), shard.valid, sort_perm(shard, keys)[:shard_k]
        )
        cand.put(d, c + [v], m + [None])
    cols, nulls = cand.result()
    pool = DeviceBatch(
        schema=batch.schema, columns=cols[:-1], valid=cols[-1], nulls=nulls[:-1],
        dictionaries=dict(batch.dictionaries),
    )
    fk = min(k, pool.capacity)
    c, m, v = take_batch(list(pool.columns), list(pool.nulls), pool.valid, sort_perm(pool, keys)[:fk])
    return DeviceBatch(
        schema=batch.schema, columns=tuple(c), valid=v, nulls=tuple(m),
        dictionaries=dict(batch.dictionaries),
    )


def _routing_key(cols, nulls, k0: SortKey) -> tuple[torch.Tensor, int | float]:
    """The primary sort key as a widened scalar whose ascending order is the
    key's sort order: DESC flips the sign, null rows pin to the end the
    key's null placement names, raw NaNs (not null-masked) sort last."""
    r = cols[k0.col]
    nm = nulls[k0.col]
    if r.dtype.is_floating_point:
        r = r.to(torch.float64)
        hi = float("inf")
        r = torch.where(torch.isnan(r), torch.full_like(r, hi), r)
    else:
        r = r.to(torch.int64)
        hi = torch.iinfo(torch.int64).max
    if not k0.ascending:
        r = -r
    if nm is not None:
        r = torch.where(nm, torch.full_like(r, -hi if k0.nulls_first else hi), r)
    return r, hi


def sort_full_step(batch: DeviceBatch, keys: list[SortKey], n_dev: int, bcap: int):
    """Sample split points on the primary key (``SORT_SAMPLES`` a shard),
    range exchange, local multi-key sort per shard: shard ``d`` holds the
    ``d``-th key range, sorted. Returns (cols, nulls, valid, overflow)."""
    per = batch.capacity // n_dev
    valid = batch.valid
    r, hi = _routing_key(batch.columns, batch.nulls, keys[0])
    # dead rows route nowhere and sort past every live key in the samples
    r_live = torch.where(valid, r, torch.full_like(r, hi))
    rs = torch.sort(r_live.view(n_dev, per), dim=1).values
    nlive = valid.view(n_dev, per).sum(dim=1)
    pos = (torch.arange(SORT_SAMPLES, device=r.device) * nlive[:, None]) // SORT_SAMPLES
    samp = rs.gather(1, pos.clamp(0, per - 1))
    samp = torch.where(nlive[:, None] > 0, samp, torch.full_like(samp, hi))
    gs = torch.sort(samp.reshape(-1)).values
    tot = SORT_SAMPLES * n_dev
    splitters = gs[(torch.arange(1, n_dev, device=r.device) * tot) // n_dev]
    pid = searchsorted(splitters, r_live, side="left").to(torch.int32)
    pid = torch.where(valid, pid, n_dev)
    ecols, enulls, evalid, ovf = exchange_by_pid(
        batch.columns, batch.nulls, valid, pid, n_dev, bcap
    )
    ex = DeviceBatch(
        schema=batch.schema, columns=ecols, valid=evalid, nulls=enulls,
        dictionaries=batch.dictionaries,
    )
    out = _Blocks(n_dev)
    for d, sl in enumerate(_blocks(ex.capacity, n_dev)):
        shard = _shard(ex, sl)
        c, m, v = take_batch(list(shard.columns), list(shard.nulls), shard.valid, sort_perm(shard, keys))
        out.put(d, c + [v], m + [None])
    cols, nulls = out.result()
    return cols[:-1], nulls[:-1], cols[-1], ovf


def window_step(batch: DeviceBatch, key_idxs, local_fn, n_dev: int, bcap: int):
    """Exchange rows by the PARTITION BY keys, so each window partition
    lands whole on one shard, then ``local_fn`` on each shard. Returns
    (cols, nulls, valid, overflow)."""
    ecols, enulls, evalid, ovf = exchange_by_key(
        batch.columns, batch.nulls, batch.valid, tuple(key_idxs), SHARD_AXIS, n_dev, bcap
    )
    out = _Blocks(n_dev)
    for d, sl in enumerate(_blocks(evalid.shape[0], n_dev)):
        out_cols, out_nulls = local_fn([c[sl] for c in ecols], _at(enulls, sl), evalid[sl])
        out.put(d, list(out_cols), list(out_nulls))
    cols, nulls = out.result()
    return cols, nulls, evalid, ovf


def join_step(
    left: DeviceBatch, right: DeviceBatch, left_keys, right_keys, join_type: JoinSide,
    n_dev: int, bucket_cap: int, mode: str, out_cap: int, filter_fn=None,
):
    """Both sides exchanged by join key, then a build of the right side and
    a probe by the left on each shard (``mode`` packs the keys; m:n
    expansion into ``out_cap`` rows a shard; ``filter_fn`` an INNER
    residual filter). ``bucket_cap`` is at least either side's per-shard
    capacity, so the exchange never overflows. Returns (cols, nulls,
    valid, run overflow, expansion overflow, output rows needed), the
    flags one a shard."""
    lc, ln, lv, _ = exchange_by_key(
        left.columns, left.nulls, left.valid, tuple(left_keys), SHARD_AXIS, n_dev, bucket_cap
    )
    rc, rn, rv, _ = exchange_by_key(
        right.columns, right.nulls, right.valid, tuple(right_keys), SHARD_AXIS, n_dev, bucket_cap
    )
    semi_anti = join_type in (JoinSide.SEMI, JoinSide.ANTI)
    out_blocks, run_ovf, exp_ovf, totals = _Blocks(n_dev), [], [], []
    for d, sl in enumerate(_blocks(lv.shape[0], n_dev)):
        rcols, rnulls, rvalid = [c[sl] for c in rc], _at(rn, sl), rv[sl]
        dead = ~rvalid
        for i in right_keys:
            if rnulls[i] is not None:
                dead = dead | rnulls[i]
        packed = _pack_key([rcols[i] for i in right_keys], mode)
        passes = [(dead, False), (packed, False)]
        if mode == "hash":
            # tie-break on the actual keys: duplicate keys land adjacent
            passes.extend((rcols[i], False) for i in right_keys)
        rbatch = DeviceBatch(
            schema=right.schema, columns=tuple(rcols), valid=rvalid, nulls=tuple(rnulls),
            dictionaries=right.dictionaries,
        )
        bt = _build_finish(multi_key_perm(passes), dead, packed, rbatch, list(right_keys), mode)
        lbatch = DeviceBatch(
            schema=left.schema, columns=tuple(c[sl] for c in lc), valid=lv[sl],
            nulls=tuple(_at(ln, sl)), dictionaries=left.dictionaries,
        )
        first, count, _ = probe_counts(bt, lbatch, list(left_keys))
        run_ovf.append(bt.run_overflow)
        if semi_anti:
            m = count > 0
            keep = m if join_type == JoinSide.SEMI else ~m
            out_blocks.put(d, [lbatch.valid & keep], [None])
            exp_ovf.append(torch.zeros((), dtype=torch.bool, device=lv.device))
            totals.append(torch.zeros((), dtype=torch.int64, device=lv.device))
            continue
        if join_type == JoinSide.LEFT:
            eff = torch.where(lbatch.valid, torch.clamp(count, min=1), 0)
            ekind = JoinSide.LEFT
        else:
            eff = count
            ekind = JoinSide.INNER
        total = eff.sum()
        totals.append(total)
        exp_ovf.append(total > out_cap)
        out, _, _, real = expand_join(bt, lbatch, first, count, eff, out_cap, ekind)
        if filter_fn is not None:
            out = out.with_valid(out.valid & filter_fn(out) & real)
        out_blocks.put(d, list(out.columns) + [out.valid], list(out.nulls) + [None])
        del out, bt, rbatch, lbatch
    cols, nulls = out_blocks.result()
    if semi_anti:  # the exchanged left rows themselves, with a new valid mask
        cols, nulls = tuple(lc) + cols, tuple(ln) + nulls
    return (
        cols[:-1], nulls[:-1], cols[-1],
        torch.stack(run_ovf), torch.stack(exp_ovf), torch.stack(totals),
    )


class MeshStageRunner:
    """Runs mesh-wide stages over a mesh's shards.

    Inputs are batches in the mesh's block layout (``parallel.mesh.
    shard_batch``); outputs keep it (``shards`` set): each shard holds the
    rows whose hash (or key range) routes to it, the invariant a
    downstream mesh stage needs. The top-k is the exception: its answer is
    one unsharded batch, as the reference's is replicated."""

    def __init__(self, mesh: TorchMesh) -> None:
        self.mesh = mesh
        self.n_dev = int(mesh.n_dev)

    def _sharded(self, schema, cols, nulls, valid, dicts) -> DeviceBatch:
        return DeviceBatch(
            schema=schema, columns=tuple(cols), valid=valid, nulls=tuple(nulls),
            dictionaries=dicts, shards=self.n_dev,
        )

    # -- repartitioned aggregate ---------------------------------------------
    def aggregate(
        self,
        batch: DeviceBatch,
        key_idxs: list[int],
        val_idxs: list[int],
        ops: list[AggOp],
        capacity: int,
    ) -> DeviceBatch:
        """Partial aggregate per shard -> exchange of group states by key
        hash -> final merge per shard. Output: (keys ++ aggregated values),
        each group on exactly one shard.

        A group-capacity overflow is retried with the exact required
        capacity (the aggregate counts the true groups even on overflow)."""
        check_layout(batch, self.n_dev)
        for attempt in range(MAX_MESH_RETRIES):
            out_cols, out_nulls, out_valid, grp_ovf, need = aggregate_step(
                batch.columns, batch.nulls, batch.valid, tuple(key_idxs), tuple(val_idxs),
                tuple(ops), self.n_dev, capacity,
            )
            grp_ovf, need = _read([grp_ovf, need])
            if not any(grp_ovf):
                break
            required = max(need)
            new_cap = round_capacity(required + 1)
            if new_cap <= capacity:
                new_cap = capacity * 2
            if attempt == MAX_MESH_RETRIES - 1:
                raise CapacityError(
                    "mesh aggregate exceeded group capacity after retries",
                    required=required,
                )
            _retried()
            capacity = new_cap
        in_schema = batch.schema
        fields = [in_schema.fields[i] for i in key_idxs]
        dicts = {
            k: v
            for k, v in batch.dictionaries.items()
            if any(in_schema.fields[i].name == k for i in key_idxs)
        }
        for i, op in zip(val_idxs, ops):
            f = in_schema.fields[i]
            if op == AggOp.COUNT:
                fields.append(Field(f"{f.name}#count", DataType.INT64, False))
            elif op == AggOp.SUM:
                fields.append(Field(f"{f.name}#sum", _sum_dtype_np(f.dtype), True))
            else:
                out_name = f"{f.name}#{op.value}"
                fields.append(Field(out_name, f.dtype, True))
                if f.dtype == DataType.STRING:
                    # MIN/MAX over a dictionary-coded column: the codes ride
                    # through; the dictionary follows under the renamed field
                    d = batch.dictionaries.get(f.name)
                    if d is not None:
                        dicts[out_name] = d
        return self._sharded(Schema(fields), out_cols, out_nulls, out_valid, dicts)

    # -- distributed top-k -----------------------------------------------------
    def topk(self, batch: DeviceBatch, keys, k: int) -> DeviceBatch:
        """ORDER BY ... LIMIT k: local sort and top-k on each shard, the
        ``k * N`` candidates gathered, and their final merge sort. The
        shard-local top-k bounds the gather to ``k * N`` rows whatever the
        input size (SortExec's fetch-sliced permutation on the mesh)."""
        check_layout(batch, self.n_dev)
        return topk_step(batch, list(keys), k, self.n_dev)

    # -- full sort (sample sort / range exchange) -----------------------------
    def sort_full(self, batch: DeviceBatch, keys) -> DeviceBatch:
        """Total ORDER BY (no LIMIT): sampled split points on the primary
        key -> range exchange -> local multi-key sort per shard. Shard ``d``
        holds the ``d``-th key range, sorted, so the batch read in index
        order IS the total order (ties on the primary key route to one
        shard and the other keys break them there). The reference
        serialises this shape through one sort task after a gather.

        Skew (few distinct primary keys) shows as bucket overflow and
        retries with a grown bucket capacity up to the skew-proof bound
        (the per-shard rows, where overflow is impossible)."""
        per = max(1, check_layout(batch, self.n_dev))
        keys = list(keys)
        bcap = round_capacity(max(1, (2 * per) // self.n_dev))
        for attempt in range(MAX_MESH_RETRIES):
            bcap = min(bcap, round_capacity(per))
            out_cols, out_nulls, out_valid, ovf = sort_full_step(batch, keys, self.n_dev, bcap)
            (ovf,) = _read([ovf])
            if not any(ovf):
                break
            if bcap >= per or attempt == MAX_MESH_RETRIES - 1:
                raise CapacityError(
                    "mesh sort bucket overflow after retries",
                    required=per * self.n_dev,
                )
            _retried()
            bcap = round_capacity(bcap * 2)  # stay on the bucket ladder
        return self._sharded(
            batch.schema, out_cols, out_nulls, out_valid, dict(batch.dictionaries)
        )

    # -- partition-keyed windows ----------------------------------------------
    def window(self, batch: DeviceBatch, key_idxs: list[int], local_fn):
        """Partition-keyed window functions over the mesh: rows exchanged by
        PARTITION BY key so each partition lands whole on one shard, then
        ``local_fn`` (the single-device window program) per shard. The
        reference's upstream has no distributed window path at all.

        ``local_fn(cols, nulls, valid) -> (out_cols, out_nulls)`` returns
        the INPUT columns plus the appended window columns. Returns (cols,
        nulls, valid)."""
        per = max(1, check_layout(batch, self.n_dev))
        bcap = round_capacity(max(1, (2 * per) // self.n_dev))
        for attempt in range(MAX_MESH_RETRIES):
            bcap = min(bcap, round_capacity(per))
            out_cols, out_nulls, out_valid, ovf = window_step(
                batch, tuple(key_idxs), local_fn, self.n_dev, bcap
            )
            (ovf,) = _read([ovf])
            if not any(ovf):
                break
            if bcap >= per or attempt == MAX_MESH_RETRIES - 1:
                raise CapacityError(
                    "mesh window bucket overflow after retries",
                    required=per * self.n_dev,
                )
            _retried()
            bcap *= 2
        return out_cols, out_nulls, out_valid

    # -- partitioned join -----------------------------------------------------
    def join(
        self,
        left: DeviceBatch,
        right: DeviceBatch,
        left_keys: list[int],
        right_keys: list[int],
        join_type: JoinSide = JoinSide.INNER,
        filter_fn=None,
    ) -> DeviceBatch:
        """PARTITIONED-mode join: both sides exchanged by join key, then
        build and probe on each shard.

        Key packing follows the local tier (``ops/join.py``): exact
        single-int, exact2 two-int, or hashed with window-verified probes.
        Duplicate build keys take the m:n expansion; the expansion output
        capacity grows on overflow and the step runs again. The bucket
        capacity is the larger side's per-shard capacity, so the exchange
        cannot overflow.

        ``filter_fn``: an optional residual filter ``f(joined_batch) ->
        bool[rows]`` applied per shard (INNER joins only: the caller
        enforces that)."""
        check_layout(left, self.n_dev)
        check_layout(right, self.n_dev)
        # string keys join by dictionary code: checked on every call
        for li, ri in zip(left_keys, right_keys):
            lf = left.schema.fields[li]
            rf = right.schema.fields[ri]
            if DataType.STRING in (lf.dtype, rf.dtype):
                ld = left.dictionaries.get(lf.name)
                rd = right.dictionaries.get(rf.name)
                if ld is None or rd is None or ld.values != rd.values:
                    raise ExecutionError(
                        f"mesh join key {lf.name!r}/{rf.name!r} requires a "
                        "shared dictionary; unify dictionaries before "
                        "sharding"
                    )
        # the pack mode is decided on the build (right) batch; the probe
        # packs with the same mode
        mode = _choose_pack_mode(right, list(right_keys))
        bcap = max(left.capacity // self.n_dev, right.capacity // self.n_dev, 1)
        # a shard's probe after the exchange has n_dev * bcap rows; a
        # unique build emits at most one row per probe row
        ocap = self.n_dev * bcap
        totals = [0]
        for _attempt in range(MAX_MESH_RETRIES):
            cols, nulls, valid, run_ovf, exp_ovf, totals_d = join_step(
                left, right, list(left_keys), list(right_keys), join_type,
                self.n_dev, bcap, mode, ocap, filter_fn,
            )
            run_ovf, exp_ovf, totals = _read([run_ovf, exp_ovf, totals_d])
            if any(run_ovf):
                raise ExecutionError(
                    "mesh join build side has a packed-hash collision run "
                    "longer than the probe window; use integer join keys "
                    "or reduce build size"
                )
            if any(exp_ovf):
                required = max(totals)
                ocap = round_capacity(max(required + 1, ocap * 2))
                _retried()
                continue
            break
        else:
            raise CapacityError(
                "mesh join exceeded static capacities after retries",
                required=max(totals),
            )
        if join_type in (JoinSide.SEMI, JoinSide.ANTI):
            out_schema = left.schema
        elif join_type == JoinSide.LEFT:
            out_schema = left.schema.join(
                Schema([Field(f.name, f.dtype, True) for f in right.schema])
            )
        else:
            out_schema = left.schema.join(right.schema)
        dicts = dict(left.dictionaries)
        if join_type not in (JoinSide.SEMI, JoinSide.ANTI):
            dicts.update(right.dictionaries)
        return self._sharded(out_schema, cols, nulls, valid, dicts)
