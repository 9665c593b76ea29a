"""Grace-hash host spill: Arrow IPC bucket files under a disk budget (port
of ``ballista_tpu/exec/spill.py``).

When an operator's resident working set (a join's build side, a final
aggregate's partial states) would exceed ``ballista.tpu.hbm_budget_mb``, it
hash-splits its rows into bucket files on the host and re-processes the
buckets pass by pass through the same kernels. This module owns the files:

- one :class:`SpillManager` per task attempt (made on the TaskContext at
  the first spill, closed at the attempt boundary by
  ``run_with_capacity_retry``), with every spill set in one directory of
  the attempt under a per-user temp root (or ``ballista.tpu.spill_dir``);
- the bytes written are held against ``ballista.tpu.spill_budget_mb``, so
  a runaway spill fails the task instead of filling the disk.

Rows route by the shuffle's rule (``ops/partition.py``): a string key
hashes by its value, NULL keys share a bucket. A spilled batch is grouped
by bucket on the card (``partition_groups``: the rows in a stable bucket
order and each bucket's start), gathered in that order column by column,
and copied into one pinned host buffer of the manager's, with one wait a
batch (``stats["waits"]``) that also brings back the bucket starts. One
Arrow batch is built from it, and each bucket file gets a zero-copy slice.
The bucket files hold what the reference's ``write_split`` writes (the same
rows in the same order), and each slice is charged the bytes of the
``take`` the reference makes (``take_nbytes``). On the CPU the same code
runs over ``partition_groups_plain``, without pinned memory. The shuffle
writer (``executor/shuffle.py``) writes its partition files through the
same grouped copy (``grouped_arrow``), with its own stats.

Left out of the port, as neither changes a result and the port has neither
module yet: the reference's resource-witness hooks (``analysis.reswitness``)
and its spill trace events (``obs.trace``); and the executor's TTL sweep of
orphaned attempt directories, which comes with the distributed tier.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
import uuid

import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc
import torch

from ballista_tpu_torch.columnar.arrow_interop import arrow_from_host
from ballista_tpu_torch.columnar.batch import DeviceBatch, Dictionary
from ballista_tpu_torch.errors import ExecutionError


def new_write_stats() -> dict:
    """What grouped writes cost, summed over the process (a run reads them
    after ``reset_stats``): grouped batches; waits on the card (one a batch
    there); device ms of the grouping and gathers and of the copy to the
    host (CUDA events, read after the wait); host seconds of queueing them,
    blocked in the wait, of the Arrow build (with the bytes charged) and of
    the IPC writes."""
    return dict(
        batches=0, waits=0, group_ms=0.0, copy_ms=0.0, queue_s=0.0, wait_s=0.0,
        arrow_s=0.0, ipc_s=0.0,
    )


# the spill's writes
stats = new_write_stats()


def reset_stats(which: dict | None = None) -> None:
    which = stats if which is None else which
    for k in which:
        which[k] = type(which[k])()

# Shared temp root of spills without a ballista.tpu.spill_dir; every
# attempt's directory is removed by SpillManager.close(). Per user (uid
# suffix), so that two users on one host never contend for it.
SPILL_TMP_ROOT = os.path.join(
    tempfile.gettempdir(),
    f"ballista_tpu_torch_spill-{getattr(os, 'getuid', lambda: 'u')()}",
)


def device_nbytes(batch: DeviceBatch) -> int:
    """Device bytes a batch pins: its padded columns, the valid mask and
    the null masks (what ``ballista.tpu.hbm_budget_mb`` budgets)."""
    n = sum(c.numel() * c.element_size() for c in batch.columns)
    n += batch.valid.numel() * batch.valid.element_size()
    n += sum(m.numel() * m.element_size() for m in batch.nulls if m is not None)
    return n


class SpillManager:
    """All spill files of one task attempt, under one directory."""

    def __init__(self, base_dir: str | None, budget_bytes: int) -> None:
        if base_dir is None:
            base_dir = SPILL_TMP_ROOT
        os.makedirs(base_dir, exist_ok=True)
        self.dir = os.path.join(base_dir, f"attempt-{uuid.uuid4().hex[:12]}")
        os.makedirs(self.dir, exist_ok=True)
        self.budget_bytes = budget_bytes
        self.total_bytes = 0
        self._sets: list[SpillSet] = []
        self.staging = HostStaging()

    def new_set(self, tag: str, buckets: int) -> "SpillSet":
        s = SpillSet(self, os.path.join(self.dir, tag), buckets)
        self._sets.append(s)
        return s

    def account(self, nbytes: int) -> None:
        self.total_bytes += nbytes
        if self.budget_bytes and self.total_bytes > self.budget_bytes:
            raise ExecutionError(
                "grace-hash spill exceeded ballista.tpu.spill_budget_mb "
                f"({self.total_bytes >> 20}MB written); raise the budget"
            )

    def close(self) -> None:
        for s in self._sets:
            s.close()
        self._sets.clear()
        self.staging.release()
        shutil.rmtree(self.dir, ignore_errors=True)


class SpillSet:
    """One grace pass's hash-bucket files: rows route to ``buckets`` Arrow
    IPC files by key hash; readers take whole buckets."""

    def __init__(self, manager: SpillManager, dir: str, buckets: int) -> None:
        self.manager = manager
        self.dir = dir
        self.buckets = buckets
        os.makedirs(dir, exist_ok=True)
        self._writers: dict[int, paipc.RecordBatchFileWriter] = {}
        self.bucket_bytes = [0] * buckets
        self.bucket_rows = [0] * buckets
        self._closed = False

    def _path(self, bucket: int) -> str:
        return os.path.join(self.dir, f"bucket-{bucket}.arrow")

    def write(self, bucket: int, rb: pa.RecordBatch, nbytes: int) -> None:
        """Append ``rb`` to a bucket file, charging ``nbytes`` to the bucket
        and the manager's budget."""
        if rb.num_rows == 0:
            return
        w = self._writers.get(bucket)
        if w is None:
            w = paipc.new_file(self._path(bucket), rb.schema)
            self._writers[bucket] = w
        w.write_batch(rb)
        self.bucket_rows[bucket] += rb.num_rows
        self.bucket_bytes[bucket] += nbytes
        self.manager.account(nbytes)

    def write_split(
        self, batch: DeviceBatch, order: torch.Tensor, offsets: torch.Tensor
    ) -> int:
        """Write a batch's live rows to the bucket files, grouped: ``order``
        lists the batch's rows bucket by bucket (stable, the invalid rows
        last) and ``offsets`` where each bucket starts, ``offsets[-2]`` the
        live rows (``ops/partition.partition_groups``). Returns the bytes
        written."""
        before = self.manager.total_bytes
        rb, starts, lens = grouped_arrow(self.manager.staging, batch, order, offsets, stats)
        if rb is not None:
            t = time.perf_counter()
            charged = take_nbytes(rb, starts, lens)
            t1 = time.perf_counter()
            for b in np.flatnonzero(lens):
                self.write(int(b), rb.slice(int(starts[b]), int(lens[b])), int(charged[b]))
            stats["arrow_s"] += t1 - t
            stats["ipc_s"] += time.perf_counter() - t1
        return self.manager.total_bytes - before

    def finish_writes(self) -> None:
        """Seal every bucket file (IPC footers) so reads can begin."""
        for w in self._writers.values():
            w.close()
        self._writers.clear()

    def read(self, bucket: int) -> pa.Table | None:
        """One sealed bucket as an Arrow table (None when nothing was
        spilled there)."""
        self.finish_writes()
        path = self._path(bucket)
        if not os.path.exists(path):
            return None
        with paipc.open_file(path) as r:
            return r.read_all()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.finish_writes()
        shutil.rmtree(self.dir, ignore_errors=True)


class HostStaging:
    """Pinned host memory (uint8) that a grouped write copies into: grown
    (by half again at least) when too small, freed by ``release``. A
    write's copy is read before the next write begins."""

    def __init__(self) -> None:
        self._buf: torch.Tensor | None = None

    def __call__(self, nbytes: int) -> torch.Tensor:
        if self._buf is None or self._buf.numel() < nbytes:
            have = 0 if self._buf is None else self._buf.numel()
            self._buf = None
            self._buf = torch.empty(max(nbytes, have + have // 2), dtype=torch.uint8, pin_memory=True)
        return self._buf

    def release(self) -> None:
        self._buf = None


def grouped_arrow(staging: HostStaging, batch: DeviceBatch, order, offsets, stats: dict):
    """One Arrow batch of a batch's live rows in the grouped order
    (``order`` and ``offsets`` of ``ops/partition.partition_groups``), with
    each group's start and length (int64 arrays of K): ``(rb, starts,
    lens)``, ``rb`` None when no row is live. One copy to the host and one
    wait on the card (``_grouped_to_host``); the Arrow build's host seconds
    go to ``stats["arrow_s"]``. On the card the batch's numeric columns
    alias ``staging``'s buffer, which the next call overwrites: a caller
    that keeps the batch longer passes a staging of its own."""
    stats["batches"] += 1
    cols, nulls, offs = _grouped_to_host(staging, batch, order, offsets, stats)
    live = int(offs[-2])
    starts, lens = offs[:-2], np.diff(offs[:-1])
    if not live:
        return None, starts, lens
    t = time.perf_counter()
    rb = arrow_from_host(
        batch.schema, [c[:live] for c in cols],
        [None if m is None else m[:live] for m in nulls], batch.dictionaries,
    )
    stats["arrow_s"] += time.perf_counter() - t
    return rb, starts, lens


def _grouped_to_host(staging: HostStaging, batch: DeviceBatch, order, offsets, stats: dict):
    """The batch's columns and null masks gathered by ``order`` (all rows,
    the live ones first), and ``offsets``, as host numpy arrays. On the
    card: the gathers queue behind the grouping, every piece is copied into
    the pinned ``staging`` buffer, and one wait ends it. On the CPU: the
    gathers alone."""
    pieces = [*batch.columns, *(m for m in batch.nulls if m is not None)]
    if order.device.type == "cpu":
        host = [p.index_select(0, order).numpy() for p in pieces] + [offsets.numpy()]
    else:
        t = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        gathered = [p.index_select(0, order) for p in pieces] + [offsets]
        ev[1].record()
        sizes = [g.numel() * g.element_size() for g in gathered]
        starts = np.cumsum([0] + [-(-n // 16) * 16 for n in sizes])  # 16-byte aligned
        buf = staging(int(starts[-1]))
        host = []
        for g, s, n in zip(gathered, starts, sizes):
            dst = buf[s : s + n].view(g.dtype)
            dst.copy_(g, non_blocking=True)
            host.append(dst.numpy())
        ev[2].record()
        t1 = time.perf_counter()
        ev[2].synchronize()
        stats["waits"] += 1
        stats["wait_s"] += time.perf_counter() - t1
        stats["group_ms"] += ev[0].elapsed_time(ev[1])
        stats["copy_ms"] += ev[1].elapsed_time(ev[2])
        stats["queue_s"] += t1 - t
    masks = iter(host[len(batch.columns) : -1])
    nulls = [None if m is None else next(masks) for m in batch.nulls]
    return host[: len(batch.columns)], nulls, host[-1]


def take_nbytes(rb: pa.RecordBatch, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The ``nbytes`` of ``rb.take(range(s, s + n))`` for each range of
    ``starts`` and ``lens`` (int64 arrays): what the reference charges a
    bucket, whose ``take`` makes fresh arrays. A slice's own ``nbytes``
    differs: it counts the bitmap bytes its bit offset spans, and a
    string's characters under null rows, where a ``take`` holds none. Per
    column: a validity bitmap where the column has one (a string's
    ``take`` always has one), the values (a bitmap for bools), and for
    strings 4 bytes of offsets a row and the characters of the non-null
    rows."""
    lens = np.asarray(lens, dtype=np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    bitmap = (lens + 7) // 8
    out = np.zeros(len(lens), dtype=np.int64)
    for col in rb.columns:
        t = col.type
        if pa.types.is_null(t):
            continue
        if col.buffers()[0] is not None or pa.types.is_string(t):  # take gives strings one
            out += bitmap
        if pa.types.is_boolean(t):
            out += bitmap
        elif pa.types.is_string(t):
            ends = np.frombuffer(
                col.buffers()[1], dtype=np.int32, count=len(col) + 1, offset=4 * col.offset
            )
            chars = np.diff(ends).astype(np.int64)
            if col.null_count:
                chars[np.asarray(col.is_null())] = 0
            before = np.concatenate([[0], np.cumsum(chars)])
            out += 4 * lens + before[starts + lens] - before[starts]
        else:
            out += lens * (t.bit_width // 8)
    return out


def spill_batch_by_keys(spill_set: SpillSet, batch: DeviceBatch, key_idxs: tuple) -> int:
    """Hash-route a batch's live rows into the set's bucket files, by the
    shuffle's routing, grouped on the batch's device
    (``ops/partition.batch_partition_groups``). Returns the bytes
    written."""
    from ballista_tpu_torch.ops.partition import batch_partition_groups

    _, order, offsets = batch_partition_groups(batch, list(key_idxs), spill_set.buckets)
    return spill_set.write_split(batch, order, offsets)


def tables_string_dicts(tabs: list) -> dict:
    """One union Dictionary per STRING column across ``tabs``, to pass as
    ``fixed_dicts`` to per-chunk ``table_from_arrow`` conversions: every
    chunk of every table then shares codes, so a consumer that unifies
    dictionaries (the grace join's probe loop) remaps at most once a pass
    instead of once a chunk."""
    import pyarrow.compute as pc

    vals: dict[str, set] = {}
    for t in tabs:
        for name in t.schema.names:
            typ = t.schema.field(name).type
            if pa.types.is_dictionary(typ):
                typ = typ.value_type
            if not (pa.types.is_string(typ) or pa.types.is_large_string(typ)):
                continue
            uniq = pc.unique(t.column(name))
            if pa.types.is_dictionary(uniq.type):
                uniq = uniq.cast(uniq.type.value_type)
            vals.setdefault(name, set()).update(
                v for v in uniq.to_pylist() if v is not None
            )
    return {n: Dictionary(tuple(sorted(v))) for n, v in vals.items()}


def choose_passes(total_bytes: int, budget_bytes: int, max_k: int) -> int:
    """The number of grace passes K (a power of two, at least 2) at which
    one pass's share of ``total_bytes`` is at most half the budget, the
    other half left to the kernels' own scratch (sort copies, probe
    gathers)."""
    k = 2
    while k < max_k and total_bytes > k * max(budget_bytes, 1) // 2:
        k <<= 1
    return k
