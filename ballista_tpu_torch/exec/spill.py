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

Rows route by the shuffle's rule (``ops/partition.py`` through
``exec/repartition.partition_ids_fn``): a string key hashes by its value,
NULL keys share a bucket. Each routed batch costs one device-to-host copy
of its live rows and partition ids, and one IPC write per bucket it fills.

Left out of the port, as neither changes a result and the port has neither
module yet: the reference's resource-witness hooks (``analysis.reswitness``)
and its spill trace events (``obs.trace``); and the executor's TTL sweep of
orphaned attempt directories, which comes with the distributed tier.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import uuid

import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc
import torch

from ballista_tpu_torch.columnar.arrow_interop import batch_to_arrow
from ballista_tpu_torch.columnar.batch import DeviceBatch, Dictionary
from ballista_tpu_torch.errors import ExecutionError

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

    def write(self, bucket: int, rb: pa.RecordBatch) -> None:
        if rb.num_rows == 0:
            return
        w = self._writers.get(bucket)
        if w is None:
            w = paipc.new_file(self._path(bucket), rb.schema)
            self._writers[bucket] = w
        w.write_batch(rb)
        self.bucket_rows[bucket] += rb.num_rows
        self.bucket_bytes[bucket] += rb.nbytes
        self.manager.account(rb.nbytes)

    def write_split(self, batch: DeviceBatch, pids: torch.Tensor) -> int:
        """Route a batch's live rows to the bucket files by their partition
        ids (aligned with the batch's capacity; invalid rows carry the drop
        id and are left out by ``batch_to_arrow``'s live-row gather).
        Returns the bytes written."""
        before = self.manager.total_bytes
        rb = batch_to_arrow(batch)
        if rb.num_rows:
            # the live rows' ids, in batch_to_arrow's row order
            live = pids[batch.valid].cpu().numpy()
            # one stable argsort groups the rows by bucket; searchsorted
            # gives each bucket's contiguous index range
            order = np.argsort(live, kind="stable")
            grouped = live[order]
            bounds = np.searchsorted(grouped, np.arange(self.buckets + 1))
            for b in np.unique(grouped):
                s, e = bounds[b], bounds[b + 1]
                self.write(int(b), rb.take(pa.array(order[s:e])))
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


def spill_batch_by_keys(spill_set: SpillSet, batch: DeviceBatch, key_idxs: tuple) -> int:
    """Hash-route a batch's live rows into the set's bucket files, by the
    shuffle's routing (``exec/repartition.partition_ids_fn``). Returns the
    bytes written."""
    from ballista_tpu_torch.exec.repartition import partition_ids_fn
    from ballista_tpu_torch.ops.partition import string_key_tables

    tables = string_key_tables(batch, list(key_idxs))
    pids = partition_ids_fn(tuple(key_idxs), spill_set.buckets)(batch, tables)
    return spill_set.write_split(batch, pids)


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
