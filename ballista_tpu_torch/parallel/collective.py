"""The shuffle exchange between the shards of a mesh (port of
``ballista_tpu/parallel/collective.py``).

In the reference each device hash-bins its rows into ``n_parts`` buckets
of ``bucket_cap`` slots (a stable sort and a scatter), and one
``jax.lax.all_to_all`` over ICI hands bucket ``d`` of every device to
device ``d``. Here every shard lies on one device in the global layout
(``parallel/mesh.py``), so the functions take and return global tensors:
N blocks of rows, N = ``n_parts``.

``exchange_by_key`` / ``exchange_by_pid`` do the reference's
``bucket_rows`` followed by ``all_to_all_rows`` as one permutation of the
global layout: block ``d`` of the result holds, bucket by bucket, the rows
shard ``d`` received from each shard ``b``. Row ``r`` of shard ``s``,
bound for shard ``d`` with rank ``k`` in its bucket, lands at
``d * (N * bucket_cap) + s * bucket_cap + k``: one stable grouping by
``(s, pid)`` (``ops/partition.group_by_id``) and one gather a column. The
port's callers need only the whole exchange (the sample sort's range
exchange too, by ``exchange_by_pid``), so the two halves are not
functions of their own.

A row's bucket is ``hash(key) % N`` by ``ops/partition.partition_ids_for``
without string tables: the reference's mesh hashes the dictionary codes of
a STRING key. On CUDA tensors that is one launch of the hand-written
``partition_hash`` kernel (ids mode) over all ``N * cap`` rows: the hash
does not depend on the shard. A row's rank in its bucket follows row
order; a row ranked past ``bucket_cap`` is dropped and sets its shard's
overflow flag, and rows with ``pid >= n_parts`` (invalid rows) are
dropped. Dropped rows land in one spare slot that is cut off (torch has no
``mode="drop"``). The overflow flags are one bool a source shard.
"""

from __future__ import annotations

import torch

from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops.partition import group_by_id, partition_ids_for
from ballista_tpu_torch.ops.perm import take_many_split


def _blocks(rows: int, n: int) -> int:
    if rows % n:
        raise ExecutionError(f"{rows} rows are not in the block layout of {n} shards")
    return rows // n


def _slots(pid: torch.Tensor, n_parts: int, bucket_cap: int):
    """(slot of each row in the exchanged layout, or the spare slot;
    per-shard overflow flags; output length)."""
    rows = pid.shape[0]
    cap = _blocks(rows, n_parts)
    dev = pid.device
    s = torch.arange(rows, device=dev) // cap
    pc = pid.to(torch.int64).clamp(0, n_parts)  # n_parts: the drop bucket
    g = s * (n_parts + 1) + pc
    order, offsets = group_by_id(g, n_parts * (n_parts + 1))
    rank = torch.empty(rows, dtype=torch.int64, device=dev)
    rank[order.long()] = torch.arange(rows, device=dev) - offsets[g[order.long()]]
    live = pc < n_parts
    fits = live & (rank < bucket_cap)
    overflow = (live & (rank >= bucket_cap)).view(n_parts, cap).any(dim=1)
    out_len = n_parts * n_parts * bucket_cap
    slot = pc * (n_parts * bucket_cap) + s * bucket_cap + rank
    return torch.where(fits, slot, out_len), overflow, out_len


def _move(cols, nulls, slot: torch.Tensor, out_len: int):
    """Rows to their slots: the source row of each output slot (one
    scatter of row numbers into a spare-slot-padded index), then one
    stacked gather of every column and null mask."""
    src = torch.full((out_len + 1,), -1, dtype=torch.int64, device=slot.device)
    src[slot] = torch.arange(slot.shape[0], device=slot.device)
    src = src[:out_len]
    out_cols, out_nulls = take_many_split(list(cols), list(nulls), src.clamp(min=0))
    return tuple(out_cols), tuple(out_nulls), src >= 0


def exchange_by_pid(
    cols: tuple[torch.Tensor, ...],
    nulls: tuple[torch.Tensor | None, ...],
    valid: torch.Tensor,
    pid: torch.Tensor,
    n_parts: int,
    bucket_cap: int,
) -> tuple[tuple, tuple, torch.Tensor, torch.Tensor]:
    """The exchange with caller-computed partition ids (``pid >= n_parts``
    drops the row): the range-exchange entry of the sample sort. Returns
    (cols, nulls, valid, overflow)."""
    slot, overflow, out_len = _slots(pid, n_parts, bucket_cap)
    out_cols, out_nulls, out_valid = _move(cols, nulls, slot, out_len)
    return out_cols, out_nulls, out_valid, overflow


def exchange_by_key(
    batch_cols: tuple[torch.Tensor, ...],
    batch_nulls: tuple[torch.Tensor | None, ...],
    valid: torch.Tensor,
    key_positions: tuple[int, ...],
    axis_name: str,
    n_parts: int,
    bucket_cap: int,
) -> tuple[tuple, tuple, torch.Tensor, torch.Tensor]:
    """Afterwards every live row sits on the shard owning ``hash(key) %
    n_parts``. Returns (cols, nulls, valid, overflow)."""
    pid = partition_ids_for(
        [batch_cols[i] for i in key_positions],
        [batch_nulls[i] for i in key_positions],
        valid,
        n_parts,
    )
    return exchange_by_pid(batch_cols, batch_nulls, valid, pid, n_parts, bucket_cap)

