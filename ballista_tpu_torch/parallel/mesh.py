"""The shard mesh and the block layout of a sharded batch (port of
``ballista_tpu/parallel/mesh.py``).

The reference's mesh is 1-D over the shuffle axis, one shard per chip, and
one process drives every chip through one jitted ``shard_map``. Here a
mesh is N shards on one torch device (``TorchMesh``): the shard count is
the counterpart of XLA's forced host device count, read from
``BALLISTA_TPU_MESH_SHARDS`` (unset: 1, no mesh) or given to
``make_mesh``. Shards spread over several cards would need a process group
and are refused.

A sharded batch has the reference's global layout: one ``DeviceBatch`` of
capacity ``N * cap`` whose block ``d`` (rows ``d * cap`` to
``(d + 1) * cap``) holds shard ``d``'s rows, its ``shards`` field set to
N. Every operator consumes such a batch unchanged, and where the
reference's XLA propagation keeps the row sharding, the port keeps the
field. Running the reference's mesh SQL cases on its 8-device CPU mesh and
reading ``is_row_sharded`` of each operator's output gives:

- sharded: ``MeshAggregateExec``, ``MeshJoinExec``, ``MeshWindowExec``
  and the sample sort of ``MeshSortExec``; ``ProjectionExec`` and
  ``FilterExec`` over a sharded input (unless the capacity shrink after a
  filter compacts the batch); ``RenameExec``, ``CoalescePartitionsExec``
  and ``UnionExec`` pass a sharded child batch through;
- not sharded: the scans, ``HashAggregateExec``, ``WindowExec``,
  ``GlobalLimitExec``, the top-k of ``MeshSortExec`` (its answer is
  replicated) and a shrunk batch.

The port keeps the field in ``DeviceBatch.with_columns`` and
``with_valid`` (the same rows at the same positions) and in
``RenameExec``; every other rebuild clears it, and a mesh operator that
gets an unmarked input lays it out anew (``MeshRuntime.place``).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch, resolve_device, round_capacity
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops.perm import stable_argsort, take_many_split

SHARD_AXIS = "shards"
SHARDS_ENV = "BALLISTA_TPU_MESH_SHARDS"


def mesh_shards() -> int:
    """The shard count of this process's mesh: ``BALLISTA_TPU_MESH_SHARDS``
    (unset or empty: 1, no mesh)."""
    raw = os.environ.get("BALLISTA_TPU_MESH_SHARDS", "").strip()
    if not raw:
        return 1
    try:
        n = int(raw)
    except ValueError:
        n = 0
    if n < 1:
        raise ValueError(f"{SHARDS_ENV}={raw!r}: want a positive shard count")
    return n


@dataclasses.dataclass(frozen=True)
class TorchMesh:
    """N shards on one torch device. ``devices`` has one entry a shard (all
    the same device), so the API has the reference's shape."""

    n_dev: int
    device: torch.device

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return (self.device,) * self.n_dev


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the card it means (``cuda:i``): tensors report their
    card's index, so the mesh compares with them."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices: int | None = None, device="cuda") -> TorchMesh:
    """A mesh of ``n_devices`` shards (default: ``mesh_shards()``) on
    ``device``: the card unless the caller asks for the CPU. ``device`` may
    be a sequence of devices, one a shard; they must all be one device."""
    if isinstance(device, (list, tuple)):
        devs = {_indexed(resolve_device(d)) for d in device}
        if len(devs) != 1:
            raise ExecutionError(
                f"a mesh holds its shards on one device, not {sorted(map(str, devs))}: "
                "shards spread over several cards are not supported"
            )
        if n_devices is None:
            n_devices = len(device)
        device = devs.pop()
    n = mesh_shards() if n_devices is None else int(n_devices)
    if n < 1:
        raise ExecutionError(f"a mesh needs at least one shard, not {n}")
    return TorchMesh(n, _indexed(resolve_device(device)))


def check_layout(batch: DeviceBatch, n_dev: int) -> int:
    """The per-shard capacity of a batch in the block layout over ``n_dev``
    shards; raises when the batch cannot have that layout."""
    if batch.capacity % n_dev or (batch.shards is not None and batch.shards != n_dev):
        raise ExecutionError(
            f"batch of capacity {batch.capacity} (shards={batch.shards}) is not "
            f"in the block layout of {n_dev} shards"
        )
    return batch.capacity // n_dev


def shard_batch(mesh: TorchMesh, batch: DeviceBatch) -> DeviceBatch:
    """Lay a batch out over the mesh's shards: live row ``i`` goes to shard
    ``i % N`` at position ``i // N``, in order; the rest of each block is
    padding. One host read of the live-row count picks the per-shard
    capacity (``round_capacity(ceil(n / N))``); the rows move by one
    gather on the batch's device."""
    if batch.device != mesh.device:
        raise ExecutionError(f"batch on {batch.device}, mesh on {mesh.device}")
    n_dev = mesh.n_dev
    # the capacity is chosen from the live count on the host, as the
    # reference counts its rows on the host
    n = int(batch.count_valid().item())  # devlint: disable=host-sync
    cap = round_capacity(max(-(-n // n_dev), 1))
    order = stable_argsort(~batch.valid)  # live rows first, in row order
    j = torch.arange(n_dev * cap, device=batch.device)
    i = (j % cap) * n_dev + j // cap  # live rank of each slot's row
    src = order[i.clamp(max=batch.capacity - 1)]
    cols, nulls = take_many_split(list(batch.columns), list(batch.nulls), src)
    return DeviceBatch(
        schema=batch.schema,
        columns=tuple(cols),
        valid=i < n,
        nulls=tuple(nulls),
        dictionaries=dict(batch.dictionaries),
        shards=n_dev,
    )


def is_row_sharded(batch: DeviceBatch, mesh: TorchMesh) -> bool:
    """True when the batch is already in this mesh's block layout (the
    invariant mesh stage outputs keep), so a chain of mesh operators
    composes without laying rows out again."""
    return (
        batch.shards == mesh.n_dev
        and batch.device == mesh.device
        and batch.capacity % mesh.n_dev == 0
    )


def unshard_batch(batch: DeviceBatch) -> DeviceBatch:
    """The batch as one unsharded batch: the rows are already on one
    device, so only the mark is cleared."""
    return DeviceBatch(
        schema=batch.schema,
        columns=batch.columns,
        valid=batch.valid,
        nulls=batch.nulls,
        dictionaries=dict(batch.dictionaries),
    )
