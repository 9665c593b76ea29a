"""DeviceBatch — a columnar batch of torch tensors on one device.

The port of ``ballista_tpu/columnar/batch.py``. The layout is the
reference's, slot for slot, so that a batch of one package can be compared
with the other's:

- one tensor per column, all padded to a shared ``capacity`` that rounds up
  the same bucket ladder as the reference (``CapacityLadder``);
- a ``valid`` bool mask: padding rows and filtered-out rows are invalid.
  Filters never move data;
- optional per-column null masks (True = null);
- host-side dictionaries for STRING columns (the device sees int32 codes);
- ``shards``: the shard count of a mesh's global layout (``parallel/mesh.py``:
  block ``d`` of ``capacity / shards`` rows is shard ``d``'s rows), or None
  for a batch that is not laid out over a mesh. Only a batch with the same
  rows at the same positions keeps it (``with_columns``, ``with_valid``);
  every other rebuild clears it.

PyTorch needs no static shapes, but the ladder stays: it keeps capacities
and padding identical to the reference's, and it bounds how many distinct
tensor sizes the caching allocator sees.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from ballista_tpu_torch.datatypes import DataType, Schema
from ballista_tpu_torch.errors import InternalError, SchemaError

MIN_CAPACITY = 2048


def resolve_device(device: str | torch.device) -> torch.device:
    """The device that batches are placed on. Every entry point defaults to
    ``"cuda"`` and resolves it here, so a missing card raises instead of the
    work landing on the CPU; the CPU is used only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class CapacityLadder:
    """The process-wide capacity-bucket policy.

    Every row capacity in the engine (scan batches, join build tables,
    aggregate states, expansion outputs) rounds up through ONE ladder, so
    unrelated queries land on the same tensor sizes, and capacities equal
    the reference's under the same ladder. The ladder is geometric —
    ``min_cap * ratio**k`` — or an explicit sorted bucket list extended
    geometrically past its top; the default (min 2048, ratio 2) is
    power-of-two rounding. Configure via ``ballista.tpu.capacity_buckets``
    ("<min>:<ratio>" or "b0,b1,b2,..."): a coarser ratio trades padding
    (bounded by the ratio) for fewer distinct sizes.
    """

    def __init__(self, min_cap: int = MIN_CAPACITY, ratio: int = 2,
                 explicit: tuple[int, ...] | None = None):
        if explicit:
            explicit = tuple(sorted(set(int(b) for b in explicit)))
            if explicit[0] < 8:
                raise ValueError(f"capacity bucket too small: {explicit[0]}")
            min_cap = explicit[0]
        if min_cap < 8:
            raise ValueError(f"min capacity too small: {min_cap}")
        if ratio < 2:
            raise ValueError(f"bucket ratio must be >= 2: {ratio}")
        self.min_cap = int(min_cap)
        self.ratio = int(ratio)
        self.explicit = explicit

    @classmethod
    def parse(cls, spec: str) -> "CapacityLadder":
        spec = (spec or "").strip()
        if not spec:
            return cls()
        if "," in spec:
            lad = cls(explicit=tuple(
                int(s) for s in spec.split(",") if s.strip()
            ))
        elif ":" in spec:
            mn, _, r = spec.partition(":")
            lad = cls(min_cap=int(mn), ratio=int(r))
        else:
            lad = cls(min_cap=int(spec))
        # configured ladders keep the engine-wide floor of 2048 rows (the
        # raw constructor stays relaxed for targeted tests)
        if lad.min_cap < MIN_CAPACITY:
            raise ValueError(
                f"capacity bucket below the {MIN_CAPACITY} tileable "
                f"minimum: {lad.min_cap}"
            )
        return lad

    def spec(self) -> str:
        if self.explicit:
            return ",".join(str(b) for b in self.explicit)
        return f"{self.min_cap}:{self.ratio}"

    def round(self, n: int) -> int:
        """Smallest ladder bucket >= n (geometric past any explicit top)."""
        if self.explicit:
            for b in self.explicit:
                if n <= b:
                    return b
            cap = self.explicit[-1]
        else:
            cap = self.min_cap
        while cap < n:
            cap *= self.ratio
        return cap

    def buckets_upto(self, n: int) -> tuple[int, ...]:
        """Every ladder bucket <= round(n)."""
        top = self.round(max(n, self.min_cap))
        out = list(b for b in (self.explicit or ()) if b <= top)
        cap = out[-1] if out else self.min_cap
        if not out:
            out.append(cap)
        while cap < top:
            cap *= self.ratio
            out.append(cap)
        return tuple(out)


_LADDER = CapacityLadder()
_LADDER_INSTALLED = False  # flips-after-install are logged (see below)


def set_capacity_buckets(spec: str) -> "CapacityLadder":
    """Install the process-wide bucket ladder (``TorchContext`` and the
    executor task entry apply ``ballista.tpu.capacity_buckets`` here).
    Process-global, as in the reference: capacities are what plan-cache
    entries and learned hints are keyed and sized by, and two ladders in
    one process would make each re-learn the other's. Mixed-capacity
    batches in flight across a change remain valid (capacity is carried
    per batch, never re-derived).
    """
    global _LADDER, _LADDER_INSTALLED
    ladder = CapacityLadder.parse(spec)
    if ladder.spec() != _LADDER.spec():
        if _LADDER_INSTALLED:
            # a mid-process flip is legal but costly: an executor serving
            # sessions with different ladders re-learns adaptive
            # capacities across each swap
            import logging

            logging.getLogger(__name__).warning(
                "capacity ladder changed %s -> %s; mixed-ladder sessions "
                "on one executor re-learn their capacities",
                _LADDER.spec(), ladder.spec(),
            )
        _LADDER = ladder
        _LADDER_INSTALLED = True
    return _LADDER


def capacity_ladder() -> CapacityLadder:
    return _LADDER


def round_capacity(n: int) -> int:
    """Round a row count up to the bucketed capacity."""
    return _LADDER.round(n)


@dataclasses.dataclass(frozen=True)
class Dictionary:
    """Host-side dictionary for a STRING column: code i <-> values[i]."""

    values: tuple[str, ...]

    def index_of(self, s: str) -> int:
        try:
            return self.values.index(s)
        except ValueError:
            return -1

    def __len__(self) -> int:
        return len(self.values)


@dataclasses.dataclass
class DeviceBatch:
    """A padded columnar batch. Columns/valid/nulls are tensors on one
    device; schema and dictionaries live on the host."""

    schema: Schema
    columns: tuple[torch.Tensor, ...]
    valid: torch.Tensor  # bool[capacity]
    nulls: tuple[torch.Tensor | None, ...]  # per-column True=null, or None
    dictionaries: Mapping[str, Dictionary]  # for STRING columns
    shards: int | None = None  # mesh shard count of the block layout

    # -- construction --------------------------------------------------------
    @classmethod
    def from_host(
        cls,
        schema: Schema,
        arrays: Sequence[np.ndarray],
        num_rows: int | None = None,
        dictionaries: Mapping[str, Dictionary] | None = None,
        nulls: Sequence[np.ndarray | None] | None = None,
        capacity: int | None = None,
        device: torch.device | str = "cuda",
    ) -> "DeviceBatch":
        """Pad host arrays to a bucketed capacity and move them to
        ``device``."""
        device = resolve_device(device)
        if len(arrays) != len(schema):
            raise SchemaError(f"{len(arrays)} arrays for {len(schema)} fields")
        n = num_rows if num_rows is not None else (len(arrays[0]) if arrays else 0)
        cap = capacity if capacity is not None else round_capacity(n)
        if cap < n:
            raise InternalError(f"capacity {cap} < num_rows {n}")
        cols = []
        for field, arr in zip(schema, arrays):
            want = field.dtype.to_np()
            a = np.asarray(arr)
            if a.dtype != want and not (want == np.int64 and a.dtype == np.int32):
                # int32 is a permitted physical form of a logical INT64
                # column (see arrow_interop narrowing)
                a = a.astype(want)
            padded = np.zeros(cap, dtype=a.dtype)
            padded[:n] = a[:n]
            cols.append(torch.from_numpy(padded).to(device))
        valid = np.zeros(cap, dtype=bool)
        valid[:n] = True
        null_cols: list[torch.Tensor | None] = []
        for i in range(len(schema)):
            nm = None if nulls is None else nulls[i]
            if nm is None:
                null_cols.append(None)
            else:
                pm = np.zeros(cap, dtype=bool)
                pm[:n] = np.asarray(nm, dtype=bool)[:n]
                null_cols.append(torch.from_numpy(pm).to(device))
        return cls(
            schema=schema,
            columns=tuple(cols),
            valid=torch.from_numpy(valid).to(device),
            nulls=tuple(null_cols),
            dictionaries=dict(dictionaries or {}),
        )

    @classmethod
    def empty(
        cls,
        schema: Schema,
        capacity: int = MIN_CAPACITY,
        device: torch.device | str = "cuda",
    ) -> "DeviceBatch":
        # STRING fields carry an (empty) dictionary, as in the reference
        return cls.from_host(
            schema,
            [np.zeros(0, f.dtype.to_np()) for f in schema],
            0,
            dictionaries={
                f.name: Dictionary(()) for f in schema if f.dtype == DataType.STRING
            },
            capacity=capacity,
            device=device,
        )

    # -- accessors -----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def column(self, name: str) -> torch.Tensor:
        return self.columns[self.schema.index_of(name)]

    def null_mask(self, name: str) -> torch.Tensor | None:
        return self.nulls[self.schema.index_of(name)]

    def count_valid(self) -> torch.Tensor:
        """Number of live rows, as a device scalar (no sync)."""
        return self.valid.sum(dtype=torch.int32)

    def num_rows(self) -> int:
        """Number of live rows: waits for the device (host-side use only;
        no operator calls it)."""
        return int(self.count_valid().item())  # devlint: disable=host-sync

    def with_columns(
        self,
        schema: Schema,
        columns: Sequence[torch.Tensor],
        nulls: Sequence[torch.Tensor | None] | None = None,
        dictionaries: Mapping[str, Dictionary] | None = None,
    ) -> "DeviceBatch":
        """Same rows/validity, different column set (projection output)."""
        return DeviceBatch(
            schema=schema,
            columns=tuple(columns),
            valid=self.valid,
            nulls=tuple(nulls) if nulls is not None else tuple([None] * len(schema)),
            dictionaries=dict(
                dictionaries if dictionaries is not None else self.dictionaries
            ),
            shards=self.shards,
        )

    def with_valid(self, valid: torch.Tensor) -> "DeviceBatch":
        out = DeviceBatch(
            schema=self.schema,
            columns=self.columns,
            valid=valid,
            nulls=self.nulls,
            dictionaries=dict(self.dictionaries),
            shards=self.shards,
        )
        # masking can only REMOVE rows, so a key-uniqueness mark survives it
        if getattr(self, "keys_unique", False):
            out.keys_unique = True
        return out

    def head(self, capacity: int) -> "DeviceBatch":
        """The first ``capacity`` rows of every column, null mask and the
        valid mask, as views (no copy); the caller must know that the live
        rows fit the prefix."""
        if capacity >= self.capacity:
            return self
        return DeviceBatch(
            schema=self.schema,
            columns=tuple(c[:capacity] for c in self.columns),
            valid=self.valid[:capacity],
            nulls=tuple(None if m is None else m[:capacity] for m in self.nulls),
            dictionaries=dict(self.dictionaries),
        )

    # -- host materialization ------------------------------------------------
    def to_host(self) -> tuple[Schema, list[np.ndarray], list[np.ndarray | None]]:
        """Live rows back to host numpy arrays (compacted). One sync for
        the live-row index; only live rows cross to the host."""
        idx = torch.nonzero(self.valid).squeeze(1)
        cols = [c[idx].cpu().numpy() for c in self.columns]
        nulls = [None if m is None else m[idx].cpu().numpy() for m in self.nulls]
        return self.schema, cols, nulls

    def __repr__(self) -> str:
        return f"DeviceBatch({self.schema!r}, capacity={self.capacity})"
