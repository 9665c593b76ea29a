"""Columnar batches over torch tensors, Arrow interop, and the bridge from
the reference's batch layout."""

from ballista_tpu_torch import _lazy

_BATCH = "ballista_tpu_torch.columnar.batch"
_ARROW = "ballista_tpu_torch.columnar.arrow_interop"

__all__ = [
    "CapacityLadder",
    "DeviceBatch",
    "capacity_ladder",
    "round_capacity",
    "set_capacity_buckets",
    "batch_from_arrow",
    "batch_to_arrow",
    "table_from_arrow",
]
__getattr__ = _lazy(__name__, {n: _BATCH for n in __all__[:5]} | {n: _ARROW for n in __all__[5:]})
