"""Device operations: aggregation, the one-hot group-sum kernel, concat and
sort. The exported names are imported at their first use."""

from ballista_tpu_torch import _lazy

__all__ = [
    "hash_columns",
    "compact",
    "sort_batch",
    "SortKey",
    "AggOp",
    "group_aggregate",
    "scalar_aggregate",
    "JoinSide",
    "build_side",
    "probe_side",
    "partition_ids",
]
_NAMES = {
    "hashing": ("hash_columns",),
    "compact": ("compact",),
    "sort": ("sort_batch", "SortKey"),
    "aggregate": ("AggOp", "group_aggregate", "scalar_aggregate"),
    "join": ("JoinSide", "build_side", "probe_side"),
    "partition": ("partition_ids",),
}
__getattr__ = _lazy(__name__, {n: f"ballista_tpu_torch.ops.{m}" for m, names in _NAMES.items() for n in names})
