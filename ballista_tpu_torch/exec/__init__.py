"""Physical operators, the physical planner and the ``TorchContext`` (the
reference's ``TpuContext``)."""

from ballista_tpu_torch import _lazy

__all__ = [
    "ExecutionPlan",
    "HashPartitioning",
    "Partitioning",
    "TaskContext",
    "TorchContext",
    "UnknownPartitioning",
]
__getattr__ = _lazy(
    __name__,
    {n: "ballista_tpu_torch.exec.base" for n in __all__ if n != "TorchContext"}
    | {"TorchContext": "ballista_tpu_torch.exec.context"},
)
