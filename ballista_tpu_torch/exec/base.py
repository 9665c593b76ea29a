"""ExecutionPlan protocol, partitioning, task context, metrics.

The port of ``ballista_tpu/exec/base.py``: ``schema()``,
``output_partitioning()``, ``execute(partition, ctx)`` streaming
DeviceBatches, per-operator metrics, and the task context that carries the
device and the deferred device checks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch, resolve_device
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.datatypes import Schema


@dataclasses.dataclass(frozen=True)
class UnknownPartitioning:
    n: int


@dataclasses.dataclass
class TaskContext:
    """Per-task runtime state: the session config, the device every batch
    of the task lives on (the card unless the caller asks for the CPU), and
    the deferred device checks."""

    config: BallistaConfig = dataclasses.field(default_factory=BallistaConfig)
    device: torch.device | str = "cuda"
    # Deferred on-device error flags (bool scalars). Reading a scalar waits
    # for the device, so operators queue their checks here and the task
    # boundary fetches them all at once (raise_deferred), instead of one
    # sync per batch.
    deferred_checks: list = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def defer_check(self, flag, message: str, required=None) -> None:
        """Queue a device bool ``flag``; if it is set at the task boundary
        the task fails with ``message``. ``required`` (device int scalar) is
        the capacity that would have sufficed."""
        self.deferred_checks.append((flag, message, required))

    def raise_deferred(self) -> None:
        if not self.deferred_checks:
            return
        from ballista_tpu_torch.errors import CapacityError

        checks, self.deferred_checks = self.deferred_checks, []
        def scalar(v) -> torch.Tensor:
            return torch.as_tensor(v, device=self.device).reshape(()).to(torch.int64)

        # one (k, 2) device->host copy for every flag and its capacity
        got = torch.stack(
            [
                torch.stack([scalar(f), scalar(0 if r is None else r)])
                for f, _, r in checks
            ]
        ).cpu()
        fired = [(m, int(r)) for (_, m, _), (f, r) in zip(checks, got) if bool(f)]
        if fired:
            raise CapacityError(
                "; ".join(dict.fromkeys(m for m, _ in fired)),
                required=max(r for _, r in fired),
            )


class Metrics:
    """Per-operator counters/timers."""

    def __init__(self) -> None:
        self.counters: dict[str, int] = {}
        self.timers: dict[str, float] = {}

    def add(self, name: str, v=1) -> None:
        self.counters[name] = self.counters.get(name, 0) + v

    def reset(self) -> None:
        self.counters.clear()
        self.timers.clear()

    def time(self, name: str):
        return _Timer(self, name)

    def summary(self) -> dict[str, float]:
        """Counters (device scalars resolve here, at report time) and timers
        in float seconds, keys sorted."""
        out: dict[str, float] = {
            k: v if isinstance(v, (int, float)) else int(v)
            for k, v in self.counters.items()
        }
        out.update({k: round(float(v), 6) for k, v in self.timers.items()})
        return dict(sorted(out.items()))

    def format(self) -> str:
        s = self.summary()
        parts = [
            f"{k}={v}s" if k in self.timers else f"{k}={v}" for k, v in s.items()
        ]
        return "[" + ", ".join(parts) + "]"


class _Timer:
    def __init__(self, m: Metrics, name: str):
        self.m = m
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.m.timers[self.name] = self.m.timers.get(self.name, 0.0) + (
            time.perf_counter() - self.t0
        )
        return False


class ExecutionPlan:
    """Base physical operator. Subclasses implement ``execute`` returning an
    iterator of DeviceBatch for one output partition."""

    def __init__(self) -> None:
        self.metrics = Metrics()

    def schema(self) -> Schema:
        raise NotImplementedError

    def children(self) -> list["ExecutionPlan"]:
        return []

    def output_partitioning(self) -> UnknownPartitioning:
        return UnknownPartitioning(1)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__

    def display(self, with_metrics: bool = False) -> str:
        lines: list[str] = []

        def walk(node: "ExecutionPlan", depth: int) -> None:
            line = "  " * depth + node.describe()
            if with_metrics and (node.metrics.counters or node.metrics.timers):
                line += f"  metrics={node.metrics.format()}"
            lines.append(line)
            for c in node.children():
                walk(c, depth + 1)

        walk(self, 0)
        return "\n".join(lines)


def execute_to_batches(plan: ExecutionPlan, ctx: TaskContext) -> list[DeviceBatch]:
    """Run every output partition of a plan and collect the batches."""
    out: list[DeviceBatch] = []
    for p in range(plan.output_partitioning().n):
        out.extend(plan.execute(p, ctx))
    return out
