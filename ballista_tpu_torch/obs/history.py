"""Per-task-attempt resource cost accounting (the executor's part of
``ballista_tpu/obs/history.py``).

:class:`CostVector` is the resource vector of one task attempt (wall
seconds, CPU thread-time seconds, shuffle bytes read and written, pushed
bytes, spill bytes, claimed compile seconds), measured by the executor
around every attempt and shipped home on ``CompletedTask.cost`` /
``FailedTask.cost`` (``ballista.tpu.cost_accounting``, on by default).

"Compile seconds" here are the nvcc build seconds that
``ops/cuda_build`` spent in this process: the port's counterpart of the
reference's XLA compile time, claimed exactly once across the attempts
that run after the executor was constructed.

The reference's ``HistoryStore`` and the ``system.*`` tables come with
the scheduler (ROADMAP queue 1, items 3 and 9d).
"""

from __future__ import annotations

import dataclasses

from ballista_tpu_torch.analysis.witness import make_lock

# the closed cost-vector key set — every surface (proto, JSON records,
# Prometheus rollup, system-table columns, bench fields) uses exactly
# these names, so a new resource dimension is a one-list change
COST_KEYS = (
    "wall_seconds",
    "cpu_seconds",
    "shuffle_read_bytes",
    "shuffle_write_bytes",
    "pushed_bytes",
    "spill_bytes",
    "compile_seconds",
)

_BYTE_KEYS = (
    "shuffle_read_bytes", "shuffle_write_bytes", "pushed_bytes",
    "spill_bytes",
)


@dataclasses.dataclass
class CostVector:
    """One attempt's (or one job's aggregated) resource cost."""

    wall_seconds: float = 0.0
    cpu_seconds: float = 0.0
    shuffle_read_bytes: int = 0
    shuffle_write_bytes: int = 0
    pushed_bytes: int = 0
    spill_bytes: int = 0
    compile_seconds: float = 0.0

    def add(self, other: "CostVector") -> None:
        for k in COST_KEYS:
            setattr(self, k, getattr(self, k) + getattr(other, k))

    def to_dict(self) -> dict:
        return {
            k: (round(v, 6) if isinstance(v, float) else int(v))
            for k, v in ((k, getattr(self, k)) for k in COST_KEYS)
        }

    @classmethod
    def from_dict(cls, d: dict | None) -> "CostVector":
        c = cls()
        for k in COST_KEYS:
            v = (d or {}).get(k, 0)
            setattr(c, k, int(v) if k in _BYTE_KEYS else float(v))
        return c

    def is_zero(self) -> bool:
        return all(not getattr(self, k) for k in COST_KEYS)


def cost_to_proto(cost: CostVector | None):
    """CostVectorP for the wire, or None when there is nothing to ship
    (the caller skips the field — absent IS the accounting-off path)."""
    if cost is None or cost.is_zero():
        return None
    from ballista_tpu_torch.proto import pb

    return pb.CostVectorP(
        wall_seconds=cost.wall_seconds,
        cpu_seconds=cost.cpu_seconds,
        shuffle_read_bytes=int(cost.shuffle_read_bytes),
        shuffle_write_bytes=int(cost.shuffle_write_bytes),
        pushed_bytes=int(cost.pushed_bytes),
        spill_bytes=int(cost.spill_bytes),
        compile_seconds=cost.compile_seconds,
    )


def cost_from_proto(msg) -> CostVector:
    return CostVector(
        wall_seconds=float(msg.wall_seconds),
        cpu_seconds=float(msg.cpu_seconds),
        shuffle_read_bytes=int(msg.shuffle_read_bytes),
        shuffle_write_bytes=int(msg.shuffle_write_bytes),
        pushed_bytes=int(msg.pushed_bytes),
        spill_bytes=int(msg.spill_bytes),
        compile_seconds=float(msg.compile_seconds),
    )


# ---------------------------------------------------------------------------
# measurement helpers (executor / local context side)
# ---------------------------------------------------------------------------

# plan metric counters folded into the cost vector: fetched_bytes is the
# shuffle-read side (executor/reader.py), spill_bytes covers grace-hash
# passes (exec/spill.py) AND the push window's forced spills
# (executor/push.py meters push_spill_bytes separately), pushed_bytes the
# in-memory push commits (docs/shuffle.md)
_READ_COUNTERS = ("fetched_bytes",)
_SPILL_COUNTERS = ("spill_bytes", "push_spill_bytes")
_PUSH_COUNTERS = ("pushed_bytes",)

# exactly-once claim ledger for the process-wide nvcc build-seconds
# counter (ops/cuda_build.build_seconds): each attempt claims the UNCLAIMED
# compile time at its completion, so concurrent attempts split the
# process total approximately but the sum across attempts never exceeds
# it (no double charging). The baseline latches at init_compile_claim()
# (executor construction) so builds before it are never charged to the
# first task.
_claim_lock = make_lock("obs.history._claim_lock")
_claimed_compile_s: float | None = None


def _compile_seconds_now() -> float:
    from ballista_tpu_torch.ops import cuda_build

    return cuda_build.build_seconds()


def init_compile_claim() -> None:
    """Latch the claim baseline (idempotent). Called at Executor
    construction so build time before the first task is excluded from
    task attribution."""
    global _claimed_compile_s
    with _claim_lock:
        if _claimed_compile_s is None:
            _claimed_compile_s = _compile_seconds_now()


def claim_compile_seconds() -> float:
    """The process compile seconds accrued since the last claim (0 before
    :func:`init_compile_claim`). Exactly-once: two concurrent claimants
    split the delta, never double it."""
    global _claimed_compile_s
    now = _compile_seconds_now()
    with _claim_lock:
        if _claimed_compile_s is None:
            return 0.0
        delta = now - _claimed_compile_s
        _claimed_compile_s = now
    return max(0.0, delta)


def cost_from_run(
    wall_seconds: float,
    cpu_seconds: float,
    plan=None,
    partitions=None,
    compile_seconds: float | None = None,
) -> CostVector:
    """Assemble one attempt's cost vector from its measured wall/CPU
    time, the executed plan's data-plane counters, and the committed
    shuffle partition metas (write side). ``compile_seconds=None`` takes
    the exactly-once process claim (the executor path); callers that
    measured their own delta (the local context, which must not steal
    claims from in-proc executors) pass it explicitly."""
    c = CostVector(
        wall_seconds=max(0.0, wall_seconds),
        cpu_seconds=max(0.0, cpu_seconds),
        compile_seconds=(
            claim_compile_seconds() if compile_seconds is None
            else max(0.0, compile_seconds)
        ),
    )
    if plan is not None:
        from ballista_tpu_torch.exec.base import plan_counters

        counters = plan_counters(
            plan, _READ_COUNTERS + _SPILL_COUNTERS + _PUSH_COUNTERS
        )
        c.shuffle_read_bytes = sum(counters[k] for k in _READ_COUNTERS)
        c.spill_bytes = sum(counters[k] for k in _SPILL_COUNTERS)
        c.pushed_bytes = sum(counters[k] for k in _PUSH_COUNTERS)
    for m in partitions or ():
        c.shuffle_write_bytes += max(0, int(m.num_bytes))
    return c
