"""Mergeable, thread-safe, log-bucketed histograms: the executor's half of
the fleet-level latency plane (port of ``ballista_tpu/obs/hist.py``,
docs/observability.md).

- :class:`Histogram` — fixed log-spaced bucket bounds, per-bucket counts
  plus sum/count, all updates under one lock; ``observe`` is O(log B)
  (bisect).
- :class:`HistogramVec` — a named family with label dimensions
  (``class``/``stage``), children created on first observe.
- :class:`Registry` — named vecs + the executor->scheduler shipping
  seam: ``drain_deltas`` returns counts observed since the previous
  successful drain (exactly-once like the trace outbox: a failed RPC
  ``requeue_deltas`` what it drained). Executor processes observe into
  the module-level :data:`REGISTRY` (task-run and shuffle-fetch-wait
  durations), whose deltas ride the poll and the heartbeat home.

The scheduler's half (``ingest``, quantiles, the Prometheus exposition)
comes with the scheduler (ROADMAP queue 1, item 9d).
"""

from __future__ import annotations

import bisect

from ballista_tpu_torch.analysis.witness import make_lock

# Log-spaced (ratio-2) seconds ladder: 1ms .. ~1048s then +Inf. Covers a
# sub-millisecond dispatch lag and a 15-minute straggler in one family;
# 21 buckets keeps the per-series exposition and wire-delta cost small.
DEFAULT_BUCKETS: tuple[float, ...] = tuple(
    0.001 * (2.0 ** i) for i in range(21)
)


class Histogram:
    """One (family, label-values) child: bounds, counts, sum, count."""

    def __init__(self, buckets: tuple[float, ...], lock) -> None:
        self.buckets = tuple(buckets)
        self._lock = lock  # shared with the owning Registry
        self.counts = [0] * (len(self.buckets) + 1)  # +1 = the +Inf bucket
        self.sum = 0.0
        self.count = 0
        # counts already shipped by drain_deltas (the exactly-once
        # watermark); same length as counts
        self._shipped = [0] * (len(self.buckets) + 1)
        self._shipped_sum = 0.0
        self._shipped_count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        with self._lock:
            return list(self.counts), self.sum, self.count

class HistogramVec:
    """Named family with label dimensions; children by label values."""

    def __init__(
        self,
        name: str,
        help_text: str,
        labelnames: tuple[str, ...],
        buckets: tuple[float, ...],
        lock,
    ) -> None:
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self._lock = lock
        self._children: dict[tuple[str, ...], Histogram] = {}

    def labels(self, *values) -> Histogram:
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {key}"
            )
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Histogram(self.buckets, self._lock)
                self._children[key] = child
        return child

    def children(self) -> list[tuple[tuple[str, ...], Histogram]]:
        with self._lock:
            return sorted(self._children.items())


class Registry:
    """Named histogram families + the delta-shipping seam."""

    def __init__(self, name: str = "hist") -> None:
        self._lock = make_lock(f"obs.hist.Registry[{name}]", reentrant=True)
        self._vecs: dict[str, HistogramVec] = {}
        # deltas a failed ship requeued, merged into the next drain
        self._outbox: list[dict] = []

    def histogram(
        self,
        name: str,
        help_text: str = "",
        labelnames: tuple[str, ...] = (),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> HistogramVec:
        with self._lock:
            vec = self._vecs.get(name)
            if vec is None:
                vec = HistogramVec(
                    name, help_text, tuple(labelnames), tuple(buckets),
                    self._lock,
                )
                self._vecs[name] = vec
            elif vec.labelnames != tuple(labelnames):
                raise ValueError(
                    f"{name}: labelnames {vec.labelnames} != {labelnames}"
                )
        return vec

    def get(self, name: str) -> HistogramVec | None:
        with self._lock:
            return self._vecs.get(name)

    def clear(self) -> None:
        """Drop every family (test isolation)."""
        with self._lock:
            self._vecs.clear()
            self._outbox.clear()

    # -- executor -> scheduler shipping --------------------------------------
    def drain_deltas(self) -> list[dict]:
        """Everything observed since the last successful drain, as
        records ``{name, help, labels: {..}, buckets: [..], counts: [..],
        sum, count}`` — plus any deltas a failed RPC requeued. Advances
        the shipped watermark; a caller whose ship fails must
        :meth:`requeue_deltas` what it drained (exactly-once, like the
        trace outbox)."""
        out: list[dict] = []
        with self._lock:
            out.extend(self._outbox)
            self._outbox = []
            for name, vec in sorted(self._vecs.items()):
                for key, child in sorted(vec._children.items()):
                    counts = [
                        c - s
                        for c, s in zip(child.counts, child._shipped)
                    ]
                    d_count = child.count - child._shipped_count
                    if d_count <= 0 and not any(counts):
                        continue
                    out.append(
                        {
                            "name": name,
                            "help": vec.help,
                            "labels": dict(zip(vec.labelnames, key)),
                            "buckets": list(vec.buckets),
                            "counts": counts,
                            "sum": round(
                                child.sum - child._shipped_sum, 9
                            ),
                            "count": d_count,
                        }
                    )
                    child._shipped = list(child.counts)
                    child._shipped_sum = child.sum
                    child._shipped_count = child.count
        return out

    def requeue_deltas(self, deltas: list[dict]) -> None:
        """Return failed-to-ship deltas to the outbox, COMPACTED: deltas
        are additive, so records sharing (name, labels, buckets) merge
        into one. Without this, an hours-long scheduler outage would
        grow the outbox by one record per child per failed poll —
        unbounded, in violation of the no-silent-caps discipline every
        other bounded store here follows."""
        if not deltas:
            return
        with self._lock:
            merged: dict[tuple, dict] = {}
            for d in self._outbox + list(deltas):
                key = (
                    d["name"],
                    tuple(sorted((d.get("labels") or {}).items())),
                    tuple(d.get("buckets") or ()),
                )
                have = merged.get(key)
                if have is None:
                    merged[key] = dict(d, counts=list(d.get("counts") or []))
                    continue
                counts = have["counts"]
                for i, c in enumerate(d.get("counts") or []):
                    if i < len(counts):
                        counts[i] += c
                    else:
                        counts.append(c)
                have["sum"] = round(
                    have.get("sum", 0.0) + d.get("sum", 0.0), 9
                )
                have["count"] = have.get("count", 0) + d.get("count", 0)
            self._outbox = list(merged.values())



# Module-level registry: executor-process observations (task-run and
# shuffle-fetch-wait durations), served by --metrics-port and drained
# home on the poll/heartbeat RPCs. The scheduler's own registry is an
# instance attribute (SchedulerServer.hists) — see the module docstring.
REGISTRY = Registry("executor-process")


# -- wire conversion (HistogramDeltaP) --------------------------------------


def deltas_to_proto(deltas: list[dict]):
    from ballista_tpu_torch.proto import pb

    out = []
    for d in deltas:
        out.append(
            pb.HistogramDeltaP(
                name=d["name"],
                labels=[
                    pb.KeyValuePair(key=k, value=str(v))
                    for k, v in sorted((d.get("labels") or {}).items())
                ],
                le=list(d.get("buckets") or []),
                counts=[int(c) for c in (d.get("counts") or [])],
                sum=float(d.get("sum", 0.0)),
                count=int(d.get("count", 0)),
            )
        )
    return out
