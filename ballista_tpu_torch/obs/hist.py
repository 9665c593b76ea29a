"""Mergeable, thread-safe, log-bucketed histograms: the fleet-level
latency plane (port of ``ballista_tpu/obs/hist.py``,
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

``Registry.ingest`` merges shipped deltas into a registry: the
scheduler keeps an INSTANCE registry (its own latency observations plus
everything executors ship), distinct from the module-level one, so an
in-process standalone cluster never counts a shipped observation twice.
``Histogram.quantile`` interpolates inside the landing bucket.

Exposition: :meth:`Registry.families` returns Prometheus ``histogram``
families (``_bucket``/``_sum``/``_count`` with cumulative ``le``
samples) in the 3-tuple sample shape ``obs.prometheus.render``
understands.
"""

from __future__ import annotations

import bisect
import math

from ballista_tpu_torch.analysis.witness import make_lock

# Log-spaced (ratio-2) seconds ladder: 1ms .. ~1048s then +Inf. Covers a
# sub-millisecond dispatch lag and a 15-minute straggler in one family;
# 21 buckets keeps the per-series exposition and wire-delta cost small.
DEFAULT_BUCKETS: tuple[float, ...] = tuple(
    0.001 * (2.0 ** i) for i in range(21)
)


def format_le(le: float) -> str:
    """Prometheus ``le`` label text: finite bounds via %g, +Inf spelled
    the way every scraper expects."""
    if math.isinf(le):
        return "+Inf"
    return f"{le:g}"


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

    def merge(self, counts, total_sum: float, total_count: int) -> None:
        """Add per-bucket (non-cumulative) deltas — the ingest path.
        Extra trailing counts (a caller with MORE buckets than this
        child) fold into the +Inf slot rather than vanishing: dropping
        them while still adding ``total_count`` would leave cumulative
        buckets that never reach ``_count`` — silently corrupt
        quantiles. Registry.ingest rejects layout mismatches up front;
        this is the defensive floor for direct callers."""
        with self._lock:
            last = len(self.counts) - 1
            for i, c in enumerate(counts):
                self.counts[min(i, last)] += int(c)
            self.sum += float(total_sum)
            self.count += int(total_count)

    def snapshot(self) -> tuple[list[int], float, int]:
        with self._lock:
            return list(self.counts), self.sum, self.count

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1) with linear interpolation inside
        the landing bucket; 0.0 with no observations. The +Inf bucket
        clamps to the top finite bound (nothing better is knowable)."""
        counts, _s, total = self.snapshot()
        if total <= 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            prev_cum = cum
            cum += c
            if cum >= rank:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * frac
        return self.buckets[-1]

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

    # -- exposition ----------------------------------------------------------
    def families(self) -> list[tuple]:
        """Prometheus ``histogram`` families in the 3-tuple sample shape
        of obs.prometheus.render: (suffix, labels, value) with cumulative
        ``le`` buckets in ascending order."""
        out: list[tuple] = []
        with self._lock:
            vecs = sorted(self._vecs.items())
        for name, vec in vecs:
            samples: list[tuple] = []
            for key, child in vec.children():
                labels = dict(zip(vec.labelnames, key))
                counts, total_sum, total_count = child.snapshot()
                cum = 0
                for i, le in enumerate(vec.buckets):
                    cum += counts[i]
                    samples.append(
                        ("_bucket", {**labels, "le": format_le(le)}, cum)
                    )
                samples.append(
                    ("_bucket", {**labels, "le": "+Inf"}, total_count)
                )
                samples.append(("_sum", labels, round(total_sum, 6)))
                samples.append(("_count", labels, total_count))
            if samples:
                out.append((name, "histogram", vec.help or name, samples))
        return out

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



    def ingest(self, deltas: list[dict]) -> None:
        """Merge shipped deltas (the scheduler side of the seam). Unknown
        families are created with the delta's bounds and label names; a
        delta whose bucket layout disagrees with the registered family
        (a version-skewed executor after a ladder change) raises rather
        than merging counts into the wrong bounds — the caller
        (SchedulerServer.ingest_hists) drops the batch LOUDLY."""
        # two-phase so the batch is all-or-nothing: resolve + validate
        # EVERY record before merging ANY — a mid-batch mismatch must
        # not leave earlier records merged while the caller logs the
        # whole batch as dropped
        resolved = []
        for d in deltas:
            labels = dict(d.get("labels") or {})
            buckets = tuple(d.get("buckets") or DEFAULT_BUCKETS)
            vec = self.histogram(
                d["name"],
                d.get("help") or d["name"],
                tuple(sorted(labels)),
                buckets,
            )
            if vec.buckets != buckets:
                raise ValueError(
                    f"{d['name']}: shipped bucket layout "
                    f"({len(buckets)} bounds) != registered "
                    f"({len(vec.buckets)}) — version-skewed sender?"
                )
            resolved.append(
                (vec.labels(*[labels[k] for k in sorted(labels)]), d)
            )
        for child, d in resolved:
            child.merge(
                d.get("counts") or [], d.get("sum", 0.0),
                d.get("count", 0),
            )

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


def deltas_from_proto(protos) -> list[dict]:
    return [
        {
            "name": p.name,
            "labels": {kv.key: kv.value for kv in p.labels},
            "buckets": list(p.le),
            "counts": list(p.counts),
            "sum": p.sum,
            "count": p.count,
        }
        for p in protos
    ]


def quantile_from_cumulative(pairs: list[tuple[float, float]], q: float) -> float:
    """Quantile estimate from scraped ``_bucket`` samples:
    ``pairs = [(le, cumulative_count), ...]`` (any order; +Inf as
    ``math.inf``), e.g. p50 and p99 from ``/api/metrics`` text. The same
    interpolation as :meth:`Histogram.quantile`, so that in-process and
    scraped answers agree."""
    pts = sorted(pairs)
    if not pts:
        return 0.0
    total = pts[-1][1]
    if total <= 0:
        return 0.0
    rank = q * total
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in pts:
        if cum >= rank:
            if math.isinf(le):
                return prev_le
            span = cum - prev_cum
            frac = (rank - prev_cum) / span if span > 0 else 1.0
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = le, cum
    return prev_le
