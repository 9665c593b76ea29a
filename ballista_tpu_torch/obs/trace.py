"""Distributed tracing: spans over the query's whole distributed life.

A ``trace_id`` is minted at job submission (scheduler-side, only when the
session's ``ballista.tpu.trace`` is not ``off``) and propagated exactly
like ``ballista.internal.task_attempt``: through task props to executors,
and through Flight ticket settings to the serving data plane. Every
participant records **finished spans** — (trace_id, span_id, parent_id,
name, start/end unix seconds, status, attrs) — into a bounded in-process
ring; executor processes additionally stage them in an outbox that the
poll/heartbeat/status RPCs drain home, where the scheduler reassembles
the per-job span tree (submit -> stage -> task attempt -> fetch/spill).

Overhead discipline (the acceptance bar: tracing off costs NOTHING):
span creation happens only under an active trace context — ambient
(thread-local, established by an enclosing span) or explicit (a task
prop). With ``ballista.tpu.trace=off`` no trace_id is ever minted, so
:func:`span` takes the first-line early-out and allocates nothing.

JSONL export: :func:`configure` with a path makes every recorded span
append one JSON line there (``ballista.tpu.trace=<path>``); ``on`` keeps
spans in the ring only. The ring is the debugging surface
(:func:`snapshot`); chaos tests assert span-tree SHAPE from the
scheduler-side store (docs/observability.md).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import threading
import time
import uuid

from ballista_tpu_torch.analysis.witness import make_lock

# Bounded stores: tracing must never become a memory leak on a long-lived
# daemon. The ring is a debugging window, not a database; the outbox holds
# spans between poll ticks (~100ms pull / per-status push), so thousands
# of slots is already generous.
_RING_CAP = 8192
_OUTBOX_CAP = 4096

_LOCK = make_lock("obs.trace._LOCK")
_RING: collections.deque = collections.deque(maxlen=_RING_CAP)
_OUTBOX: collections.deque = collections.deque(maxlen=_OUTBOX_CAP)
_MODE: str = "off"  # JSONL export: "off" | "on" | <path>
_SHIP: bool = False  # executor processes stage spans for RPC shipping
# No-silent-caps (docs/analysis.md): both bounded stores count what they
# evict, surfaced as ballista_spans_dropped_total{buffer=...}. The two
# buffers mean different things: buffer="outbox" is REAL loss (a span
# evicted before it shipped) and must stay 0 on a healthy deployment;
# buffer="ring" is the debugging window rotating — expected once a
# traced process records more than _RING_CAP spans, alert-worthy only
# if you expected the window to hold everything. The SLO harness runs
# untraced, so it asserts the combined total is 0.
_DROPPED: dict[str, int] = {"ring": 0, "outbox": 0}

_TLS = threading.local()


@dataclasses.dataclass
class Span:
    """One finished span (the unit that crosses the wire as SpanP)."""

    trace_id: str
    span_id: str
    parent_id: str
    name: str
    start_s: float
    end_s: float = 0.0
    outcome: str = "ok"  # "ok" | "error" (wire field name: status)
    attrs: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(
            {
                "trace_id": self.trace_id,
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                "name": self.name,
                "start_s": round(self.start_s, 6),
                "end_s": round(self.end_s, 6),
                "status": self.outcome,
                "attrs": {k: str(v) for k, v in self.attrs.items()},
            },
            sort_keys=True,
        )


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def configure(mode: str) -> None:
    """Set the JSONL export mode (``ballista.tpu.trace``): ``off``/``on``
    keep spans in the ring only; anything else is an append path."""
    global _MODE
    with _LOCK:
        _MODE = mode or "off"


def enable_shipping(flag: bool = True) -> None:
    """Executor processes stage every recorded span in the outbox so the
    task loops can ship them home on poll/heartbeat/status RPCs."""
    global _SHIP
    with _LOCK:
        _SHIP = flag


def record(span: Span) -> None:
    with _LOCK:
        if len(_RING) == _RING_CAP:
            _DROPPED["ring"] += 1
        _RING.append(span)
        if _SHIP:
            if len(_OUTBOX) == _OUTBOX_CAP:
                _DROPPED["outbox"] += 1
            _OUTBOX.append(span)
        mode = _MODE
    if mode not in ("off", "on"):
        # OUTSIDE the lock (file IO under a lock is the racelint
        # blocking-under-lock shape). One whole line per open-append-close:
        # O_APPEND writes of a short buffered line land as a single write,
        # so concurrent recorders cannot interleave half-lines.
        line = span.to_json() + "\n"
        try:
            with open(mode, "a") as f:
                f.write(line)
        except OSError:
            # an unwritable export path must never fail the query; the
            # ring still holds the span
            pass


def snapshot() -> list[Span]:
    """Ring contents, oldest first (debugging / tests)."""
    with _LOCK:
        return list(_RING)


def ring_size() -> int:
    """O(1) ring depth (the metrics-plane gauge — scrapes must not copy
    8k spans per poll just to count them)."""
    with _LOCK:
        return len(_RING)


def dropped() -> dict[str, int]:
    """Spans evicted from the bounded stores, by buffer (the
    ``ballista_spans_dropped_total`` series)."""
    with _LOCK:
        return dict(_DROPPED)


def clear() -> None:
    """Drop ring + outbox + drop counters (test isolation)."""
    with _LOCK:
        _RING.clear()
        _OUTBOX.clear()
        _DROPPED["ring"] = 0
        _DROPPED["outbox"] = 0


def drain_outbox() -> list[Span]:
    """Take every staged span (the RPC shipping path). A failed RPC should
    :func:`requeue_outbox` what it drained — spans are shipped exactly
    once, like task statuses."""
    with _LOCK:
        out = list(_OUTBOX)
        _OUTBOX.clear()
    return out


def requeue_outbox(spans: list[Span]) -> None:
    with _LOCK:
        # re-queue at the FRONT so ordering survives a poll failure; a
        # full outbox evicts from the BACK (the newest staged spans) —
        # counted, like every bounded-store eviction here
        overflow = len(_OUTBOX) + len(spans) - _OUTBOX_CAP
        if overflow > 0:
            _DROPPED["outbox"] += overflow
        _OUTBOX.extendleft(reversed(spans))


# ---------------------------------------------------------------------------
# ambient context + recording helpers
# ---------------------------------------------------------------------------


def current() -> tuple[str, str] | None:
    """The active ``(trace_id, span_id)`` on this thread, or None."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


def _push(ctx: tuple[str, str]) -> None:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append(ctx)


def _pop() -> None:
    _TLS.stack.pop()


@contextlib.contextmanager
def span(
    name: str,
    trace_id: str | None = None,
    parent_id: str | None = None,
    attrs: dict | None = None,
):
    """Record a span around a block. With no explicit ``trace_id`` and no
    ambient context this is a NO-OP (the tracing-off fast path: one
    attribute read, no allocation). The span becomes the ambient context
    for the block, so nested spans parent correctly; an escaping
    exception marks ``status="error"`` (type name in attrs) and
    re-raises. Yields the live Span (or None when inactive) so callers
    can add attrs discovered mid-block."""
    if trace_id is None:
        ctx = current()
        if ctx is None:
            yield None
            return
        trace_id, parent = ctx
        if parent_id is None:
            parent_id = parent
    s = Span(
        trace_id=trace_id,
        span_id=new_span_id(),
        parent_id=parent_id or "",
        name=name,
        start_s=time.time(),
        attrs=dict(attrs or {}),
    )
    _push((trace_id, s.span_id))
    try:
        yield s
    except BaseException as e:
        s.outcome = "error"
        s.attrs.setdefault("error", type(e).__name__)
        raise
    finally:
        _pop()
        s.end_s = time.time()
        record(s)


def event(
    name: str,
    trace_id: str | None = None,
    parent_id: str | None = None,
    attrs: dict | None = None,
) -> Span | None:
    """A zero-duration span (point event). Same activation rule as
    :func:`span`: without an explicit or ambient trace this is a no-op."""
    if trace_id is None:
        ctx = current()
        if ctx is None:
            return None
        trace_id, parent = ctx
        if parent_id is None:
            parent_id = parent
    now = time.time()
    s = Span(
        trace_id=trace_id,
        span_id=new_span_id(),
        parent_id=parent_id or "",
        name=name,
        start_s=now,
        end_s=now,
        attrs=dict(attrs or {}),
    )
    record(s)
    return s


def start(
    name: str, trace_id: str, parent_id: str = "", attrs: dict | None = None
) -> Span:
    """Open a span explicitly (non-lexical lifetimes: the scheduler's
    stage spans open at submission and close at completion, on different
    threads). Not recorded until :func:`finish`."""
    return Span(
        trace_id=trace_id,
        span_id=new_span_id(),
        parent_id=parent_id,
        name=name,
        start_s=time.time(),
        attrs=dict(attrs or {}),
    )


def finish(s: Span, outcome: str = "ok") -> Span:
    s.end_s = time.time()
    s.outcome = outcome
    record(s)
    return s


# ---------------------------------------------------------------------------
# wire conversion (SpanP)
# ---------------------------------------------------------------------------


def span_to_proto(s: Span):
    from ballista_tpu_torch.proto import pb

    return pb.SpanP(
        trace_id=s.trace_id,
        span_id=s.span_id,
        parent_id=s.parent_id,
        name=s.name,
        start_s=s.start_s,
        end_s=s.end_s,
        status=s.outcome,
        attrs=[
            pb.KeyValuePair(key=k, value=str(v))
            for k, v in sorted(s.attrs.items())
        ],
    )
