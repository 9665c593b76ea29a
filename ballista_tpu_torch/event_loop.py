"""Generic event loop: a single-writer actor over a queue.

ref ballista/rust/core/src/event_loop.rs:27-141 — ``EventAction<E>`` trait
{on_start, on_stop, on_receive -> Option<E>}, buffer 10000, self-reposting.
Thread-based here (the gRPC servicers are thread-driven); the single
consumer thread gives the same data-race freedom the reference gets from
the tokio mpsc single-receiver.

Full-queue discipline (racelint blocking-under-lock / self-deadlock):
producers on FOREIGN threads block on the bounded queue (backpressure).
The CONSUMER thread must never block on its own queue — nothing else
drains it — so events it posts (handler posts, on_receive follow-ups)
spill into an unbounded overflow deque drained before the next queue
get. Nothing is ever dropped: a dropped terminal event (``JobFailed``)
would wedge its job in "running" forever.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading

log = logging.getLogger(__name__)

_BUFFER = 10000


class EventAction:
    """ref event_loop.rs EventAction trait."""

    def on_start(self) -> None:
        pass

    def on_stop(self) -> None:
        pass

    def on_receive(self, event) -> object | None:
        """Handle one event; optionally return a follow-up event to post."""
        raise NotImplementedError

    def on_error(self, error: BaseException) -> None:
        log.error("event loop error: %s", error, exc_info=error)


class _Timed:
    """Post-time envelope for dispatch-lag measurement (only when a
    ``lag_cb`` is installed). A dedicated class, not a tuple: tests and
    embedders inject raw events straight into the queue, and raw tuples
    must keep flowing through untouched."""

    __slots__ = ("posted", "event")

    def __init__(self, posted: float, event) -> None:
        self.posted = posted
        self.event = event


class EventLoop:
    def __init__(self, name: str, action: EventAction):
        self.name = name
        self.action = action
        # observability hook (docs/observability.md): when set, every
        # consumed event reports (now - post time) seconds — the
        # scheduler feeds this into the ballista_event_dispatch_lag_seconds
        # histogram, the direct measure of control-plane saturation
        self.lag_cb = None
        self._q: queue.Queue = queue.Queue(maxsize=_BUFFER)
        # consumer-thread posts that found the queue full; only the
        # consumer thread itself appends/pops, so no lock is needed
        self._overflow: collections.deque = collections.deque()
        # True while the consumer is INSIDE a handler for an
        # overflow-sourced event — such events are counted by neither
        # unfinished_tasks nor _overflow, and drain() must not return
        # while one is mid-flight
        self._overflow_busy = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self.action.on_start()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"event-loop-{self.name}"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # non-blocking wake-up: a blocking put() deadlocked here whenever
        # the bounded queue was full at shutdown (the consumer may already
        # have observed _stop and exited, so nothing ever drains the queue).
        # If the queue is full the sentinel is unnecessary anyway — _run's
        # timed get() observes _stop within one tick.
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.action.on_stop()

    def post(self, event) -> None:
        """Enqueue an event. Foreign threads block when the queue is full
        (backpressure against producers). The CONSUMER thread itself —
        handlers posting follow-on events — must never block (a
        guaranteed self-deadlock: nothing else drains the queue), so its
        posts spill to the unbounded overflow deque instead; terminal
        events like JobFailed are never dropped."""
        if self.lag_cb is not None:
            import time

            event = _Timed(time.monotonic(), event)
        if threading.current_thread() is self._thread:
            try:
                self._q.put_nowait(event)
            except queue.Full:
                self._overflow.append(event)
            return
        self._q.put(event)

    def depth(self) -> int:
        """Events waiting (bounded queue + consumer overflow) — the
        backpressure signal the /api/metrics plane exposes as
        ``ballista_event_queue_depth`` (docs/observability.md)."""
        return self._q.qsize() + len(self._overflow)

    def drain(self, timeout: float = 5.0) -> None:
        """Wait until the queue is empty and the worker is idle (tests)."""
        import time

        deadline = time.time() + timeout
        while time.time() < deadline:
            if (
                self._q.unfinished_tasks == 0
                and not self._overflow
                and not self._overflow_busy
            ):
                return
            time.sleep(0.01)

    def _run(self) -> None:
        while not self._stop.is_set():
            from_queue = False
            if self._overflow:
                self._overflow_busy = True
                event = self._overflow.popleft()
            else:
                # timed get: honor _stop between events even when no
                # sentinel ever arrives (stop() with a full queue cannot
                # enqueue one)
                try:
                    event = self._q.get(timeout=0.2)
                except queue.Empty:
                    continue
                from_queue = True
            try:
                if event is None:
                    continue
                if isinstance(event, _Timed):
                    cb = self.lag_cb
                    if cb is not None:
                        import time

                        try:
                            cb(time.monotonic() - event.posted)
                        except Exception:  # noqa: BLE001 — metering must
                            # never take the consumer down
                            log.exception("event-loop lag callback failed")
                    event = event.event
                try:
                    follow_up = self.action.on_receive(event)
                except Exception as e:  # noqa: BLE001
                    self.action.on_error(e)
                    follow_up = None
                if follow_up is not None:
                    # never block the consumer on its own full queue (a
                    # self-deadlock: nothing else drains it); overflow
                    # keeps the follow-up instead of dropping it
                    try:
                        self._q.put_nowait(follow_up)
                    except queue.Full:
                        self._overflow.append(follow_up)
            finally:
                if from_queue:
                    self._q.task_done()
                else:
                    self._overflow_busy = False
