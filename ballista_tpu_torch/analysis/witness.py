"""Runtime lock-order witness (the dynamic half of ``racelint``).

The static lock-order graph (:mod:`ballista_tpu_torch.analysis.racelint`) proves
no *syntactically reachable* acquisition cycle exists; this module checks
the orders that are *actually taken* at runtime. Every control-plane lock
is created through :func:`make_lock`. In normal operation that returns a
plain ``threading.Lock``/``RLock`` — zero overhead, nothing recorded. In
debug mode (``BALLISTA_LOCK_WITNESS=1`` in the environment, or
:func:`enable` before the locks are constructed) it returns a
:class:`TracedLock` that

- keeps a per-thread stack of held lock names,
- records every ordered pair ``(held -> acquiring)`` into a global edge
  set, and
- flags an inversion the moment a thread acquires ``A`` while holding
  ``B`` after some thread acquired ``B`` while holding ``A`` (a runtime
  deadlock hazard even if the test run got lucky with timing).

Tests enable it around a cluster run, then assert
:func:`violations` is empty and :func:`assert_consistent` against the
static graph — witnessed orders must never invert a statically-derived
edge (a witnessed edge the static pass missed is reported too, as a
coverage gap, but only inversions fail).

Re-entrant re-acquisition of the same named lock never records an edge
(that is what RLock is for); the witness's own bookkeeping lock is plain
and its critical sections call no user code, so it cannot participate in
any cycle it reports.
"""

from __future__ import annotations

import logging
import os
import threading

log = logging.getLogger(__name__)

ENV_WITNESS = "BALLISTA_LOCK_WITNESS"

_enabled = os.environ.get(ENV_WITNESS, "") in ("1", "true", "yes")
_tls = threading.local()

_registry_lock = threading.Lock()
# (held_name, acquired_name) -> number of times witnessed
_edges: dict[tuple[str, str], int] = {}
# inversions observed live: (edge, reversed-edge-already-witnessed, thread)
_violations: list[dict] = []


def enable(flag: bool = True) -> None:
    """Turn the witness on/off for locks created AFTER this call."""
    global _enabled
    _enabled = flag


def enabled() -> bool:
    return _enabled


def _held_stack() -> list[str]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _has_path(src: str, dst: str, edges: set[tuple[str, str]]) -> bool:
    """DFS reachability src -> dst over the witnessed edge set."""
    seen = {src}
    frontier = [src]
    while frontier:
        node = frontier.pop()
        if node == dst:
            return True
        for a, b in edges:
            if a == node and b not in seen:
                seen.add(b)
                frontier.append(b)
    return False


class TracedLock:
    """Lock wrapper recording acquisition order per thread."""

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._record_acquired()
        return ok

    def release(self) -> None:
        stack = _held_stack()
        # releases are almost always LIFO; tolerate out-of-order by
        # dropping the LAST occurrence of this name
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                break
        self._lock.release()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def _record_acquired(self) -> None:
        stack = _held_stack()
        if self.name in stack:  # re-entrant: no new ordering established
            stack.append(self.name)
            return
        held = [n for n in dict.fromkeys(stack)]  # distinct, order kept
        stack.append(self.name)
        if not held:
            return
        with _registry_lock:
            snapshot = set(_edges)
            for h in held:
                edge = (h, self.name)
                first_time = edge not in _edges
                _edges[edge] = _edges.get(edge, 0) + 1
                if first_time and _has_path(self.name, h, snapshot):
                    v = {
                        "edge": edge,
                        "thread": threading.current_thread().name,
                        "held": list(held),
                    }
                    _violations.append(v)
                    log.error(
                        "lock-order inversion witnessed: %s -> %s "
                        "(thread %s, holding %s) — reverse order was "
                        "witnessed earlier", h, self.name, v["thread"], held,
                    )

    def locked(self) -> bool:
        return self._lock.locked() if hasattr(self._lock, "locked") else False


def make_lock(name: str, reentrant: bool = False):
    """Create a control-plane lock. ``name`` must be the racelint-qualified
    identity (``ClassName._lockfield`` or ``module._LOCK_GLOBAL``) so the
    witnessed graph and the static graph share a vocabulary."""
    if not _enabled:
        return threading.RLock() if reentrant else threading.Lock()
    return TracedLock(name, reentrant=reentrant)


def edges() -> dict[tuple[str, str], int]:
    with _registry_lock:
        return dict(_edges)


def violations() -> list[dict]:
    with _registry_lock:
        return list(_violations)


def reset() -> None:
    with _registry_lock:
        _edges.clear()
        _violations.clear()


def assert_consistent(static_edges) -> None:
    """Witnessed orders must not invert the static lock-order graph: for
    every witnessed edge ``A -> B``, the static graph must not contain a
    path ``B`` ⇝ ``A``. Witnessed edges absent from the static graph are
    allowed (the static pass is conservative about call resolution) but
    inversions are exactly the deadlocks the static gate exists to stop.
    Raises ``AssertionError`` naming the offending pair."""
    static = {(a, b) for a, b in static_edges}
    witnessed = edges()
    problems = []
    for a, b in witnessed:
        if _has_path(b, a, static):
            problems.append(
                f"witnessed {a} -> {b} but the static graph orders "
                f"{b} before {a}"
            )
    live = violations()
    for v in live:
        problems.append(
            f"runtime inversion: {v['edge'][0]} -> {v['edge'][1]} "
            f"(thread {v['thread']}, holding {v['held']})"
        )
    assert not problems, "; ".join(problems)
