"""Runtime resource witness (the dynamic half of ``lifelint``).

lifelint proves statically that every *syntactic* acquisition has a
provable owner; this module checks what actually happens at runtime: the
tracked acquisition sites (gRPC channels, pooled Flight clients, thread
pools, spill managers, shuffle-fetch queues, served/mapped shuffle
files) register on acquire and deregister on release, and a clean
shutdown must leave **zero live tracked resources** — the resource
analogue of the lock-order witness (``witness.py``) and a zero-thread-leak audit.

Default OFF: every instrumentation point is a single module-flag check
(``BALLISTA_RESOURCE_WITNESS=1`` in the environment, or :func:`enable`
before the resources are created). When on, each acquisition records
kind, name, owning thread, and the creation stack (trimmed), so a leak
report names the exact dial/open site instead of "something leaked".

Intended use (tests/test_shutdown_hygiene.py, tests/test_reswitness_chaos.py):

    reswitness.enable()
    ... start cluster, run queries, kill executors, stop cluster ...
    reswitness.assert_drained()   # names every still-live resource

Ownership-transfer notes: a pooled Flight client EVICTED after a
transport error is deliberately handed to GC (other threads may be
mid-stream on it — closing would break them), so eviction releases its
witness entry; the eviction is the ownership decision being witnessed.
"""

from __future__ import annotations

import itertools
import os
import threading
import traceback

ENV_WITNESS = "BALLISTA_RESOURCE_WITNESS"

_enabled = os.environ.get(ENV_WITNESS, "") in ("1", "true", "yes")

_lock = threading.Lock()
_live: dict[int, dict] = {}
_token = itertools.count(1)
# lifetime acquire counts per kind (diagnostics: proves the witness saw
# traffic, so "zero live" cannot silently mean "zero tracked")
_acquired: dict[str, int] = {}


def enable(flag: bool = True) -> None:
    """Turn the witness on/off for acquisitions AFTER this call."""
    global _enabled
    _enabled = flag


def enabled() -> bool:
    return _enabled


def acquire(kind: str, name: str):
    """Register a live resource; returns an opaque token to pass to
    :func:`release` (None when the witness is off — release tolerates
    it, so call sites stay one-liners)."""
    if not _enabled:
        return None
    tok = next(_token)
    entry = {
        "kind": kind,
        "name": name,
        "thread": threading.current_thread().name,
        # drop the acquire()/instrumentation frames, keep the caller's
        "stack": "".join(traceback.format_stack(limit=8)[:-1]),
    }
    with _lock:
        _live[tok] = entry
        _acquired[kind] = _acquired.get(kind, 0) + 1
    return tok


def release(token) -> None:
    """Deregister; tolerates None tokens and double-release (a close()
    called twice must not crash the witness)."""
    if token is None:
        return
    with _lock:
        _live.pop(token, None)


def live() -> list[dict]:
    with _lock:
        return [dict(v) for v in _live.values()]


def acquired_counts() -> dict[str, int]:
    with _lock:
        return dict(_acquired)


def summary() -> str:
    entries = live()
    counts = acquired_counts()
    if not entries:
        return (
            "0 live tracked resources ("
            + ", ".join(f"{k}:{n}" for k, n in sorted(counts.items()))
            + " acquired over lifetime)"
        )
    lines = [f"{len(entries)} LIVE tracked resources:"]
    for e in entries:
        lines.append(f"  {e['kind']} {e['name']} (thread {e['thread']})")
    return "\n".join(lines)


def assert_drained() -> None:
    """Zero live tracked resources, or an AssertionError naming each
    leak with its creation stack."""
    entries = live()
    if not entries:
        return
    lines = []
    for e in entries:
        lines.append(
            f"{e['kind']} {e['name']} acquired on thread "
            f"{e['thread']}:\n{e['stack']}"
        )
    raise AssertionError(
        f"{len(entries)} tracked resources still live at shutdown:\n"
        + "\n".join(lines)
    )


def reset() -> None:
    with _lock:
        _live.clear()
        _acquired.clear()
