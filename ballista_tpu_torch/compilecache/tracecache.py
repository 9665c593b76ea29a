"""Process-wide callable cache keyed by canonical signature (port of
``ballista_tpu/compilecache/tracecache.py``).

The distributed executor decodes a FRESH plan-instance tree for every
task, so the callables an operator builds from its plan (the Filter and
Projection chain's compiled expressions, a join's residual filter, the
scalar aggregate's state and final programs) were built again on every
attempt and every repeated query. Operators now build them through
:func:`shared_callable`, keyed by the canonical signature of everything
the closure reads (expression trees via ``Expr._key()``, schemas, join
kinds) and the device it runs on: two plan instances with the same
signature on the same device get the SAME callable. The port's closures
are eager torch, so a shared one only saves the build (an expression
compile walks the whole tree); the device is in the key all the same, so
a CPU context and a card context never share one. A compiled expression
also captures the body of each UDF it calls, so every key is extended
with the UDF table's generation (``plugin.UdfRegistry.generation``): a
UDF registered again, or a cleared table, builds anew.

Bounded LRU: a long-lived executor serves many jobs; evicting a callable
costs at most one rebuild.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

from ballista_tpu_torch.compilecache import metrics
from ballista_tpu_torch.plugin import global_registry

_LOCK = threading.Lock()
_CACHE: OrderedDict = OrderedDict()
_MAX_ENTRIES = 1024


def shared_callable(key: tuple, build: Callable[[], Callable]) -> Callable:
    """The cached callable for ``key``, building it via ``build()`` on a
    miss. ``key`` must capture every plan-derived value the built closure
    bakes in, and the device it runs on; the UDF table's generation is
    added here."""
    key = key + (("udfs", global_registry.generation()),)
    with _LOCK:
        fn = _CACHE.get(key)
        if fn is not None:
            _CACHE.move_to_end(key)
            metrics.add("jit_cache_hits")
            return fn
    # build OUTSIDE the lock: a slow build must not stall every other
    # operator's lookup. A same-key race builds twice and keeps the first
    # stored callable.
    fn = build()
    with _LOCK:
        stored = _CACHE.get(key)
        if stored is not None:
            metrics.add("jit_cache_hits")
            return stored
        metrics.add("jit_cache_misses")
        _CACHE[key] = fn
        while len(_CACHE) > _MAX_ENTRIES:
            _CACHE.popitem(last=False)
    # a miss is one point event on the ambient task/query span (a no-op
    # when the session does not trace), outside the lock
    from ballista_tpu_torch.obs import trace as obs_trace

    obs_trace.event(
        "trace_cache_miss",
        attrs={
            "key": str(key[0]) if isinstance(key, tuple) and key
            else str(key)
        },
    )
    return fn


def expr_key(e) -> tuple | None:
    """Canonical hashable key for a logical expression (or None).
    ``Expr.__eq__`` is builder sugar, so keys go through the structural
    ``_key()`` the optimizer uses."""
    if e is None:
        return None
    return (type(e).__name__, e._key())


def schema_key(schema) -> tuple:
    """Canonical hashable key for a Schema (name/dtype/nullability)."""
    return tuple((f.name, f.dtype.value, f.nullable) for f in schema)


def cache_len() -> int:
    with _LOCK:
        return len(_CACHE)


def clear() -> None:
    """Test hook: drop every shared callable (counters are unaffected)."""
    with _LOCK:
        _CACHE.clear()
