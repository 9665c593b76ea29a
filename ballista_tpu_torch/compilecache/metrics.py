"""Process-wide cold-start counters (port of
``ballista_tpu/compilecache/metrics.py``):

- ``hints_loaded`` / ``hints_saved`` — the entries a ``HintStore`` merged
  from the hint file and the files it wrote (``compilecache.hints``);
- ``jit_cache_hits`` / ``jit_cache_misses`` — the shared callable cache
  (``compilecache.tracecache``), under the reference's names;
- ``prewarmed_signatures`` / ``prewarm_seconds`` / ``prewarm_failures`` —
  prewarm progress (``compilecache.prewarm``).

They ride an executor's poll and heartbeat into the scheduler's REST
``compile`` field (``executor.executor.compile_metrics``, beside the
nvcc build seconds of ``ops/cuda_build.build_seconds``). The reference's
jax counters (jaxpr traces, XLA compiles, the persistent compilation
cache) count events the port has no counterpart of.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()
_COUNTERS: dict[str, float] = {}


def add(name: str, value: float = 1) -> None:
    """Record a counter increment."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + value


def snapshot() -> dict[str, float]:
    """Current counters (floats rounded)."""
    with _LOCK:
        return {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in sorted(_COUNTERS.items())
        }


class delta:
    """Context manager capturing the counter delta across a block::

        with metrics.delta() as d:
            run_query()
        d.value["hints_loaded"]  # entries the block's first run merged
    """

    def __enter__(self) -> "delta":
        self._before = snapshot()
        self.value: dict[str, float] = {}
        return self

    def __exit__(self, *exc) -> bool:
        after = snapshot()
        self.value = {
            k: round(v - self._before.get(k, 0), 4)
            for k, v in after.items()
            if v != self._before.get(k, 0)
        }
        return False
