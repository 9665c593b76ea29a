"""Process-wide counters of the persisted hints (port of the hint
counters of ``ballista_tpu/compilecache/metrics.py``).

``hints_loaded`` counts the entries a ``HintStore`` merged from the hint
file, ``hints_saved`` the files it wrote. The reference's other counters
(jaxpr traces, XLA compiles, the persistent compilation cache, prewarm)
count jax events that have no counterpart in the port; the port's build
seconds are ``ops/cuda_build.build_seconds``.
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
