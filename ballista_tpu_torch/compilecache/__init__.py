"""compilecache — the persisted half of cold start (port of the
reference's ``ballista_tpu/compilecache/``).

The reference's package attacks XLA compile latency (the kernel
vocabulary, AOT prewarm, the shared trace cache, jax's compile counters)
and persists learned plan-shape hints. The port compiles no XLA program:
its two CUDA kernels build once per checkout (``ops/cuda_build``), so the
hints and the plan-level program closure are ported:

- :mod:`hints` — persisted plan-shape hints (learned join strategies,
  decimal scales, the grown aggregate and join-expansion capacities), so a
  fresh process skips the capacity retries its first runs would pay;
- :mod:`metrics` — the hint counters (``hints_loaded``, ``hints_saved``);
- :mod:`registry` — each operator's declared device programs
  (``OPERATOR_KERNELS``, ``check_plan``), the certified rewrites'
  ``compile-vocab`` clause.

The capacity ladder lives with the batch type
(:mod:`ballista_tpu_torch.columnar.batch`).
"""

from ballista_tpu_torch.compilecache import hints, metrics, registry
from ballista_tpu_torch.compilecache.hints import HintStore

__all__ = ["HintStore", "hints", "metrics", "registry"]
