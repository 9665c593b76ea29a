"""compilecache — cold start (port of the reference's
``ballista_tpu/compilecache/``).

The reference's package attacks XLA compile latency and persists learned
plan-shape hints. The port compiles no XLA program: its first-use costs
are the three CUDA kernels' build and load (``ops/cuda_build``), the
one-hot kernel's once-a-device shared-memory limit and CUDA's lazy
loading of torch's kernels. The package:

- :mod:`registry` — the device-program vocabulary closed over the source
  (``PROGRAMS``, ``HOST_ONLY``, ``check_vocabulary``), each operator's
  declared programs (``OPERATOR_KERNELS``, ``check_plan``: the certified
  rewrites' ``compile-vocab`` clause), and the prewarm's signatures
  (``enumerate_prewarm``);
- :mod:`prewarm` — runs the vocabulary at context/executor start
  (``ballista.tpu.prewarm`` on/off/background);
- :mod:`tracecache` — process-wide sharing of the callables operators
  build from their plans, keyed by canonical plan signature and device
  (fresh per-task plan instances stop rebuilding them);
- :mod:`metrics` — the hint, callable-cache and prewarm counters,
  surfaced via executor heartbeats and the scheduler REST state;
- :mod:`hints` — persisted plan-shape hints (learned join strategies,
  decimal scales, the grown aggregate and join-expansion capacities), so a
  fresh process skips the capacity retries its first runs would pay.

The capacity ladder lives with the batch type
(:mod:`ballista_tpu_torch.columnar.batch`); prewarm enumerates over it.

The package imports none of its modules, and must not: callers import
the one they use (``from ballista_tpu_torch.compilecache import metrics``).
A module that imports ``metrics`` through the package while the package
imports that module is a cycle, which threads importing at once (the
analysis gate's analyzers) turn into an ImportError of a partially
initialized module (``tests/test_torch_tracecache.py``).
"""
