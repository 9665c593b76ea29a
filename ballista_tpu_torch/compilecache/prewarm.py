"""Kernel prewarm: run the device-program vocabulary once before the first
query needs it (port of ``ballista_tpu/compilecache/prewarm.py``).

The port compiles no XLA program. What a first use costs on the card is
the nvcc build and ctypes load of the hand-written kernels
(``ops/cuda_build``), the one-hot kernel's once-a-device shared-memory
limit, and CUDA's lazy loading of each torch kernel by op, dtype and size
class (torch's sort takes other code paths by size). Each signature of
``registry.enumerate_prewarm`` runs its public function once on zeros on
the prewarm's device at one capacity bucket, which pays those costs.

``ballista.tpu.prewarm`` (and, for executor processes, the
``BALLISTA_TPU_PREWARM`` env the server loops read at start):

- ``on`` — run every enumerated signature before returning; startup
  blocks until warm.
- ``background`` — run them on a pool of four threads named
  ``compile-prewarm`` while the process serves; queries that arrive
  mid-warm pay at most the programs not yet done. The pool is JOINED by
  ``ExecutorServer.stop`` / ``PollLoop.stop``.
- ``off`` — first uses pay on the query path (default).

The signatures launch on the current (default) stream of the device, the
one a query's work runs on: the allocator blocks they free go back to the
pool the queries draw from, and a query's kernels queue behind a
signature's at most. Each completed signature increments
``prewarmed_signatures`` and adds its wall time to ``prewarm_seconds``
(``compilecache.metrics``); a failed one is logged and counted in
``prewarm_failures``. A failure never reaches the query path, which
launches its kernels itself (or raises) whether prewarm ran or not. A
process-wide latch makes repeated prewarm requests (several contexts in
one process) free.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from ballista_tpu_torch.compilecache import metrics, registry

log = logging.getLogger(__name__)

_WORKERS = 4

_LATCH_LOCK = threading.Lock()
_STARTED: set[str] = set()  # (device, buckets) fingerprints warmed already


class PrewarmHandle:
    """A running (or finished) prewarm; ``join``/``stop`` are idempotent
    and safe from any thread."""

    def __init__(self, pool=None, futures=(), n_signatures: int = 0):
        from ballista_tpu_torch.analysis import reswitness

        self._pool = pool
        self._futures = list(futures)
        self.n_signatures = n_signatures
        self._witness_token = (
            reswitness.acquire("thread-pool", "compile-prewarm")
            if pool is not None
            else None
        )
        # a context-started background prewarm is never stopped or joined
        # (the pool drains on its own: start_prewarm shuts it down without
        # waiting right after the submits), so the witness entry also
        # releases itself when the LAST future completes; release() is
        # idempotent, so racing _shutdown() is harmless
        self._pending = len(self._futures)
        self._pending_lock = threading.Lock()
        if pool is not None and not self._futures:
            self._release_witness()
        for f in self._futures:
            f.add_done_callback(self._one_done)

    def _release_witness(self) -> None:
        from ballista_tpu_torch.analysis import reswitness

        reswitness.release(self._witness_token)

    def _one_done(self, _f) -> None:
        with self._pending_lock:
            self._pending -= 1
            drained = self._pending == 0
        if drained:
            self._release_witness()

    def join(self, timeout: float | None = None) -> bool:
        """Wait for completion; True when every signature finished."""
        import concurrent.futures as cf

        deadline = None if timeout is None else time.monotonic() + timeout
        for f in self._futures:
            left = None
            if deadline is not None:
                left = max(0.0, deadline - time.monotonic())
            try:
                f.result(timeout=left)
            except (cf.TimeoutError, TimeoutError):
                return False
            except cf.CancelledError:
                pass
            except Exception as e:  # noqa: BLE001
                # _run_one already logged the signature's failure; anything
                # else escaping a worker must not vanish
                log.debug("prewarm join: worker raised %s", e)
        self._shutdown(wait=True)
        return True

    def stop(self, timeout: float = 30.0) -> None:
        """Cancel queued signatures and join the pool threads (the
        shutdown path: running signatures finish, queued ones are
        dropped). If running ones outlast ``timeout``, the pool is left to
        drain on its own rather than hang the shutdown."""
        import concurrent.futures as cf

        for f in self._futures:
            f.cancel()
        deadline = time.monotonic() + timeout
        for f in self._futures:
            left = max(0.0, deadline - time.monotonic())
            try:
                f.result(timeout=left)
            except (cf.TimeoutError, TimeoutError):
                log.warning(
                    "prewarm stop: signatures still running after %.0fs; "
                    "leaving the pool to drain", timeout,
                )
                self._shutdown(wait=False)
                return
            except cf.CancelledError:
                pass
            except Exception as e:  # noqa: BLE001
                log.debug("prewarm stop: worker raised %s", e)
        self._shutdown(wait=True)

    def _cancel_queued(self) -> None:
        """atexit safety net: a caller that never stops its handle (a
        short-lived script's context) must not hang interpreter exit while
        the pool drains queued signatures; only running ones finish."""
        for f in self._futures:
            f.cancel()

    def _shutdown(self, wait: bool) -> None:
        import atexit

        atexit.unregister(self._cancel_queued)
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=wait, cancel_futures=not wait)
        self._release_witness()


_NOOP = PrewarmHandle()


def _run_one(sig) -> None:
    t0 = time.perf_counter()
    try:
        sig.compile()
    except Exception as e:  # noqa: BLE001 — prewarm is best-effort
        # a failed signature costs only its first use later; the query
        # path never depends on prewarm having succeeded
        log.warning("prewarm %s failed: %s", sig.key, e)
        metrics.add("prewarm_failures")
        return
    metrics.add("prewarmed_signatures")
    metrics.add("prewarm_seconds", time.perf_counter() - t0)


def prewarm_buckets_from_env(default: tuple[int, ...]) -> tuple[int, ...]:
    """BALLISTA_TPU_PREWARM_BUCKETS="2048,1048576" overrides the ladder
    enumeration: tests and constrained hosts bound the warm set."""
    spec = os.environ.get("BALLISTA_TPU_PREWARM_BUCKETS", "")
    if not spec:
        return default
    return tuple(int(s) for s in spec.split(",") if s.strip())


def start_prewarm(
    mode: str,
    max_rows: int | None = None,
    buckets: tuple[int, ...] | None = None,
    device="cuda",
) -> PrewarmHandle:
    """Start a prewarm per ``mode`` on ``device``; returns a handle (the
    no-op handle for ``off`` or a bucket set this process warmed already
    on that device). ``max_rows`` bounds the ladder enumeration (default:
    the configured batch row budget)."""
    if mode not in ("on", "background"):
        return _NOOP
    if buckets is None:
        from ballista_tpu_torch.columnar.batch import capacity_ladder
        from ballista_tpu_torch.config import BallistaConfig

        if max_rows is None:
            max_rows = BallistaConfig().tpu_batch_rows()
        buckets = capacity_ladder().buckets_upto(max_rows)
    buckets = prewarm_buckets_from_env(tuple(buckets))
    fingerprint = f"{device}:" + ",".join(str(b) for b in sorted(buckets))
    with _LATCH_LOCK:
        if fingerprint in _STARTED:
            return _NOOP
        _STARTED.add(fingerprint)
    try:
        sigs = registry.enumerate_prewarm(buckets, device=device)
    except BaseException:
        # roll the latch back: a failed enumeration (a bad bucket spec)
        # must not disable prewarm for this bucket set for good
        with _LATCH_LOCK:
            _STARTED.discard(fingerprint)
        raise
    log.info(
        "prewarm(%s) on %s: %d signatures over buckets %s",
        mode, device, len(sigs), list(buckets),
    )
    if mode == "on":
        t0 = time.perf_counter()
        for sig in sigs:
            _run_one(sig)
        log.info(
            "prewarm: %d signatures in %.1fs",
            len(sigs), time.perf_counter() - t0,
        )
        return PrewarmHandle(n_signatures=len(sigs))
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(
        max_workers=_WORKERS, thread_name_prefix="compile-prewarm"
    )
    futures = [pool.submit(_run_one, sig) for sig in sigs]
    # shut down without waiting right after the last submit: the threads
    # exit on their own once the queue drains, so a caller that never stops
    # the handle (a long-lived context) leaks no thread; handle.stop()
    # also cancels the queue and joins
    pool.shutdown(wait=False)
    handle = PrewarmHandle(pool, futures, n_signatures=len(sigs))
    # atexit runs before threading's join of the workers at exit, so an
    # unstopped handle drops its queued signatures instead of stalling
    # the exit behind them
    import atexit

    atexit.register(handle._cancel_queued)
    return handle


def resolve_mode(explicit: str | None) -> str:
    """Prewarm mode for an executor process, which has no session config
    at start: an explicit --prewarm flag wins, else the
    BALLISTA_TPU_PREWARM env, else off."""
    if explicit is not None:
        return explicit
    return os.environ.get("BALLISTA_TPU_PREWARM", "off")


def start_server_prewarm(mode: str, device="cuda") -> PrewarmHandle:
    """The executor loops' start sequence (PollLoop.start /
    ExecutorServer.startup): the configured prewarm on the executor's
    device. A deployment with a non-default ladder sets
    BALLISTA_TPU_CAPACITY_BUCKETS beside BALLISTA_TPU_PREWARM: the session
    config arrives only with the first task, after prewarm has enumerated
    its buckets."""
    spec = os.environ.get("BALLISTA_TPU_CAPACITY_BUCKETS")
    if spec:
        from ballista_tpu_torch.columnar.batch import set_capacity_buckets

        set_capacity_buckets(spec)
    return start_prewarm(mode, device=device)


def reset_latch() -> None:
    """Test hook: allow the same bucket set to prewarm again."""
    with _LATCH_LOCK:
        _STARTED.clear()
