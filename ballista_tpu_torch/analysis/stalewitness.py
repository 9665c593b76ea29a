"""Runtime staleness witness: cache coherence as a checkable invariant.

The static half (stalelint + the declared cache registry) proves the
TREE obeys the coherence contracts; this witness proves the RUNNING
SYSTEM does — the cache analogue of the lock, resource, and replay
witnesses. When enabled, instrumented caches record ``(cache, key,
content-hash-of-value, source-version)`` on every hit, and a SAMPLED
subset of hits must hash-match a fresh re-derivation:

- **result cache** (scheduler serve path): a sampled hit is demoted to a
  miss — the query runs fresh through the full stage machinery, and the
  committed repopulation (:meth:`SchedulerServer._populate_result_cache`)
  must produce the same canonical content hash the cached payload held
  (:func:`expect` at the demotion, :func:`resolve` at repopulation).
- **physical-plan cache** (TpuContext): a sampled hit re-plans the
  logical plan fresh and the structural render of the cached operator
  tree must match the fresh one (:func:`check` with both hashes).

A hash mismatch is a STALE HIT — recorded, counted per cache, and fatal
to :func:`assert_no_stale`. Like the other witnesses, "zero stale" must
never silently mean "zero checks": ``assert_no_stale`` demands a nonzero
check count by default.

One legitimate divergence is carved out: certified **multiset-exact**
rewrites (AQE) re-associate float folds, so a fresh re-derivation may
differ from the served payload in the final ULP of float aggregates
(docs/analysis.md "Exactness") while being byte-identical everywhere
else. The canonical hash is bit-exact and would misread that drift as
staleness, so the result-cache protocol carries the served payload:
on hash mismatch, :func:`resolve` falls back to a value-level
comparison (:func:`tables_equivalent` — exact for non-float columns,
relative tolerance for floats) before declaring a stale hit. A wrong
row, a missing row, or a drifted non-float value still fails.

Sampling is DETERMINISTIC (detlint: no RNG in the data plane): per-cache
hit counters sample the k-th hit whenever ``floor(k*rate)`` crosses an
integer boundary, so ``rate=1`` checks every hit (the test default) and
``rate=0.25`` checks every 4th, reproducibly.

Default OFF: ``BALLISTA_CACHE_WITNESS=1`` (or :func:`enable`) turns it
on; ``BALLISTA_CACHE_WITNESS_SAMPLE`` sets the rate. Exposed on
``/api/metrics`` as ``ballista_cache_witness_checks_total``
(obs/prometheus.py) so chaos/soak runs scrape coherence the same way
they scrape replay/reswitness state."""

from __future__ import annotations

import logging
import math
import os
import threading

ENV_WITNESS = "BALLISTA_CACHE_WITNESS"
ENV_SAMPLE = "BALLISTA_CACHE_WITNESS_SAMPLE"

log = logging.getLogger(__name__)

_enabled = os.environ.get(ENV_WITNESS, "") in ("1", "true", "yes")


def _env_rate() -> float:
    raw = os.environ.get(ENV_SAMPLE, "") or "1"
    try:
        rate = float(raw)
    except ValueError:
        return 1.0
    return min(1.0, max(0.0, rate))


_sample_rate = _env_rate()

_lock = threading.Lock()
_hits: dict[str, int] = {}  # lifetime hits observed per cache
_checks: dict[tuple[str, str], int] = {}  # (cache, match|stale) -> count
# (cache, key) -> (expected hash, served payload bytes | None)
_pending: dict[tuple[str, str], tuple[str, bytes | None]] = {}
_stale: list[dict] = []

# float drift tolerance for the value-level fallback compare: certified
# multiset-exact rewrites shift float sums by ~1e-15 relative (measured
# on q3); a genuinely stale value — one missing row of the sum — is
# orders of magnitude past this
FLOAT_REL_TOL = 1e-9


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = flag


def enabled() -> bool:
    return _enabled


def set_sample_rate(rate: float) -> None:
    global _sample_rate
    _sample_rate = min(1.0, max(0.0, rate))


def sample_rate() -> float:
    return _sample_rate


def should_sample(cache: str) -> bool:
    """Count one hit for ``cache``; True when this hit is in the sampled
    subset (deterministic — no RNG, reproducible across replays)."""
    if not _enabled:
        return False
    with _lock:
        n = _hits.get(cache, 0) + 1
        _hits[cache] = n
    rate = _sample_rate
    if rate <= 0.0:
        return False
    return math.floor(n * rate) > math.floor((n - 1) * rate)


def expect(
    cache: str, key, expected_hash: str, version=None, payload=None
) -> None:
    """Register the content hash a demoted (sampled) hit WOULD have
    served; the fresh re-derivation resolves it. ``payload`` (the served
    IPC bytes) enables the value-level fallback compare on hash
    mismatch — without it, any mismatch is stale."""
    with _lock:
        _pending[(cache, repr(key))] = (expected_hash, payload)


def tables_equivalent(served, fresh, rel_tol: float = FLOAT_REL_TOL) -> bool:
    """Value-level equivalence: identical schema/rows, non-float columns
    bit-exact, float columns within ``rel_tol`` relative — the drift
    envelope certified multiset-exact rewrites are allowed
    (docs/analysis.md "Exactness"). Rows are aligned by sorting on the
    non-float columns first, so a last-ULP float shift cannot shuffle
    the comparison."""
    import pyarrow as pa

    if served.schema != fresh.schema or served.num_rows != fresh.num_rows:
        return False
    float_cols = [
        f.name for f in served.schema if pa.types.is_floating(f.type)
    ]
    other = [f.name for f in served.schema if f.name not in float_cols]
    keys = [(n, "ascending") for n in other + float_cols]
    s = served.combine_chunks().sort_by(keys)
    f2 = fresh.combine_chunks().sort_by(keys)
    for name in other:
        if not s.column(name).equals(f2.column(name)):
            return False
    for name in float_cols:
        for x, y in zip(
            s.column(name).to_pylist(), f2.column(name).to_pylist()
        ):
            if x is None or y is None:
                if x is not y:
                    return False
            elif x != y and abs(x - y) > rel_tol * max(
                abs(x), abs(y), 1.0
            ):
                return False
    return True


def resolve(cache: str, key, actual_hash: str, version=None, table=None) -> None:
    """Compare a fresh re-derivation against a pending expectation for
    the same key. No pending expectation -> no check recorded (ordinary
    repopulation, nothing was served from cache). On hash mismatch,
    falls back to :func:`tables_equivalent` when the demotion carried
    the served payload and ``table`` is the fresh result."""
    with _lock:
        rec = _pending.pop((cache, repr(key)), None)
    if rec is None:
        return
    expected, payload = rec
    if expected != actual_hash and payload is not None and table is not None:
        try:
            from ballista_tpu_torch.scheduler.result_cache import ipc_to_table

            if tables_equivalent(ipc_to_table(payload), table):
                # certified float drift, not staleness: count the check
                # as a match by reusing the expected hash
                _record(cache, key, expected, expected, version)
                return
        except Exception:  # noqa: BLE001 — a broken fallback compare
            # must report as stale, never crash the serve path
            log.exception("stalewitness fallback compare failed")
    _record(cache, key, expected, actual_hash, version)


def check(
    cache: str, key, served_hash: str, fresh_hash: str, version=None
) -> None:
    """Direct compare for synchronous re-derivation sites (the cached
    value and the fresh one are both in hand)."""
    _record(cache, key, served_hash, fresh_hash, version)


def _record(cache, key, expected, got, version) -> None:
    outcome = "match" if expected == got else "stale"
    with _lock:
        k = (cache, outcome)
        _checks[k] = _checks.get(k, 0) + 1
        if outcome == "stale":
            _stale.append({
                "cache": cache,
                "key": repr(key),
                "expected": expected,
                "got": got,
                "version": repr(version),
            })
    if outcome == "stale":
        log.error(
            "cache witness STALE HIT in %s at %r: served %s, fresh %s",
            cache, key, expected, got,
        )


def counters() -> dict[tuple[str, str], int]:
    """(cache, outcome) -> count, for the prometheus family."""
    with _lock:
        return dict(_checks)


def hit_counts() -> dict[str, int]:
    with _lock:
        return dict(_hits)


def pending_count() -> int:
    """Demotions whose fresh run has not repopulated yet (a chaos test
    drains this to zero before asserting)."""
    with _lock:
        return len(_pending)


def stale_hits() -> list[dict]:
    with _lock:
        return [dict(s) for s in _stale]


def summary() -> str:
    cs = counters()
    total = sum(cs.values())
    stale = sum(n for (c, o), n in cs.items() if o == "stale")
    per = ", ".join(
        f"{c}:{o}={n}" for (c, o), n in sorted(cs.items())
    )
    return (
        f"{total} checks ({per or 'none'}), {stale} stale, "
        f"{pending_count()} pending"
    )


def assert_no_stale(require_checks: bool = True) -> None:
    """Zero stale hits (and, by default, a nonzero check count — a
    witness that saw no traffic proves nothing)."""
    bad = stale_hits()
    if bad:
        lines = [
            f"{s['cache']}[{s['key']}]: served {s['expected']}, "
            f"fresh {s['got']}"
            for s in bad
        ]
        raise AssertionError(
            f"{len(bad)} stale cache hits:\n" + "\n".join(lines)
        )
    if require_checks and not counters():
        raise AssertionError(
            "cache witness checked nothing — enable() before the run, "
            "or the instrumentation points were never reached"
        )


def reset() -> None:
    with _lock:
        _hits.clear()
        _checks.clear()
        _pending.clear()
        _stale.clear()
