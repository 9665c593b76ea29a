"""Runtime replay witness: bit-exactness as a checkable invariant.

The fault-tolerance story promises "bit-exact under fault injection"
(docs/fault_tolerance.md), and the certified-rewrite API promises
semantics preservation (``ballista_tpu_torch/rewrite.py``) — but until now both
were only ASSERTED by individual chaos tests comparing final tables.
This witness turns the promise into a first-class runtime invariant, the
replay analogue of the lock witness and the resource witness:

- every COMMITTED ``(job, stage, map task, output partition)`` shuffle
  output records a content hash at the producing executor
  (``Executor.execute_shuffle_write``), and
- every final result partition records one at the client fetch
  (``_fetch_results``).

Recording the same key twice — a bounded task retry, a lineage recompute
after an executor kill, eager-vs-barriered consumption feeding the same
downstream stage, a certified rewrite re-running a stage — must produce
the identical hash; a differing hash is a MISMATCH the test harness
fails on (:func:`assert_clean`).

Hashing is **canonical**: the partition's batches are concatenated,
sorted by every column, and serialized through uncompressed Arrow IPC
before hashing. That makes the hash invariant under the re-orderings
that are legitimately allowed to differ (batch boundaries, IPC
compression codec, fetch concurrency, row order permuted by a certified
rewrite such as a build-side flip) while any value-level divergence —
lost rows, duplicated rows, last-ULP float drift from a merge-order bug
— changes it with overwhelming probability. Note what this deliberately
checks: multiset equality of row values, the equivalence certified
rewrites actually promise.

Bucket-count-changing rewrites (coalesce/split/broadcast) legitimately
change per-key content; the scheduler's acceptance path calls
:func:`forget_stage` for exactly those stages (the certificate's
``bucket_changed_stages``), so the witness never compares across a
re-bucketing.

Default OFF: ``BALLISTA_REPLAY_WITNESS=1`` in the environment or
:func:`enable` — every instrumentation point is a single flag check, and
the hash work (a read-back of the just-written file) only happens when
enabled."""

from __future__ import annotations

import hashlib
import logging
import os
import threading

ENV_WITNESS = "BALLISTA_REPLAY_WITNESS"

log = logging.getLogger(__name__)

_enabled = os.environ.get(ENV_WITNESS, "") in ("1", "true", "yes")

_lock = threading.Lock()
_hashes: dict[tuple, str] = {}
_mismatches: list[dict] = []
# lifetime record counts per kind: "zero mismatches" must never silently
# mean "zero records" (same diagnostic stance as reswitness)
_records: dict[str, int] = {}
_rehashes = 0  # same-key re-records that MATCHED (retries proven equal)


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = flag


def enabled() -> bool:
    return _enabled


def canonical_hash(table) -> str:
    """Order-canonical content hash of an Arrow table: combine chunks,
    sort by every column (total order up to exact duplicate rows),
    serialize through uncompressed IPC, sha256. Schema (names + dtypes)
    rides in the IPC stream, so a schema drift also changes the hash."""
    import pyarrow as pa
    import pyarrow.ipc as paipc

    table = table.combine_chunks()
    if table.num_rows:
        table = table.sort_by([(n, "ascending") for n in table.schema.names])
    sink = pa.BufferOutputStream()
    with paipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return hashlib.sha256(sink.getvalue()).hexdigest()


def hash_file(path: str) -> str:
    """Canonical hash of one shuffle IPC file. A path that was never
    created (a zero-row partition writes no file) hashes as the stable
    ``"empty"`` marker — absent-both-times still compares equal across
    retries, and absent-vs-present is a mismatch."""
    import pyarrow.ipc as paipc

    if not os.path.exists(path):
        return "empty"
    with paipc.open_file(path) as r:
        return canonical_hash(r.read_all())


def record(kind: str, key: tuple, digest: str) -> None:
    """Record one content hash; a same-key re-record with a different
    digest is a mismatch (kept, counted, logged — assert_clean fails on
    it)."""
    global _rehashes
    full = (kind,) + tuple(key)
    with _lock:
        _records[kind] = _records.get(kind, 0) + 1
        prev = _hashes.get(full)
        if prev is None:
            _hashes[full] = digest
            return
        if prev == digest:
            _rehashes += 1
            return
        _mismatches.append({"key": full, "expected": prev, "got": digest})
    log.error(
        "replay witness MISMATCH at %s: %s != %s", full, prev, digest
    )


def forget_stage(job_id: str, stage_id: int) -> None:
    """Drop every recorded hash of one stage's shuffle output — called by
    the scheduler when a certified rewrite changes the stage's bucket
    count (per-bucket content then legitimately differs)."""
    with _lock:
        for k in [
            k
            for k in _hashes
            if k[0] == "shuffle" and k[1] == job_id and k[2] == stage_id
        ]:
            del _hashes[k]


def mismatches() -> list[dict]:
    with _lock:
        return [dict(m) for m in _mismatches]


def record_counts() -> dict[str, int]:
    with _lock:
        return dict(_records)


def rehash_count() -> int:
    """Same-key re-records that MATCHED — the count of retries /
    recomputes / rewrites the witness actually proved bit-exact."""
    with _lock:
        return _rehashes


def snapshot(strip_job: bool = False) -> dict[tuple, str]:
    """The recorded hash map; ``strip_job=True`` drops the job-id
    component so independent runs of the same query (each its own job)
    can be compared key-for-key — the cross-config property tests'
    comparison form."""
    with _lock:
        if not strip_job:
            return dict(_hashes)
        return {(k[0],) + k[2:]: v for k, v in _hashes.items()}


def summary() -> str:
    counts = record_counts()
    mm = mismatches()
    head = (
        f"{sum(counts.values())} hashes recorded ("
        + ", ".join(f"{k}:{n}" for k, n in sorted(counts.items()))
        + f"), {rehash_count()} re-records matched"
    )
    if not mm:
        return head + ", 0 mismatches"
    return head + f", {len(mm)} MISMATCHES: " + "; ".join(
        str(m["key"]) for m in mm
    )


def assert_clean(require_records: bool = True) -> None:
    """Zero mismatches (and, by default, a nonzero record count — a
    witness that saw no traffic proves nothing)."""
    mm = mismatches()
    if mm:
        lines = [
            f"{m['key']}: expected {m['expected']}, got {m['got']}"
            for m in mm
        ]
        raise AssertionError(
            f"{len(mm)} replay-witness hash mismatches:\n" + "\n".join(lines)
        )
    if require_records and not record_counts():
        raise AssertionError(
            "replay witness recorded nothing — enable() before the run, "
            "or the instrumentation points were never reached"
        )


def reset() -> None:
    global _rehashes
    with _lock:
        _hashes.clear()
        _mismatches.clear()
        _records.clear()
        _rehashes = 0
