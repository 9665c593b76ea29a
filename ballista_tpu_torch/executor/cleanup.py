"""Shuffle/spill housekeeping: TTL-based work_dir garbage collection.

ref ballista/rust/executor/src/main.rs:193-257 — ``clean_shuffle_data_loop``
runs every ``job_data_clean_up_interval_seconds``; a job directory whose
most recent modification is older than ``job_data_ttl_seconds`` is deleted
(the scheduler keeps no reference to it past job completion + client fetch).

The same sweep also covers grace-hash spill files (exec/spill.py). Spill
directories under a job's work_dir (``<work_dir>/<job>/spill``) are deleted
with the job by ``clean_shuffle_data``; spills of contexts WITHOUT a
work_dir land in the shared temp root and are swept by
``clean_spill_data`` — both are attempt-scoped and deleted eagerly at the
attempt boundary in normal operation, so the sweeps only matter after a
crash."""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time

log = logging.getLogger(__name__)


def _newest_mtime(path: str) -> float:
    """Most recent mtime in the directory tree (ref main.rs:226-243:
    max of all file/dir modification times)."""
    newest = os.path.getmtime(path)
    for root, dirs, files in os.walk(path):
        for name in dirs + files:
            try:
                newest = max(newest, os.path.getmtime(os.path.join(root, name)))
            except OSError:
                pass
    return newest


def clean_shuffle_data(work_dir: str, ttl_seconds: float) -> list[str]:
    """Delete per-job shuffle directories idle for longer than the TTL.
    Returns the deleted job ids (ref main.rs:205-224)."""
    deleted: list[str] = []
    if not os.path.isdir(work_dir):
        return deleted
    now = time.time()
    for entry in os.listdir(work_dir):
        job_dir = os.path.join(work_dir, entry)
        if not os.path.isdir(job_dir):
            continue
        try:
            if now - _newest_mtime(job_dir) > ttl_seconds:
                shutil.rmtree(job_dir, ignore_errors=True)
                deleted.append(entry)
        except OSError as e:
            log.warning("cleanup of %s failed: %s", job_dir, e)
    if deleted:
        log.info("cleaned %d expired job dirs: %s", len(deleted), deleted)
    return deleted


def clean_spill_data(ttl_seconds: float, root: str | None = None) -> list[str]:
    """Delete orphaned grace-hash spill attempt directories from the shared
    temp root (exec/spill.py SPILL_TMP_ROOT) idle for longer than the TTL.
    Live attempts keep writing (fresh mtimes), so only directories whose
    owner died are old enough to collect. Returns the deleted names."""
    if root is None:
        from ballista_tpu_torch.exec.spill import SPILL_TMP_ROOT as root
    deleted: list[str] = []
    if not os.path.isdir(root):
        return deleted
    now = time.time()
    for entry in os.listdir(root):
        attempt_dir = os.path.join(root, entry)
        if not os.path.isdir(attempt_dir):
            continue
        try:
            if now - _newest_mtime(attempt_dir) > ttl_seconds:
                shutil.rmtree(attempt_dir, ignore_errors=True)
                deleted.append(entry)
        except OSError as e:
            log.warning("spill cleanup of %s failed: %s", attempt_dir, e)
    if deleted:
        log.info("cleaned %d orphaned spill dirs: %s", len(deleted), deleted)
    return deleted


def clean_push_streams(ttl_seconds: float) -> int:
    """Drop sealed push-shuffle streams (executor/push.py) idle for
    longer than the TTL — the in-memory analogue of the job-dir sweep,
    on the same horizon: a stream this stale belongs to a job whose
    files would be swept too (consumer crashed for good, job failed),
    and recovery recomputes if anyone ever asks again. Returns the
    count dropped."""
    from ballista_tpu_torch.executor.push import REGISTRY

    n = REGISTRY.sweep(ttl_seconds)
    if n:
        log.info("cleaned %d expired push streams", n)
    return n


def start_cleanup_loop(
    work_dir: str,
    ttl_seconds: float,
    interval_seconds: float,
    stop: threading.Event | None = None,
) -> tuple[threading.Thread, threading.Event]:
    """Background TTL sweep (ref main.rs:193-203). Returns (thread, stop)."""
    stop = stop or threading.Event()

    def loop() -> None:
        while not stop.wait(interval_seconds):
            try:
                clean_shuffle_data(work_dir, ttl_seconds)
                clean_spill_data(ttl_seconds)
                clean_push_streams(ttl_seconds)
            except Exception:  # noqa: BLE001
                log.exception("shuffle cleanup sweep failed")

    t = threading.Thread(target=loop, daemon=True, name="shuffle-cleanup")
    t.start()
    return t, stop
