"""Adaptive capacity shrink: re-bucket a sparse batch to a small capacity
(port of ``ballista_tpu/exec/shrink.py``).

Filters and selective joins only clear validity bits, so a selective
operator (TPC-H q18: a HAVING that keeps a few dozen of 1.5M groups)
leaves a batch whose capacity is orders of magnitude larger than its live
row count, and every later sort pass, gather and scatter still pays the
full capacity. ``maybe_shrink`` moves the live rows to the front and cuts
the batch to a learned power-of-two capacity, so the rest of the plan
runs at the data's scale.

The learned capacity lives in the cross-query plan cache under
``("shrink", site, partition, capacity)``. The first run at a site pays
one host sync to count the live rows and decides: shrink only when the
capacity drops at least ``SHRINK_RATIO``-fold, else cache the sticky
don't-shrink entry 0. Later runs take the cached capacity speculatively
and validate it with a deferred device flag: a grown input raises
SpeculationMiss at the task boundary, and the retry re-learns. Keys that
this run has synced itself stay non-speculative
(``TaskContext.run_state["synced_caps"]``), so a site that sees many
batches converges. Nothing here changes a result.
"""

from __future__ import annotations

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch, round_capacity
from ballista_tpu_torch.ops.perm import stable_argsort, take_many_split

# Below this capacity a shrink cannot pay for its own compaction.
SHRINK_MIN_CAP = 4096
# Shrink only when the new capacity is at most old / RATIO: the compaction
# costs a bool argsort of the old capacity and a gather of the new one.
SHRINK_RATIO = 4
# Learned capacity = round_capacity(HEADROOM * live): room for modest
# growth before the speculation flag fires.
SHRINK_HEADROOM = 2


def _run_shrink(batch: DeviceBatch, new_cap: int) -> tuple[DeviceBatch, torch.Tensor]:
    """Live rows to the front, in order, cut to ``new_cap``: (the batch,
    a device bool that is set when the live rows did not fit). The stable
    argsort of the invalid flag is cut before the gather, so the gather
    costs the output's size, not the old capacity."""
    order = stable_argsort(~batch.valid)[:new_cap]
    cols, nulls = take_many_split(list(batch.columns), list(batch.nulls), order)
    n_live = batch.count_valid()
    iota = torch.arange(new_cap, dtype=torch.int32, device=batch.device)
    return (
        DeviceBatch(
            schema=batch.schema,
            columns=tuple(cols),
            valid=iota < n_live,
            nulls=tuple(nulls),
            dictionaries=dict(batch.dictionaries),
        ),
        n_live > new_cap,
    )


def maybe_shrink(batch: DeviceBatch, ctx, site_display: str, partition: int) -> DeviceBatch:
    """Shrink ``batch`` when this plan site is known (or now measured) to
    be selective. A no-op without a plan cache."""
    if ctx is None or ctx.plan_cache is None:
        return batch
    cap = batch.capacity
    if cap <= SHRINK_MIN_CAP:
        return batch
    # no job id in the key: a structural collision across jobs only fires
    # the validation flag and re-learns, where a job-scoped key would cost
    # every distributed query a blocking first-sight sync per site
    key = ("shrink", site_display, partition, cap)
    cache = ctx.plan_cache
    synced = ctx.run_state.setdefault("synced_caps", set())
    cached = cache.get(key)
    if cached is not None and key not in synced:
        if cached == 0:  # learned: not selective enough to shrink
            return batch
        out, overflow = _run_shrink(batch, cached)
        ctx.defer_speculation(
            overflow, "cached shrink capacity went stale (live rows grew)", [key]
        )
        return out
    if cached == 0:
        # sticky don't-shrink: a site of mixed selectivity must not
        # oscillate (a later sparse batch learning a small capacity would
        # make the next run shrink the dense batch speculatively and pay a
        # SpeculationMiss on every warm run)
        synced.add(key)
        return batch
    # first sight in this run: one host sync decides, and the decision is
    # cached across queries
    n = int(batch.count_valid().item())
    new_cap = round_capacity(max(SHRINK_HEADROOM * n, SHRINK_MIN_CAP))
    if new_cap > cap // SHRINK_RATIO:
        cache[key] = 0
        synced.add(key)
        return batch
    cache[key] = max(new_cap, cache.get(key) or 0)
    synced.add(key)
    out, _ = _run_shrink(batch, new_cap)  # the count is known: cannot overflow
    return out
