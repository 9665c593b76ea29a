"""The port's grace-hash spill write (``ballista_tpu_torch/exec/spill.py``)
against the reference's, on the same batch made from a seed: the bucket
files hold the same rows in the same order, table for table, and the same
rows and bytes are charged to each bucket and to the spill budget. The port
groups the rows by bucket (``ops/partition.partition_groups``) and writes
zero-copy slices of one Arrow batch, where the reference sorts the ids on
the host and writes a ``take`` per bucket.

Also: ``evict_plan_cache`` keeps the same keys in both packages. The
``gpu`` test writes on the card, with one wait a batch."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp
from ballista_tpu.columnar.arrow_interop import batch_from_arrow as ref_batch_from_arrow
from ballista_tpu.exec import base as ref_base
from ballista_tpu.exec import spill as ref_spill
from ballista_tpu_torch.columnar.arrow_interop import batch_from_arrow
from ballista_tpu_torch.exec import base, spill
from ballista_tpu_torch.ops import partition


# The reference's host fetch packs every column into one f64 buffer
# (``ballista_tpu/ops/fetch.py``), so its int64 values are exact only
# within 2^53 (ROADMAP queue 3): the parity tables stay inside it, and
# ``test_spill_keeps_int64_beyond_2_53`` holds the port to the full range.
INT64_EXACT_IN_REFERENCE = 1 << 53


def table(n: int, seed: int, int64_bound: int = INT64_EXACT_IN_REFERENCE) -> pa.Table:
    """Every column kind the spill carries: int64, int32, f64, f32, date,
    timestamp, bool and strings, with null rows (a string column of which
    every row is null, too)."""
    rng = np.random.default_rng(seed)
    nulls = lambda p=0.1: rng.random(n) < p  # noqa: E731
    words = np.array(["MAIL", "SHIP", "RAIL", "TRUCK", "AIR", "FOB", "REG AIR", ""])
    return pa.table({
        "k": pa.array(rng.integers(0, 50, n)),
        "a": pa.array(rng.integers(-int64_bound, int64_bound, n, dtype=np.int64)),
        "b": pa.array(rng.integers(-1000, 1000, n).astype(np.int32), mask=nulls()),
        "f": pa.array(rng.normal(0, 1e3, n), mask=nulls()),
        "g": pa.array(rng.normal(0, 1, n).astype(np.float32)),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32), mask=nulls()).cast(pa.date32()),
        "ts": pa.array(rng.integers(0, 10**15, n)).cast(pa.timestamp("us")),
        "t": pa.array(rng.random(n) < 0.5, mask=nulls(0.3)),
        "s": pa.array(words[rng.integers(0, len(words), n)], mask=nulls(0.2)),
        "u": pa.array(words[rng.integers(0, len(words), n)]),
        "z": pa.array([None] * n, type=pa.string()),
    })


def both_batches(t: pa.Table, seed: int):
    """The table as a reference batch and a port batch (CPU), about a
    tenth of the rows invalid."""
    invalid = np.random.default_rng(seed + 1).random(t.num_rows) < 0.1
    ref = ref_batch_from_arrow(t)
    port = batch_from_arrow(t, device="cpu")
    mask = np.zeros(ref.capacity, dtype=bool)
    mask[: t.num_rows] = ~invalid
    return (
        ref.with_valid(ref.valid & jnp.asarray(mask)),
        port.with_valid(port.valid & torch.from_numpy(mask)),
    )


def assert_sets_equal(ref_set, port_set, buckets: int) -> None:
    assert port_set.bucket_rows == ref_set.bucket_rows
    assert port_set.bucket_bytes == ref_set.bucket_bytes
    assert port_set.manager.total_bytes == ref_set.manager.total_bytes
    for b in range(buckets):
        want, got = ref_set.read(b), port_set.read(b)
        assert (want is None) == (got is None), b
        if want is not None:
            assert got.schema.equals(want.schema), b
            assert got.equals(want), b


KEYSETS = {"int": ("k",), "str": ("s",), "int+str+date": ("k", "s", "d")}


@pytest.mark.parametrize("buckets", [2, 7, 64])
@pytest.mark.parametrize("keys", list(KEYSETS))
@pytest.mark.parametrize("n", [1, 1000, 5003])
def test_spill_batch_by_keys_writes_the_references_files(tmp_path, n, keys, buckets):
    t = table(n, seed=n + buckets)
    ref, port = both_batches(t, seed=n)
    idxs = tuple(t.schema.names.index(c) for c in KEYSETS[keys])
    ref_set = ref_spill.SpillManager(str(tmp_path / "ref"), 0).new_set("s", buckets)
    port_set = spill.SpillManager(str(tmp_path / "port"), 0).new_set("s", buckets)
    for _ in range(2):  # a second batch appends to the same files
        want = ref_spill.spill_batch_by_keys(ref_set, ref, idxs)
        got = spill.spill_batch_by_keys(port_set, port, idxs)
        assert got == want
    assert sum(port_set.bucket_rows) == 2 * int(port.valid.sum())
    assert_sets_equal(ref_set, port_set, buckets)
    ref_set.manager.close()
    port_set.manager.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_split_of_given_ids_matches_reference(tmp_path, seed):
    """``write_split`` over ids that no hash made (skewed, some buckets
    empty): the port's grouping of them (``group_by_id``) writes the files
    and charges the bytes of the reference's ``write_split``."""
    n, buckets = 3001, 16
    t = table(n, seed=seed)
    ref, port = both_batches(t, seed=seed)
    rng = np.random.default_rng(seed)
    pids = np.where(rng.random(port.capacity) < 0.7, 3, rng.integers(0, buckets // 2, port.capacity))
    pids = np.where(port.valid.numpy(), pids, buckets).astype(np.int32)
    ref_set = ref_spill.SpillManager(str(tmp_path / "ref"), 0).new_set("s", buckets)
    port_set = spill.SpillManager(str(tmp_path / "port"), 0).new_set("s", buckets)
    want = ref_set.write_split(ref, pids)
    got = port_set.write_split(port, *partition.group_by_id(torch.from_numpy(pids), buckets))
    assert got == want
    assert_sets_equal(ref_set, port_set, buckets)
    ref_set.manager.close()
    port_set.manager.close()


def test_spill_keeps_int64_beyond_2_53(tmp_path):
    """The port's spill files hold every int64 exactly, past the 2^53 at
    which the reference's host fetch rounds them: each bucket holds its
    routed rows of the input table, in row order."""
    n, buckets = 4000, 8
    t = table(n, seed=9, int64_bound=np.iinfo(np.int64).max)
    _, port = both_batches(t, seed=9)
    sset = spill.SpillManager(str(tmp_path), 0).new_set("s", buckets)
    spill.spill_batch_by_keys(sset, port, (1,))
    pid = partition.partition_ids(port, [1], buckets).numpy()[:n]
    for b in range(buckets):
        want = t.take(pa.array(np.flatnonzero(pid == b)))
        got = sset.read(b)
        assert got.column("a").equals(want.column("a")), b
        assert (np.abs(want.column("a").to_numpy()) > INT64_EXACT_IN_REFERENCE).any()
    sset.manager.close()


@pytest.mark.parametrize("n", [1, 7, 8, 9, 100, 1000])
def test_take_nbytes_is_what_take_reports(n):
    """``take_nbytes`` of a batch's bucket ranges equals the ``nbytes`` of
    ``take`` over each range, for every column kind, where a slice's own
    ``nbytes`` may differ."""
    t = table(n, seed=n)
    rb = t.to_batches()[0] if n else pa.RecordBatch.from_pylist([], schema=t.schema)
    rng = np.random.default_rng(n)
    cuts = np.unique(np.concatenate([[0, n], rng.integers(0, n + 1, 5)]))
    starts, lens = cuts[:-1], np.diff(cuts)
    got = spill.take_nbytes(rb, starts, lens)
    want = [rb.take(pa.array(np.arange(s, s + k))).nbytes for s, k in zip(starts, lens)]
    assert got.tolist() == want


PLAN_CACHE_CASES = {
    "under-the-bound": (10, (), 16),
    "evict-to-half": (40, (), 16),
    "pinned-and-sticky": (40, (3, 5, 30), 16),
    "pinned-past-half": (40, tuple(range(25)), 16),
}


@pytest.mark.parametrize("case", list(PLAN_CACHE_CASES))
def test_evict_plan_cache_keeps_the_references_keys(case):
    size, pinned, bound = PLAN_CACHE_CASES[case]
    cache = {i: i for i in range(size)}
    cache["__build_cache_bytes__"] = 123
    ours, theirs = dict(cache), dict(cache)
    got = base.evict_plan_cache(ours, pinned=pinned, max_entries=bound)
    want = ref_base.evict_plan_cache(theirs, pinned=pinned, max_entries=bound)
    assert got == want
    assert list(ours) == list(theirs)
    assert "__build_cache_bytes__" in ours and all(k in ours for k in pinned)


def test_retry_loop_evicts_instead_of_clearing():
    """Past ``PLAN_CACHE_MAX_ENTRIES`` the retry loop evicts the oldest
    half and keeps pinned keys (it used to clear the whole cache)."""
    bound = base.PLAN_CACHE_MAX_ENTRIES
    cache = {("k", i): i for i in range(bound + 10)}
    before = dict(base.plan_cache_evictions)
    base.run_with_capacity_retry(
        base.BallistaConfig(), lambda ctx: None, device="cpu", plan_cache=cache,
        pinned_cache_keys=(("k", 0),),
    )
    assert len(cache) == bound // 2
    assert ("k", 0) in cache and ("k", bound + 9) in cache and ("k", 1) not in cache
    assert base.plan_cache_evictions["evicted"] - before["evicted"] == bound // 2 + 10
    assert base.plan_cache_evictions["flushes"] == before["flushes"] + 1


@pytest.mark.gpu
def test_write_split_on_card_waits_once_a_batch(tmp_path):
    """On the card the write groups the rows with the kernel, waits once a
    batch, and writes the files of the CPU's write."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    t = table(20_000, seed=5)
    idxs = (0, t.schema.names.index("s"))
    cpu_set = spill.SpillManager(str(tmp_path / "cpu"), 0).new_set("s", 64)
    card_set = spill.SpillManager(str(tmp_path / "card"), 0).new_set("s", 64)
    spill.reset_stats()
    before = partition.launches
    for seed in range(3):
        _, port = both_batches(t, seed=seed)
        spill.spill_batch_by_keys(cpu_set, port, idxs)
        card = batch_from_arrow(t, device="cuda").with_valid(port.valid.cuda())
        spill.spill_batch_by_keys(card_set, card, idxs)
    assert partition.launches - before == 3
    assert spill.stats["waits"] == 3 and spill.stats["batches"] == 6
    assert_sets_equal(cpu_set, card_set, 64)
    cpu_set.manager.close()
    card_set.manager.close()
