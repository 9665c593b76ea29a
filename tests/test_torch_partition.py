"""The port's hash partitioning (``ballista_tpu_torch/ops/partition.py``)
against the reference's ``ops/partition.py``, bit for bit: the same Arrow
input goes through ``partition_ids`` of both packages and through the
reference's jitted ``jit_partition_ids``. Keys of every kind (int64, int32,
date, f64 without -0.0, bool, string), one and two columns, null rows and
invalid rows, K in {1, 2, 3, 7, 64}, n of 1, 5000 and 2^16.

The partition-hash kernel itself runs only on a card: the ``gpu`` tests
hold it against the plain version there and skip here."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu.columnar.arrow_interop import batch_from_arrow as ref_batch_from_arrow
from ballista_tpu.exec.repartition import jit_partition_ids
from ballista_tpu.ops import hashing as ref_hashing
from ballista_tpu.ops import partition as ref_partition
from ballista_tpu_torch.columnar.arrow_interop import batch_from_arrow
from ballista_tpu_torch.exec.repartition import partition_ids_fn
from ballista_tpu_torch.ops import hashing, partition

KS = [1, 2, 3, 7, 64]
NS = [1, 5000, 1 << 16]
KEYS = {
    "i64": ["a"],
    "i32": ["b"],
    "date": ["d"],
    "f64": ["f"],
    "bool": ["t"],
    "str": ["s"],
    "i64+str": ["a", "s"],
    "f64+i32": ["f", "b"],
}


def table(n: int, seed: int) -> pa.Table:
    """Every key kind, each with null rows (but the int64 key, which
    ranges over all of int64 so that it stays int64 on both sides)."""
    rng = np.random.default_rng(seed)
    nulls = lambda: rng.random(n) < 0.1  # noqa: E731
    f = rng.normal(0, 1e3, n)
    f[rng.random(n) < 0.05] = np.nan
    f[: min(n, 3)] = [np.inf, -np.inf, 0.0][: min(n, 3)]
    words = np.array(["MAIL", "SHIP", "RAIL", "TRUCK", "AIR", "FOB", "REG AIR"])
    return pa.table({
        "a": pa.array(rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n, dtype=np.int64)),
        "b": pa.array(rng.integers(-(2**31) + 1, 2**31, n).astype(np.int32), mask=nulls()),
        "d": pa.array(rng.integers(-1000, 20000, n).astype(np.int32), mask=nulls()).cast(pa.date32()),
        "f": pa.array(f, mask=nulls()),
        "t": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "s": pa.array(words[rng.integers(0, len(words), n)], mask=nulls()),
    })


def both_batches(t: pa.Table, seed: int):
    """The table as a reference batch and a port batch (CPU), about a
    tenth of the rows invalid."""
    invalid = np.random.default_rng(seed + 1).random(t.num_rows) < 0.1
    ref = ref_batch_from_arrow(t)
    port = batch_from_arrow(t, device="cpu")
    mask = np.zeros(ref.capacity, dtype=bool)
    mask[: t.num_rows] = ~invalid
    ref = ref.with_valid(ref.valid & jnp.asarray(mask))
    port = port.with_valid(port.valid & torch.from_numpy(mask))
    return ref, port


@pytest.fixture(scope="module", params=NS, ids=lambda n: f"n{n}")
def batches(request):
    n = request.param
    t = table(n, seed=n)
    return t, *both_batches(t, seed=n)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("keys", list(KEYS))
def test_partition_ids_bit_identical_to_reference(batches, keys, k):
    t, ref, port = batches
    idxs = [t.schema.names.index(c) for c in KEYS[keys]]
    want = np.asarray(ref_partition.partition_ids(ref, idxs, k))
    jitted = np.asarray(
        jit_partition_ids(tuple(idxs), k)(ref, ref_partition.string_key_tables(ref, idxs))
    )
    got = partition.partition_ids(port, idxs, k)
    assert got.dtype == torch.int32
    got = got.numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, jitted)
    # invalid rows (and padding) take the drop bucket K, live rows [0, K)
    valid = port.valid.numpy()
    assert (got[~valid] == k).all()
    assert ((got[valid] >= 0) & (got[valid] < k)).all()
    # the shared routing function of the spills routes alike
    again = partition_ids_fn(tuple(idxs), k)(port, partition.string_key_tables(port, idxs))
    assert np.array_equal(again.numpy(), got)


def test_string_keys_route_by_value_not_code():
    """Two batches whose dictionaries code the same strings differently
    route equal strings to the same partition, as in the reference."""
    v1 = ["MAIL", "SHIP", "MAIL", "RAIL"]
    v2 = ["RAIL", "SHIP", "AIR", "SHIP", "MAIL"]
    b1 = batch_from_arrow(pa.table({"s": pa.array(v1)}), device="cpu")
    b2 = batch_from_arrow(pa.table({"s": pa.array(v2)}), device="cpu")
    # "MAIL" is code 0 in one batch and code 1 in the other
    assert b1.dictionaries["s"].index_of("MAIL") != b2.dictionaries["s"].index_of("MAIL")
    for k in KS:
        p1 = partition.partition_ids(b1, [0], k).numpy()
        p2 = partition.partition_ids(b2, [0], k).numpy()
        route1 = {v: p1[i] for i, v in enumerate(v1)}
        route2 = {v: p2[i] for i, v in enumerate(v2)}
        assert all(route1[v] == route2[v] for v in v1)
        r1 = np.asarray(ref_partition.partition_ids(ref_batch_from_arrow(pa.table({"s": pa.array(v1)})), [0], k))
        assert np.array_equal(p1, r1)


def test_stable_string_hashes_are_blake2b():
    values = ("", "MAIL", "Customer#000000001", "ü")
    got = partition._stable_string_hashes(values)
    want = [int.from_bytes(hashlib.blake2b(v.encode(), digest_size=8).digest(), "little") for v in values]
    assert got.dtype == np.uint64 and got.tolist() == want
    assert np.array_equal(got, ref_partition._stable_string_hashes(values))
    assert partition._stable_string_hashes(values) is got  # cached by the values


def test_unsigned_modulo_of_high_hashes():
    """About half the hashes are >= 2^63, negative as int64: the modulo is
    unsigned. torch's ``%`` on those (floored) is right only where K
    divides 2^64."""
    rng = np.random.default_rng(3)
    u = rng.integers(0, np.iinfo(np.uint64).max, 1 << 14, dtype=np.uint64, endpoint=True)
    u[:3] = [np.iinfo(np.uint64).max, 1 << 63, (1 << 63) - 1]
    h = torch.from_numpy(u.view(np.int64))
    assert (h < 0).sum() > 1000
    for k in KS + [1000003, (1 << 31) - 1]:
        assert np.array_equal(partition._umod(h, k).numpy(), (u % np.uint64(k)).astype(np.int64))
    assert not np.array_equal((h % 7).numpy(), (u % np.uint64(7)).astype(np.int64))


def test_null_string_hashes_zero_after_the_table():
    """A null string row hashes 0, not its table entry: the zeroing comes
    after the table, so it routes with a null integer key."""
    s = pa.table({"s": pa.array(["b", None, "a", None])})
    i = pa.table({"s": pa.array([5, None, 7, None], type=pa.int64())})
    bs, bi = batch_from_arrow(s, device="cpu"), batch_from_arrow(i, device="cpu")
    # the null rows' codes are 0, which is the code of "a"
    assert bs.columns[0][1].item() == 0 and bs.dictionaries["s"].values[0] == "a"
    hs = hashing.hash_columns_plain(partition._lanes(
        [bs.columns[0]], [bs.nulls[0]], list(partition.string_key_tables(bs, [0]))
    ))
    hi = hashing.hash_columns_plain([torch.where(bi.nulls[0], 0, bi.columns[0].long())])
    assert hs[1] == hi[1] == hs[3] and hs[1] != hs[2]
    for k in (7, 64):
        ps = partition.partition_ids(bs, [0], k)
        pi = partition.partition_ids(bi, [0], k)
        assert ps[1] == pi[1] == ps[3]
        want = np.asarray(ref_partition.partition_ids(ref_batch_from_arrow(s), [0], k))
        assert np.array_equal(ps.numpy(), want)


def test_negative_zero_routes_with_zero():
    """-0.0 and +0.0 are one SQL value and route to one partition (the
    reference's jitted routing folds its ``+ 0.0`` and splits them; ROADMAP
    queue 3)."""
    col = torch.tensor([0.0, -0.0, 0.0, -0.0])
    valid = torch.ones(4, dtype=torch.bool)
    for k in KS:
        assert len(set(partition.partition_ids_for([col], [None], valid, k).tolist())) == 1


def test_hash_columns_unchanged_on_cpu():
    """On CPU tensors ``hash_columns`` is the plain int64 chain, equal to
    the reference's uint64 hash."""
    rng = np.random.default_rng(9)
    cols = [
        rng.integers(-(2**62), 2**62, 4099),
        rng.normal(0, 1e6, 4099),
        rng.integers(-(2**31), 2**31, 4099).astype(np.int32),
    ]
    got = hashing.hash_columns([torch.from_numpy(c) for c in cols])
    plain = hashing.hash_columns_plain([torch.from_numpy(c) for c in cols])
    want = np.asarray(ref_hashing.hash_columns([jnp.asarray(c) for c in cols])).view(np.int64)
    assert torch.equal(got, plain)
    assert np.array_equal(got.numpy(), want)


def test_plain_version_is_the_cpu_route():
    rng = np.random.default_rng(4)
    cols = [torch.from_numpy(rng.integers(0, 100, 1000)), torch.from_numpy(rng.normal(size=1000))]
    nulls = [torch.from_numpy(rng.random(1000) < 0.2), None]
    valid = torch.from_numpy(rng.random(1000) < 0.9)
    got = partition.partition_hash(cols, nulls, [None, None], valid, 7)
    assert torch.equal(got, partition.partition_ids_plain(cols, nulls, [None, None], valid, 7))
    assert partition.partition_hash(cols, nulls, [None, None], None, 0).dtype == torch.int64


@pytest.mark.parametrize(
    "bad",
    [
        dict(cols=[]),
        dict(k=-1),
        dict(k=1 << 31),
        dict(cols=[torch.zeros(4, dtype=torch.int16)]),
        dict(valid=torch.ones(3, dtype=torch.bool)),
        dict(tables=[torch.zeros(0, dtype=torch.int64)]),
    ],
    ids=["no-columns", "negative-k", "k-2^31", "int16", "short-valid", "empty-table"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    cols = bad.get("cols", [torch.zeros(4, dtype=torch.int32)])
    tables = bad.get("tables", [None] * len(cols))
    with pytest.raises((TypeError, ValueError)):
        partition.partition_hash(
            cols, [None] * len(cols), tables, bad.get("valid", torch.ones(4, dtype=torch.bool)),
            bad.get("k", 4),
        )


def test_wrapper_refuses_tensors_off_cpu_and_cuda():
    """A tensor off the CPU with the rest on it is no route to the plain
    version: the wrapper raises (a CUDA tensor launches the kernel or
    raises)."""
    cols = [torch.zeros(4, dtype=torch.int64, device="meta")]
    with pytest.raises(ValueError, match="CUDA device"):
        partition.partition_hash(cols, [None], [None], torch.ones(4, dtype=torch.bool), 4)


# -- the kernel, on a card ----------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5000, 1 << 20, 1_000_003])
def test_kernel_matches_plain_on_card(n):
    dev = _card()
    rng = np.random.default_rng(n)
    f = rng.normal(0, 1e3, n)
    f[: min(n, 8)] = [-0.0, 0.0, np.nan, np.inf, -np.inf, 1e-40, -3e-39, 1e300][: min(n, 8)]
    with np.errstate(over="ignore"):
        f32 = f.astype(np.float32)  # 1e-40 and -3e-39 are f32 subnormals
    cols = [
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n, dtype=np.int64),
        rng.integers(-(2**31), 2**31, n).astype(np.int32),
        f,
        f32,
        rng.random(n) < 0.5,
        rng.integers(-2, 40, n).astype(np.int32),  # string codes, some out of range
    ]
    table = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 37, dtype=np.int64)
    nulls = [None, rng.random(n) < 0.2, None, rng.random(n) < 0.1, None, rng.random(n) < 0.3]
    tables = [None] * 5 + [table]
    valid = rng.random(n) < 0.9
    cpu = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    for pick in ([0], [1, 0], [2], [3, 5], [4, 2, 5], list(range(6)), list(range(6)) * 2):
        args = [
            [cpu(cols[i]) for i in pick], [cpu(nulls[i]) for i in pick],
            [cpu(tables[i]) for i in pick], cpu(valid),
        ]
        on_card = [[None if a is None else a.to(dev) for a in xs] for xs in args[:3]]
        for k in (0, 1, 2, 7, 64):
            want = partition.partition_ids_plain(*args, k)
            got = partition.partition_hash(*on_card, args[3].to(dev), k)
            again = partition.partition_hash(*on_card, args[3].to(dev), k)
            assert torch.equal(got.cpu(), want), (pick, k)
            assert torch.equal(got, again)


@pytest.mark.gpu
def test_hash_columns_on_card_launches_the_kernel():
    dev = _card()
    x = torch.arange(1 << 16, dtype=torch.int64)
    before = partition.launches
    got = hashing.hash_columns([x.to(dev)])
    assert partition.launches == before + 1
    assert torch.equal(got.cpu(), hashing.hash_columns_plain([x]))


# -- the grouped mode: rows grouped by partition ------------------------------

GROUP_KS = [1, 2, 4, 7, 64, 1024]
GROUP_NS = [0, 1, 2048, 5003]
_C1, _C2, _C3 = 0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB
_M64 = (1 << 64) - 1


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x + np.uint64(_C1)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(_C2)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(_C3)
        return x ^ (x >> np.uint64(31))


def _oracle_pid(lanes: list[np.ndarray], valid: np.ndarray, k: int) -> np.ndarray:
    """Partition ids in numpy uint64: splitmix64 over the lanes, ``% k``,
    ``k`` for invalid rows."""
    h = np.zeros(len(valid), dtype=np.uint64)
    for u in lanes:
        h = _splitmix64_np(h ^ _splitmix64_np(u))
    return np.where(valid, (h % np.uint64(k)).astype(np.int64), k)


def group_case(case: str, n: int, seed: int):
    """(cols, nulls, tables, valid, lanes) of one grouped-mode case:
    ``uniform`` int64 keys, ``skew`` (90% of the rows share one key),
    ``invalid`` (no row valid) and ``str`` (string codes through a blake2b
    table, a fifth of them null; some codes out of range)."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.9
    if case == "str":
        words = tuple(f"w{i}" for i in range(23))
        table = partition._stable_string_hashes(words)
        codes = rng.integers(-1, len(words) + 1, n).astype(np.int32)
        nulls = rng.random(n) < 0.2
        lanes = np.where(nulls, np.uint64(0), table[np.clip(codes, 0, len(words) - 1)])
        cols = [torch.from_numpy(codes)]
        return cols, [torch.from_numpy(nulls)], [torch.from_numpy(table.view(np.int64))], torch.from_numpy(valid), [lanes]
    keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n, dtype=np.int64)
    if case == "skew":
        keys[rng.random(n) < 0.9] = 12345
    if case == "invalid":
        valid[:] = False
    return [torch.from_numpy(keys)], [None], [None], torch.from_numpy(valid), [keys.view(np.uint64)]


@pytest.mark.parametrize("case", ["uniform", "skew", "invalid", "str"])
@pytest.mark.parametrize("n", GROUP_NS)
@pytest.mark.parametrize("k", GROUP_KS)
def test_partition_groups_match_numpy_oracle(case, n, k):
    """``partition_groups`` on the CPU: the ids, the stable order by id and
    the bucket starts equal numpy's ``argsort(kind="stable")`` and
    ``bincount`` bit for bit."""
    cols, nulls, tables, valid, lanes = group_case(case, n, seed=n * 31 + k)
    pid, order, offsets = partition.partition_groups(cols, nulls, tables, valid, k)
    want_pid = _oracle_pid(lanes, valid.numpy(), k)
    want_order = np.argsort(want_pid, kind="stable")
    want_offsets = np.concatenate([[0], np.cumsum(np.bincount(want_pid, minlength=k + 1))])
    assert pid.dtype == order.dtype == torch.int32 and offsets.dtype == torch.int64
    assert np.array_equal(pid.numpy(), want_pid)
    assert np.array_equal(order.numpy(), want_order)
    assert np.array_equal(offsets.numpy(), want_offsets)
    assert offsets[k] == int(valid.sum()) and offsets[k + 1] == n
    if case == "skew" and n > 1000:
        assert np.bincount(want_pid).max() > 0.7 * n  # 90% of keys, 90% valid
    # the ids are partition_hash's
    assert torch.equal(pid, partition.partition_hash(cols, nulls, tables, valid, k))


@pytest.mark.parametrize("k", [0, -1, 1025])
def test_partition_groups_rejects_k_out_of_range(k):
    cols, nulls, tables, valid, _ = group_case("uniform", 16, seed=1)
    with pytest.raises(ValueError):
        partition.partition_groups(cols, nulls, tables, valid, k)


def _unsplitmix64(h: int) -> int:
    """The inverse of splitmix64 (each step is a bijection of uint64)."""

    def unxorshift(y, s):
        x = y
        for _ in range(64 // s):
            x = y ^ (x >> s)
        return x

    x = unxorshift(h, 31)
    x = (x * pow(_C3, -1, 1 << 64)) & _M64
    x = unxorshift(x, 27)
    x = (x * pow(_C2, -1, 1 << 64)) & _M64
    x = unxorshift(x, 30)
    return (x - _C1) & _M64


def edge_hashes(k: int, seed: int) -> list[int]:
    """uint64 hashes at the modulo's edges: 0, 1, 2^64 - 1, 2^63 and its
    neighbours, multiples of ``k`` at both ends of the range and their
    neighbours, and random hashes."""
    top = _M64 // k
    mult = [j * k for j in (1, 2, 3, top // 2, top - 1, top)]
    out = {0, 1, _M64, _M64 - 1, 1 << 63, (1 << 63) - 1, (1 << 63) + 1}
    out.update(m + d for m in mult for d in (-1, 0, 1) if 0 <= m + d <= _M64)
    rng = np.random.default_rng(seed)
    out.update(int(v) for v in rng.integers(0, _M64, 200, dtype=np.uint64, endpoint=True))
    return sorted(out)


def edge_keys(k: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """int64 keys whose one-column row hash is each of ``edge_hashes``,
    and those hashes (uint64)."""
    hashes = edge_hashes(k, seed)
    keys = [_unsplitmix64(_unsplitmix64(h)) for h in hashes]
    return np.array(keys, dtype=np.uint64).view(np.int64), np.array(hashes, dtype=np.uint64)


@pytest.mark.parametrize("k", sorted(set(KS + GROUP_KS + [1000003, (1 << 31) - 1])))
def test_multiply_high_modulo_is_exact_at_the_edges(k):
    """The kernel's ``h % K`` (``umod`` in ``csrc/partition_hash.cu``):
    q = umulhi(h, floor((2^64 - 1) / K)) is floor(h / K) or one less, so
    h - q K lies in [0, 2K) and one subtraction ends it, for every uint64
    h. Checked in exact integers at the edge hashes; and keys made to hash
    to them route to h % K (the gpu test holds the kernel to the same)."""
    magic = _M64 // k
    for h in edge_hashes(k, seed=k):
        r = h - (((h * magic) >> 64) * k)
        assert 0 <= r < 2 * k, (h, k)
        assert (r - k if r >= k else r) == h % k, (h, k)
    keys, hashes = edge_keys(k, seed=k)
    assert np.array_equal(_oracle_pid([keys.view(np.uint64)], np.ones(len(keys), bool), 0x7FFFFFFF + 1), (hashes % np.uint64(1 << 31)).astype(np.int64))
    got = partition.partition_hash([torch.from_numpy(keys)], [None], [None], torch.ones(len(keys), dtype=torch.bool), k)
    assert np.array_equal(got.numpy(), (hashes % np.uint64(k)).astype(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["uniform", "skew", "invalid", "str"])
def test_partition_groups_kernel_matches_plain_on_card(case):
    """The grouped mode on the card equals its plain version bit for bit
    (ids, order, bucket starts), and two launches are bit-identical, at
    every K of the CPU tests and n from 1 to past a tile boundary."""
    dev = _card()
    for n in (1, 2048, 4096, 4097, 100_003, 1 << 20):
        cols, nulls, tables, valid, _ = group_case(case, n, seed=n)
        on = lambda xs: [None if x is None else x.to(dev) for x in xs]  # noqa: E731
        for k in GROUP_KS:
            want = partition.partition_groups_plain(cols, nulls, tables, valid, k)
            before = partition.launches
            got = partition.partition_groups(on(cols), on(nulls), on(tables), valid.to(dev), k)
            again = partition.partition_groups(on(cols), on(nulls), on(tables), valid.to(dev), k)
            assert partition.launches == before + 2
            for g, a, w in zip(got, again, want):
                assert torch.equal(g, a), (case, n, k)
                assert torch.equal(g.cpu(), w), (case, n, k)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 7, 64, 1024, 1000003, (1 << 31) - 1])
def test_kernel_modulo_at_edge_hashes_on_card(k):
    dev = _card()
    keys, hashes = edge_keys(k, seed=k)
    col = [torch.from_numpy(keys).to(dev)]
    valid = torch.ones(len(keys), dtype=torch.bool, device=dev)
    got = partition.partition_hash(col, [None], [None], valid, k).cpu().numpy()
    assert np.array_equal(got, (hashes % np.uint64(k)).astype(np.int32))
    if k <= partition.MAX_GROUPS:
        pid, _, _ = partition.partition_groups(col, [None], [None], valid, k)
        assert np.array_equal(pid.cpu().numpy(), got)


def test_key_column_descriptor_layout():
    """The descriptors the wrapper packs (``_KEYCOL``) have the layout of
    the kernel source's ``struct KeyCol`` as a C compiler lays it out."""
    import ctypes

    class KeyCol(ctypes.Structure):
        _fields_ = [
            ("data", ctypes.c_void_p), ("nulls", ctypes.c_void_p), ("table", ctypes.c_void_p),
            ("table_len", ctypes.c_longlong), ("dtype", ctypes.c_int),
        ]

    assert partition._KEYCOL.size == ctypes.sizeof(KeyCol)
    buf = ctypes.create_string_buffer(partition._KEYCOL.size)
    partition._KEYCOL.pack_into(buf, 0, 1 << 40, 2, 3, 4, 2)
    got = KeyCol.from_buffer_copy(buf.raw)
    assert (got.data, got.nulls, got.table, got.table_len, got.dtype) == (1 << 40, 2, 3, 4, 2)
    src = partition.SOURCE.read_text()
    assert "struct KeyCol {" in src and "long long table_len;\n  int dtype;\n};" in src
