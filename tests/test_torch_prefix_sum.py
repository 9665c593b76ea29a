"""The fixed-order f64 prefix sum (``ops/prefix_sum.py``): its plain
version against a numpy loop of the same association, bit for bit (ragged
n, n below one chunk, empty, NaN, +-inf and -0.0); a numpy model of the
kernel's one-pass decomposition (tiles of 4,096 rows, each from its own
data and what the tiles before it publish) against both, bit for bit, at
n on and around tile and level boundaries, with the scratch sized for
exactly what it publishes; the sort aggregate's f64 sums, now taken from
it, against the reference's within rtol 1e-9; integer prefixes unchanged;
the kernel source's fixed order (no float atomic, every f64 add
``__dadd_rn``); and, on a card, the CUDA kernel against the plain version
bit for bit (tile-boundary n, far more tiles than resident blocks, two
streams at once). The reference is imported inside the one test that runs
it, so that the card's tests run without JAX."""

import re
import threading

import numpy as np
import pytest
import torch

from ballista_tpu_torch.ops import aggregate as port_agg
from ballista_tpu_torch.ops import prefix_sum

C = prefix_sum.CHUNK


def loop_prefix(col: np.ndarray) -> np.ndarray:
    """The association, written as loops over Python floats: running sums
    from +0.0 within chunks of C rows (the last padded with +0.0), each
    chunk's offset the inclusive prefix of the totals before it (the same
    rule, recursively), then offset + local."""
    n = len(col)
    if n == 0:
        return col.copy()
    m = -(-n // C)
    vals = [float(v) for v in col] + [0.0] * (m * C - n)
    local, totals = [], []
    for c in range(m):
        acc = 0.0
        for j in range(C):
            acc = acc + vals[c * C + j]
            local.append(acc)
        totals.append(acc)
    incl = loop_prefix(np.array(totals)) if m > 1 else np.array(totals)
    out = [(0.0 if c == 0 else float(incl[c - 1])) + local[c * C + j] for c in range(m) for j in range(C)]
    return np.array(out[:n], dtype=np.float64)


TILE = C ** 3  # rows a block of the kernel scans: levels 0-2 lie inside it


def running(a: np.ndarray, axis: int) -> np.ndarray:
    """Running sums from +0.0 along ``axis``, one IEEE add a step (each
    element's chain left to right)."""
    a = np.moveaxis(a, axis, -1)
    out = np.empty_like(a)
    acc = np.zeros(a.shape[:-1])
    for i in range(a.shape[-1]):
        acc = acc + a[..., i]
        out[..., i] = acc
    return np.moveaxis(out, -1, axis)


def look_back(G: dict, t: int) -> tuple[float, float]:
    """Tile t's look-back as the kernel's warp 0 does it: P(0, t - 1) and
    P(0, t - 2), the inclusive prefixes of the tile totals (by the rule,
    levels 3 and up) at the two tiles before t, from the published entries
    ``G[(a, j)]`` alone: at level a the entries of the group that holds
    index j_a up to j_a, and, where j_a opens its group, the whole previous
    group's total G[(a + 1, q - 1)]. Also publishes, where t ends a group
    at level a, that group's total G[(a + 1, g)], as the tile that ends it
    does. Reading an entry no earlier tile (or t itself) published raises
    KeyError."""
    levels = []  # (j_a, loc(a, j_a), loc(a, j_a - 1) or None)
    j, a = t - 1, 0
    while True:
        q = j // C
        acc = prev = 0.0
        for i in range(q * C, j + 1):
            prev, acc = acc, acc + G[(a, i)]
        loc2 = prev if j % C else (G[(a + 1, q - 1)] if j else None)
        levels.append((j, acc, loc2))
        if q == 0:
            break
        j, a = q - 1, a + 1
    own, i = G[(0, t)], t
    for a, (_, loc1, _) in enumerate(levels):
        if i % C != C - 1:
            break
        own = loc1 + own
        i //= C
        G[(a + 1, i)] = own
    p1 = p2 = None  # P(a + 1, j_(a + 1)) and P(a + 1, j_(a + 1) - 1)
    for j, loc1, loc2 in reversed(levels):
        q = j // C
        off = p1 if q > 0 else 0.0
        off_prev = p2 if q > 1 else 0.0
        p1, p2 = off + loc1, (None if loc2 is None else (off if j % C else off_prev) + loc2)
    return p1, (p2 if t >= 2 else 0.0)


def one_pass_model(col: np.ndarray, published: dict | None = None) -> np.ndarray:
    """The kernel's one-pass decomposition of the association, in numpy.
    Each tile of TILE rows scans levels 0-2 from its own data: running sums
    of its 16-row chunks (local0), of their totals in groups of 16 (local1)
    and of those 16 totals (local2). It publishes its total G[(0, t)] and
    its tail, A (the last level-2 total) and B (the running sum of the
    first 15), then takes from the look-back X3 = P(0, t - 1) and
    P(0, t - 2), and from those and tile t - 1's tail the three offsets it
    starts from: X3 for its level-2 entries, X2 = P(0, t - 2) + G[(0, t -
    1)] for its first level-1 group, X1 = (P(0, t - 2) + B) + A for its
    first chunk (all +0.0 at t = 0). Tiles run in order here; in the
    kernel any order gives the same bits, since each value is a fixed
    chain of adds of published values. ``published`` receives the
    entries, keyed (level, index)."""
    n = len(col)
    if n == 0:
        return col.copy()
    tiles = -(-n // TILE)
    x = np.zeros(tiles * TILE)
    x[:n] = col
    local0 = running(x.reshape(tiles, C * C, C), 2)
    local1 = running(local0[:, :, -1].reshape(tiles, C, C), 2)
    t2 = local1[:, :, -1]
    local2 = running(t2, 1)
    a_tail, b_tail = t2[:, -1], local2[:, -2]
    G = {} if published is None else published
    G.update({(0, t): float(local2[t, -1]) for t in range(tiles)})
    X = np.zeros((tiles, 3))
    for t in range(1, tiles):
        x3, o3 = look_back(G, t)
        X[t] = ((o3 + b_tail[t - 1]) + a_tail[t - 1], o3 + G[(0, t - 1)], x3)
    x1, x2, x3 = X.T
    p2 = x3[:, None] + local2
    off2 = np.concatenate([x2[:, None], p2[:, :-1]], axis=1)
    p1 = (off2[:, :, None] + local1).reshape(tiles, C * C)
    off1 = np.concatenate([x1[:, None], p1[:, :-1]], axis=1)
    return (off1[:, :, None] + local0).reshape(-1)[:n]


def same_bits(a, b) -> bool:
    """Bit for bit, where a NaN matches any NaN (a NaN's payload is not
    carried alike by every machine's adds)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    ok = ~np.isnan(a)
    return np.array_equal(a[ok].view(np.int64), b[ok].view(np.int64))


def make_columns(k: int, n: int, seed: int, specials: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 100, (k, n))
    x[:, ::3] *= -1e-3
    if specials and n:
        for c in range(k):
            at = rng.integers(0, n, 4)
            x[c, at[0]] = -0.0
            if c % 3 == 1:
                x[c, at[1]] = np.nan
            if c % 3 == 2:
                x[c, at[2]] = np.inf
                x[c, at[3]] = -np.inf if n > 40 else x[c, at[3]]
    return x


@pytest.mark.parametrize("n", [0, 1, C - 1, C, C + 1, 257, C * C * C + 5, 10_007])
@pytest.mark.parametrize("k", [1, 3])
def test_plain_matches_the_loop_bit_for_bit(n, k):
    x = make_columns(k, n, seed=n + k, specials=True)
    got = prefix_sum.prefix_sums(torch.from_numpy(x)).numpy()
    assert got.shape == (k, n)
    for c in range(k):
        assert same_bits(got[c], loop_prefix(x[c])), (n, c)


@pytest.mark.parametrize("n", [4095, 4096, 4097, 2 * 4096 - 1, C ** 4 - 1, C ** 4 + 1, 17 * 4096 + 5, C ** 5 + 3])
@pytest.mark.parametrize("k", [1, 3])
def test_one_pass_model_matches_the_loop_and_plain(n, k):
    """The kernel's index algebra is the association: the one-pass model
    equals the loop and the plain version bit for bit at n on and around
    tile and level boundaries, with -0.0, NaN and +-inf in the columns."""
    assert TILE == 4096
    x = make_columns(k, n, seed=n + 7 * k, specials=True)
    plain = prefix_sum.prefix_sums_plain(torch.from_numpy(x)).numpy()
    for c in range(k):
        with np.errstate(invalid="ignore"):  # inf - inf is NaN, as in the loop
            got = one_pass_model(x[c])
        assert not ((got == 0) & np.signbit(got)).any()  # never -0.0
        assert same_bits(got, loop_prefix(x[c])), (n, c)
        assert same_bits(got, plain[c]), (n, c)


def test_negative_zero_and_specials():
    """-0.0 sums from +0.0 into +0.0; NaN and +-inf carry forward; inf
    minus inf is NaN; rows after a NaN stay NaN in its column only."""
    x = np.array([[-0.0, -0.0, 1.0], [np.inf, 1.0, -np.inf], [np.nan, 2.0, 3.0]])
    got = prefix_sum.prefix_sums(torch.from_numpy(x)).numpy()
    assert np.signbit(got[0, :2]).tolist() == [False, False]
    assert got[0].tolist() == [0.0, 0.0, 1.0]
    assert got[1, 0] == np.inf and got[1, 1] == np.inf and np.isnan(got[1, 2])
    assert np.isnan(got[2]).all()


def test_levels_and_scratch():
    """The scratch has a slot for each entry the kernel publishes, and each
    slot is published: the model's entries at level a are exactly 0 ..
    levels(n)[a] - 1."""
    T = prefix_sum.TILE
    assert T == TILE
    assert prefix_sum.levels(1) == [1] and prefix_sum.scratch_words(1, 1) == 2 + 2 * 3
    assert prefix_sum.levels(T) == [1] and prefix_sum.levels(T + 1) == [2]
    assert prefix_sum.levels(15 * T) == [15] and prefix_sum.levels(16 * T) == [16, 1]
    n = 6_000_000
    lv = prefix_sum.levels(n)
    assert lv == [1465, 91, 5]  # tiles, then full groups of 16
    # the counter (two words), then a (value, ~value) pair for each tile's
    # total and tail values and for each group total above the tiles
    assert prefix_sum.scratch_words(n, 6) == 2 + 2 * 6 * (3 * 1465 + 91 + 5)
    for n in (1, T, T + 1, 16 * T, C ** 5 + 3, 256 * T + 1, 4096 * T + 1):
        published = {}
        one_pass_model(np.ones(n), published)
        lv = prefix_sum.levels(n)
        assert {a for a, _ in published} == set(range(len(lv))), n
        for a, size in enumerate(lv):
            assert sorted(j for b, j in published if b == a) == list(range(size)), (n, a)


def test_wrapper_checks():
    with pytest.raises(ValueError, match="want \\(k, n\\)"):
        prefix_sum.prefix_sums(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(TypeError, match="float64"):
        prefix_sum.prefix_sums(torch.zeros(1, 4, dtype=torch.float32))
    # neither the CPU nor the card: no plain-version fallback
    with pytest.raises(ValueError, match="want CUDA or the CPU"):
        prefix_sum.prefix_sums(torch.zeros(1, 4, dtype=torch.float64, device="meta"))
    before = prefix_sum.launches
    prefix_sum.prefix_sums(torch.ones(2, 100, dtype=torch.float64))
    assert prefix_sum.launches == before  # the plain version does not count


def test_column_cumsums_routes_floats_and_keeps_integers():
    """Float columns take the fixed order; integer prefixes stay
    ``torch.cumsum`` (exact in any order, widened to int64)."""
    rng = np.random.default_rng(3)
    f = [torch.from_numpy(rng.uniform(0, 100, 1000)) for _ in range(2)]
    got = port_agg._column_cumsums(f)
    assert got.shape == (1000, 2)
    want = prefix_sum.prefix_sums_plain(torch.stack(f, 0))
    assert same_bits(got.numpy(), want.T.numpy())
    i = [torch.from_numpy(rng.integers(-5, 5, 1000).astype(np.int32)) for _ in range(3)]
    gi = port_agg._column_cumsums(i)
    assert gi.dtype == torch.int64 and gi.shape == (1000, 3)
    assert torch.equal(gi, torch.stack([torch.cumsum(c, 0) for c in i], dim=1))


@pytest.mark.parametrize("n", [5000, 70_001])
def test_sort_aggregate_f64_sums_match_the_reference(n):
    """The sort path's f64 SUM over an int64 key, from the fixed-order
    prefix, against the reference's (``jnp.cumsum`` on the CPU) within
    rtol 1e-9; keys and counts exactly."""
    import jax.numpy as jnp

    from ballista_tpu.ops import aggregate as ref_agg

    rng = np.random.default_rng(n)
    key = rng.zipf(1.5, n).astype(np.int64) % 400
    v = rng.uniform(0, 100, n)
    vn = rng.random(n) < 0.1
    valid = rng.random(n) < 0.95
    cap = 512
    want = ref_agg.group_aggregate(
        [jnp.asarray(key)], [None], jnp.asarray(valid), [jnp.asarray(v), jnp.asarray(v)],
        [jnp.asarray(vn), None], [ref_agg.AggOp.SUM, ref_agg.AggOp.COUNT], cap,
    )
    got = port_agg.group_aggregate(
        [torch.from_numpy(key)], [None], torch.from_numpy(valid), [torch.from_numpy(v)] * 2,
        [torch.from_numpy(vn), None], [port_agg.AggOp.SUM, port_agg.AggOp.COUNT], cap,
    )
    wv = np.asarray(want.valid)
    assert np.array_equal(got.valid.numpy(), wv)
    assert np.array_equal(got.keys[0].numpy()[wv], np.asarray(want.keys[0])[wv])
    assert np.array_equal(got.values[1].numpy()[wv], np.asarray(want.values[1])[wv])
    np.testing.assert_allclose(got.values[0].numpy()[wv], np.asarray(want.values[0])[wv], rtol=1e-9)
    # the same input again gives the same bits
    again = port_agg.group_aggregate(
        [torch.from_numpy(key)], [None], torch.from_numpy(valid), [torch.from_numpy(v)] * 2,
        [torch.from_numpy(vn), None], [port_agg.AggOp.SUM, port_agg.AggOp.COUNT], cap,
    )
    assert same_bits(again.values[0].numpy(), got.values[0].numpy())


def test_kernel_source_adds_in_a_fixed_order():
    """No atomic on a float operand: the one atomic is the integer tile
    counter's; every f64 add is an explicit round-to-nearest add (no
    contraction, fast math or other rounding can reorder or change it)."""
    src = prefix_sum.SOURCE.read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert set(re.findall(r"\batomic\w*\s*\([^;]*", code)) == {"atomicAdd(counter, 1u)"}
    assert "unsigned* __restrict__ counter" in code
    assert not re.search(r"\b(atom|red)\.", code)  # no atomics in inline PTX
    assert not re.search(r"fma|__dadd_r[duz]|__dmul|__fadd", code)
    assert "kChunk = 16;" in code and prefix_sum.CHUNK == 16
    assert code.count("__dadd_rn(") == 15


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,k",
    [
        (6_000_000, 1), (1 << 21, 2), (1_000_003, 6), (1, 1), (C * 4096 + 3, 3),
        (4095, 1), (4097, 2), (17 * 4096 - 1, 3), (256 * 4096 + 1, 1), (4096 * 4096 + 1, 1),
        (6_000_000, 6),  # far more tiles than resident blocks
    ],
)
def test_cuda_kernel_matches_plain(n, k):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x = make_columns(k, n, seed=n, specials=True)
    xd = torch.from_numpy(x).cuda()
    before = prefix_sum.launches
    got = prefix_sum.prefix_sums(xd)
    again = prefix_sum.prefix_sums(xd)
    torch.cuda.synchronize()
    assert prefix_sum.launches == before + 2
    want = prefix_sum.prefix_sums_plain(torch.from_numpy(x))
    assert same_bits(got.cpu().numpy(), want.numpy())
    assert same_bits(again.cpu().numpy(), got.cpu().numpy())


@pytest.mark.gpu
def test_cuda_kernel_on_two_streams():
    """Two threads, each on its own stream, call the kernel 20 times on
    inputs of their own: each call's flags and counter are its own, so
    every result equals its plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    shapes = [(1_000_003, 2), (3 * 4096 + 5, 3)]
    inputs = [[make_columns(k, n, seed=100 * i + j, specials=j % 2 == 0) for j in range(20)]
              for i, (n, k) in enumerate(shapes)]
    on_card = [[torch.from_numpy(x).cuda() for x in xs] for xs in inputs]
    torch.cuda.synchronize()
    results, errors = [[], []], []

    def run(i):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                for xd in on_card[i]:
                    results[i].append(prefix_sum.prefix_sums(xd))
            stream.synchronize()
        except Exception as e:  # surfaced below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    for xs, outs in zip(inputs, results):
        assert len(outs) == 20
        for x, got in zip(xs, outs):
            assert same_bits(got.cpu().numpy(), prefix_sum.prefix_sums_plain(torch.from_numpy(x)).numpy())
