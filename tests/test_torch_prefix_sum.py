"""The fixed-order f64 prefix sum (``ops/prefix_sum.py``): its plain
version against a numpy loop of the same association, bit for bit (ragged
n, n below one chunk, empty, NaN, +-inf and -0.0); the sort aggregate's
f64 sums, now taken from it, against the reference's within rtol 1e-9;
integer prefixes unchanged; and, on a card, the CUDA kernel against the
plain version bit for bit. The reference is imported inside the one test
that runs it, so that the card's tests run without JAX."""

import re

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
    assert prefix_sum.levels(C) == [] and prefix_sum.scratch_rows(C) == 0
    assert prefix_sum.levels(C + 1) == [C + 1] and prefix_sum.scratch_rows(C + 1) == 4
    n = 6_000_000
    lv = prefix_sum.levels(n)
    assert lv == [n, 375_000, 23_438, 1465, 92]  # then 6 rows: one chunk
    assert prefix_sum.scratch_rows(n) == sum(2 * -(-r // C) for r in lv)


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
    """No atomics, and every float add is an explicit round-to-nearest add
    (no contraction or fast math can reorder it)."""
    src = prefix_sum.SOURCE.read_text()
    assert not re.search(r"\batomic\w*\s*\(", src)
    assert "kChunk = 16;" in src and prefix_sum.CHUNK == 16
    assert src.count("__dadd_rn(") == 3


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(6_000_000, 1), (1 << 21, 2), (1_000_003, 6), (1, 1), (C * 4096 + 3, 3)])
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
