"""The port's sort-based ``group_aggregate`` against the reference's on the
same numpy input: SUM, MIN, MAX and COUNT over int, float and string
(dictionary-code) keys with null keys, NaN and -0.0 keys, null values and
dead rows; the overflow flag and group count; and the segment helpers.
Keys, counts, null flags and integer results exactly; f64 sums within
rtol 1e-9 (a prefix-sum difference rounds like another summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ballista_tpu.ops import aggregate as ref_agg
from ballista_tpu_torch.ops import aggregate as port_agg

OPS = ["SUM", "COUNT", "MIN", "MAX"]


def make_keys(kind: str, n: int, rng) -> tuple[np.ndarray, np.ndarray | None]:
    if kind == "int":
        k = rng.integers(-30, 30, n).astype(np.int64)
        k[:2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max]
        return k, rng.random(n) < 0.1
    if kind == "float":
        k = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.0, np.inf]), n)
        return k, rng.random(n) < 0.1
    if kind == "string":  # dictionary codes
        return rng.integers(0, 12, n).astype(np.int32), None
    return rng.integers(0, 5, n).astype(np.int32), rng.random(n) < 0.2  # "date"-like


def make_vals(n: int, rng, nan: bool):
    f64 = np.round(rng.normal(0, 1e3, n), 2)
    if nan:
        f64[rng.integers(0, n, 4)] = np.nan
    vals = [
        f64,
        rng.integers(-(2**40), 2**40, n),
        rng.integers(-1000, 1000, n).astype(np.int32),
        rng.random(n).astype(np.float32),
        rng.random(n) < 0.5,
    ]
    nulls = [rng.random(n) < 0.2, None, rng.random(n) < 0.3, None, None]
    return vals, nulls


def as_ref(a):
    return None if a is None else jnp.asarray(a)


def as_port(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def run_both(keys, key_nulls, valid, vals, val_nulls, ops, capacity):
    want = ref_agg.group_aggregate(
        [as_ref(k) for k in keys], [as_ref(m) for m in key_nulls], jnp.asarray(valid),
        [as_ref(v) for v in vals], [as_ref(m) for m in val_nulls],
        [ref_agg.AggOp[o] for o in ops], capacity,
    )
    got = port_agg.group_aggregate(
        [as_port(k) for k in keys], [as_port(m) for m in key_nulls], torch.from_numpy(valid),
        [as_port(v) for v in vals], [as_port(m) for m in val_nulls],
        [port_agg.AggOp[o] for o in ops], capacity,
    )
    return got, want


def assert_same_groups(got, want, ops):
    assert int(got.n_groups) == int(want.n_groups)
    assert bool(got.overflow) == bool(want.overflow)
    gv, wv = got.valid.numpy(), np.asarray(want.valid)
    assert np.array_equal(gv, wv)
    for g, w in zip(got.keys, want.keys):
        g, w = g.numpy()[gv], np.asarray(w)[wv]
        assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=g.dtype.kind == "f")
    for g, w in zip(got.key_nulls, want.key_nulls):
        assert (g is None) == (w is None)
        if g is not None:
            assert np.array_equal(g.numpy()[gv], np.asarray(w)[wv])
    for op, g, w, gn, wn in zip(ops, got.values, want.values, got.value_nulls, want.value_nulls):
        g, w = g.numpy()[gv], np.asarray(w)[wv]
        assert g.dtype == w.dtype, (op, g.dtype, w.dtype)
        if wn is not None:
            wn = np.asarray(wn)[wv]
            assert np.array_equal(gn.numpy()[gv], wn), op
            g, w = g[~wn], w[~wn]
        if op == "SUM" and g.dtype == np.float64:
            np.testing.assert_allclose(g, w, rtol=1e-9, err_msg=op)
        else:
            assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f"), op


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize(
    "key_kinds", [("int",), ("float",), ("string",), ("int", "string", "date"), ("float", "int")]
)
def test_group_aggregate_matches_reference(key_kinds, nan):
    rng = np.random.default_rng(sum(map(ord, "".join(key_kinds))) + nan)
    n = 3000
    keys, key_nulls = zip(*(make_keys(k, n, rng) for k in key_kinds))
    vals, val_nulls = make_vals(n, rng, nan)
    valid = rng.random(n) < 0.9
    # every op over every value column (SUM of bool counts TRUEs)
    cols, nulls, ops = [], [], []
    for v, m in zip(vals, val_nulls):
        for op in OPS:
            cols.append(v)
            nulls.append(m)
            ops.append(op)
    got, want = run_both(list(keys), list(key_nulls), valid, cols, nulls, ops, 4096)
    assert not bool(got.overflow)
    assert_same_groups(got, want, ops)


def test_key_only_aggregate_matches_reference():
    # DISTINCT and the SEMI-join dedup: keys and no value column
    rng = np.random.default_rng(3)
    k, kn = make_keys("int", 2500, rng)
    valid = rng.random(2500) < 0.8
    got, want = run_both([k], [kn], valid, [], [], [], 4096)
    assert_same_groups(got, want, [])


@pytest.mark.parametrize("capacity", [16, 50, 64])
def test_overflow_flag_and_group_count_match_reference(capacity):
    rng = np.random.default_rng(capacity)
    n = 2048
    k = rng.integers(0, 64, n).astype(np.int64)
    vals, val_nulls = make_vals(n, rng, nan=False)
    valid = np.ones(n, dtype=bool)
    got, want = run_both([k], [None], valid, vals[:2], val_nulls[:2], ["SUM", "COUNT"], capacity)
    assert int(got.n_groups) == int(want.n_groups) == 64
    assert bool(got.overflow) == bool(want.overflow) == (capacity < 64)
    if capacity >= 64:
        assert_same_groups(got, want, ["SUM", "COUNT"])


def test_same_and_gt_val_match_reference():
    x = np.array([0.0, -0.0, np.nan, np.nan, 1.0, np.inf, -np.inf, 2.0])
    y = np.array([-0.0, 0.0, np.nan, 1.0, np.nan, np.inf, 1.0, 2.0])
    for f in ("_same_val", "_gt_val"):
        want = np.asarray(getattr(ref_agg, f)(jnp.asarray(x), jnp.asarray(y)))
        got = getattr(port_agg, f)(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        assert np.array_equal(got, want), f
    a, b = np.array([3, -1, 5], dtype=np.int64), np.array([3, 2, -7], dtype=np.int64)
    assert np.array_equal(
        port_agg._gt_val(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(ref_agg._gt_val(jnp.asarray(a), jnp.asarray(b))),
    )


@pytest.mark.parametrize("n", [1, 9, 1000])
def test_ffill_tuple_matches_reference(n):
    rng = np.random.default_rng(n)
    flag = rng.random(n) < 0.2
    vals = (rng.integers(0, 100, n).astype(np.int64), rng.normal(size=n), rng.random(n) < 0.5)
    wv, wf = ref_agg._ffill_tuple(tuple(jnp.asarray(v) for v in vals), jnp.asarray(flag))
    gv, gf = port_agg._ffill_tuple(tuple(torch.from_numpy(v) for v in vals), torch.from_numpy(flag))
    assert np.array_equal(gf.numpy(), np.asarray(wf))
    for g, w in zip(gv, wv):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.gpu
def test_group_aggregate_on_card_matches_cpu():
    # the card's stable sort must order ties as the CPU's does (groups come
    # out in the same order), and its f64 prefix sums agree within rtol
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(9)
    n = 1 << 20
    keys, key_nulls = zip(*(make_keys(k, n, rng) for k in ("int", "float", "string")))
    vals, val_nulls = make_vals(n, rng, nan=True)
    valid = rng.random(n) < 0.9
    ops = [port_agg.AggOp[o] for o in ("SUM", "COUNT", "MIN", "MAX", "SUM")]
    args = (list(keys), list(key_nulls), valid, vals, val_nulls)

    def run(dev):
        t = lambda a: None if a is None else torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
        k, kn, v, c, cn = args
        return port_agg.group_aggregate(
            [t(x) for x in k], [t(x) for x in kn], t(v), [t(x) for x in c], [t(x) for x in cn],
            ops, 1 << 20,
        )

    want, got = run("cpu"), run("cuda")
    gv = got.valid.cpu()
    assert torch.equal(gv, want.valid)
    for g, w in zip(got.keys + got.key_nulls, want.keys + want.key_nulls):
        if w is not None:
            assert torch.equal(g.cpu()[gv].nan_to_num(7.0), w[gv].nan_to_num(7.0))
    for g, w in zip(got.values, want.values):
        g, w = g.cpu()[gv], w[gv]
        if w.dtype == torch.float64:
            torch.testing.assert_close(g, w, rtol=1e-9, atol=0, equal_nan=True)
        else:
            assert torch.equal(g, w)
