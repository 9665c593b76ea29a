"""The port's dense and scalar aggregates against the reference's, on the
CPU, with nulls and all four ops; the one-hot route against the index_add_
route; and the port's NaN semantics."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ballista_tpu.ops import aggregate as ref_agg
from ballista_tpu_torch.ops import aggregate as port_agg
from ballista_tpu_torch.ops import onehot_agg

OPS = ["sum", "count", "min", "max"]


def make_case(n: int, vocab: list[int], seed: int, nan: bool = False):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, v, n).astype(np.int32) for v in vocab]
    key_nulls = [
        (rng.random(n) < 0.1) if i % 2 == 0 else None for i in range(len(vocab))
    ]
    valid = rng.random(n) < 0.85
    vals = [
        rng.normal(0, 100, n),  # f64
        rng.integers(-(2**40), 2**40, n),  # i64
        rng.integers(-1000, 1000, n).astype(np.int32),  # i32
        np.round(rng.random(n) * 1e4, 2),  # money-like f64
        rng.random(n).astype(np.float32),  # f32
        rng.random(n) < 0.5,  # bool
    ]
    if nan:
        vals[0][rng.integers(0, n, 3)] = np.nan
    val_nulls = [
        (rng.random(n) < 0.2) if i % 3 != 1 else None for i in range(len(vals))
    ]
    return keys, key_nulls, valid, vals, val_nulls


def as_ref(a):
    return None if a is None else jnp.asarray(a)


def as_port(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def columns_for(vals, val_nulls, ops):
    """Each op over each value column (bool MIN/MAX kept; SUM of bool
    counts TRUEs)."""
    cols, nulls, op_list = [], [], []
    for v, nm in zip(vals, val_nulls):
        for op in ops:
            cols.append(v)
            nulls.append(nm)
            op_list.append(op)
    return cols, nulls, op_list


def assert_close(got, want, what):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0, err_msg=what)
    else:
        assert np.array_equal(got, want), what


@pytest.mark.parametrize(
    "n,vocab,seed",
    [(1, [3], 0), (5000, [3, 2], 1), (20000, [4, 3], 2), (3000, [7], 3),
     (4096, [2, 2, 3], 4), (1500, [40, 50], 5)],
)
def test_dense_group_aggregate_matches_reference(n, vocab, seed):
    keys, key_nulls, valid, vals, val_nulls = make_case(n, vocab, seed)
    cols, nulls, ops = columns_for(vals, val_nulls, OPS)
    ref = ref_agg.dense_group_aggregate(
        [as_ref(k) for k in keys], [as_ref(m) for m in key_nulls], vocab,
        jnp.asarray(valid), [as_ref(c) for c in cols], [as_ref(m) for m in nulls],
        [ref_agg.AggOp(o) for o in ops],
    )
    port = port_agg.dense_group_aggregate(
        [as_port(k) for k in keys], [as_port(m) for m in key_nulls], vocab,
        torch.from_numpy(valid), [as_port(c) for c in cols],
        [as_port(m) for m in nulls], [port_agg.AggOp(o) for o in ops],
    )
    assert np.array_equal(port.valid.numpy(), np.asarray(ref.valid))
    assert int(port.n_groups) == int(ref.n_groups)
    assert bool(port.overflow) is bool(ref.overflow) is False
    for i, (pk, rk) in enumerate(zip(port.keys, ref.keys)):
        assert_close(pk.numpy(), rk, f"key {i}")
    for i, (pm, rm) in enumerate(zip(port.key_nulls, ref.key_nulls)):
        assert (pm is None) == (rm is None)
        if rm is not None:
            assert np.array_equal(pm.numpy(), np.asarray(rm)), f"key null {i}"
    for i, (pv, rv) in enumerate(zip(port.values, ref.values)):
        assert_close(pv.numpy(), rv, f"value {i} ({ops[i]})")
    for i, (pm, rm) in enumerate(zip(port.value_nulls, ref.value_nulls)):
        assert (pm is None) == (rm is None)
        if rm is not None:
            assert np.array_equal(pm.numpy(), np.asarray(rm)), f"value null {i}"


@pytest.mark.parametrize("n,seed", [(1, 0), (777, 1), (10000, 2)])
def test_scalar_aggregate_matches_reference(n, seed):
    _, _, valid, vals, val_nulls = make_case(n, [1], seed)
    cols, nulls, ops = columns_for(vals, val_nulls, OPS)
    r_out, r_nulls = ref_agg.scalar_aggregate(
        jnp.asarray(valid), [as_ref(c) for c in cols], [as_ref(m) for m in nulls],
        [ref_agg.AggOp(o) for o in ops],
    )
    p_out, p_nulls = port_agg.scalar_aggregate(
        torch.from_numpy(valid), [as_port(c) for c in cols],
        [as_port(m) for m in nulls], [port_agg.AggOp(o) for o in ops],
    )
    for i, (p, r) in enumerate(zip(p_out, r_out)):
        assert_close(p.numpy(), r, f"out {i} ({ops[i]})")
    for i, (p, r) in enumerate(zip(p_nulls, r_nulls)):
        assert (p is None) == (r is None)
        if r is not None:
            assert bool(p) == bool(r), f"null {i}"


def test_both_routes_agree_and_the_kernel_route_runs_at_small_n(monkeypatch):
    """With P <= 2048 the counts and f64 sums go through onehot_sums at any
    n (no row gate, unlike the reference's f32 TPU kernel); forcing the
    slot gate to 0 takes the index_add_ route, which must agree."""
    keys, key_nulls, valid, vals, val_nulls = make_case(300, [3, 2], 9)
    cols, nulls, ops = columns_for(vals, val_nulls, OPS)

    def run():
        return port_agg.dense_group_aggregate(
            [as_port(k) for k in keys], [as_port(m) for m in key_nulls], [3, 2],
            torch.from_numpy(valid), [as_port(c) for c in cols],
            [as_port(m) for m in nulls], [port_agg.AggOp(o) for o in ops],
        )

    calls = []
    real = onehot_agg.onehot_sums

    def spy(rid, vals_, P):
        calls.append((tuple(vals_.shape), P))
        return real(rid, vals_, P)

    monkeypatch.setattr(onehot_agg, "onehot_sums", spy)
    via_kernel = run()
    n_f64_sums = 3  # SUMs over the three float columns widen to f64
    assert calls == [((len(cols) + n_f64_sums, 300), 12)]
    monkeypatch.setattr(onehot_agg, "MAX_SLOTS", 0)
    via_scatter = run()
    assert len(calls) == 1
    for a, b in zip(via_kernel.values, via_scatter.values):
        assert_close(a.numpy(), b.numpy(), "routes")
    for a, b in zip(via_kernel.value_nulls, via_scatter.value_nulls):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_value_rows_beyond_max_rows_split_into_calls(monkeypatch):
    """More value rows than one kernel call takes go through several calls
    of at most MAX_ROWS rows each, and agree with the index_add_ route."""
    keys, key_nulls, valid, vals, val_nulls = make_case(500, [3, 2], 4)
    cols, nulls, ops = columns_for(vals, val_nulls, OPS)

    def run():
        return port_agg.dense_group_aggregate(
            [as_port(k) for k in keys], [as_port(m) for m in key_nulls], [3, 2],
            torch.from_numpy(valid), [as_port(c) for c in cols],
            [as_port(m) for m in nulls], [port_agg.AggOp(o) for o in ops],
        )

    calls = []
    real = onehot_agg.onehot_sums

    def spy(rid, vals_, P):
        calls.append(vals_.shape[0])
        return real(rid, vals_, P)

    monkeypatch.setattr(onehot_agg, "onehot_sums", spy)
    monkeypatch.setattr(onehot_agg, "MAX_ROWS", 4)
    split = run()
    R = len(cols) + 3  # live rows, then the three f64 sums
    assert calls == [4] * (R // 4) + ([R % 4] if R % 4 else [])
    monkeypatch.setattr(onehot_agg, "MAX_SLOTS", 0)
    plain = run()
    for a, b in zip(split.values, plain.values):
        assert_close(a.numpy(), b.numpy(), "split")


@pytest.mark.parametrize("route_slots", [2048, 0])
def test_nan_stays_in_its_group(monkeypatch, route_slots):
    """SQL: a NaN in a SUM poisons its own group only. The reference's
    dense path multiplies a one-hot by the values, so on the CPU one NaN
    turns every group's sum into NaN: a divergence on the reference's side,
    logged in ROADMAP queue 3. The port selects instead of multiplying."""
    monkeypatch.setattr(onehot_agg, "MAX_SLOTS", route_slots)
    n = 1000
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 3, n).astype(np.int32)
    x = rng.random(n)
    x[np.nonzero(codes == 1)[0][0]] = np.nan
    res = port_agg.dense_group_aggregate(
        [torch.from_numpy(codes)], [None], [3], torch.ones(n, dtype=torch.bool),
        [torch.from_numpy(x)], [None], [port_agg.AggOp.SUM],
    )
    sums = res.values[0].numpy()
    assert np.isnan(sums[1])
    for g in (0, 2):
        np.testing.assert_allclose(sums[g], x[codes == g].sum(), rtol=1e-12)
    assert sums[3] == 0.0  # the NULL-key slot, unoccupied
