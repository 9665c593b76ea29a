"""The port's dense and scalar aggregates against the reference's, on the
CPU, with nulls and all four ops; the kernel route against np.add.at, at
up to 65,536 slots; the shared count rows; and the port's NaN semantics."""

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


def as_port_masks(masks):
    """Null masks as tensors, one tensor for each distinct numpy mask (as a
    batch holds one mask per column, whichever aggregates read it)."""
    seen = {}
    return [
        None if m is None else seen.setdefault(id(m), torch.from_numpy(m))
        for m in masks
    ]


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


def numpy_group_sums(slots, P, weights):
    """f64 group sums by np.add.at: the oracle of the kernel route."""
    out = np.zeros(P, dtype=np.float64)
    keep = (slots >= 0) & (slots < P)
    np.add.at(out, slots[keep], np.asarray(weights, dtype=np.float64)[keep])
    return out


def dense_slots(keys, key_nulls, vocab, valid):
    """The mixed-radix slot of each row (P for rows that are not valid)."""
    P, seg = 1, np.zeros(len(valid), dtype=np.int64)
    for k, nm, v in zip(keys, key_nulls, vocab):
        c = np.clip(k, 0, v - 1).astype(np.int64)
        if nm is not None:
            c = np.where(nm, v, c)
        seg = seg * (v + 1) + c
        P *= v + 1
    return np.where(valid, seg, P), P


def check_against_numpy(res, keys, key_nulls, vocab, valid, cols, nulls, ops):
    """Counts (exact) and f64 SUMs (rtol 1e-9) of a dense aggregate against
    np.add.at in f64."""
    slots, P = dense_slots(keys, key_nulls, vocab, valid)
    for i, (c, nm, op) in enumerate(zip(cols, nulls, ops)):
        live = np.ones(len(valid), dtype=bool) if nm is None else ~nm
        cnt = numpy_group_sums(slots, P, live).astype(np.int64)
        if op == "count":
            assert np.array_equal(res.values[i].numpy(), cnt), f"count {i}"
        else:
            assert np.array_equal(res.value_nulls[i].numpy(), cnt == 0), f"null {i}"
        if op == "sum" and res.values[i].dtype == torch.float64:
            want = numpy_group_sums(slots, P, np.where(live, c, 0).astype(np.float64))
            np.testing.assert_allclose(
                res.values[i].numpy(), want, rtol=1e-9, atol=1e-9, err_msg=f"sum {i}"
            )


def spy_on_kernel(monkeypatch):
    calls = []
    real = onehot_agg.onehot_sums

    def spy(rid, vals_, P):
        calls.append((tuple(vals_.shape), P))
        return real(rid, vals_, P)

    monkeypatch.setattr(onehot_agg, "onehot_sums", spy)
    return calls


def test_both_routes_agree_and_the_kernel_route_runs_at_small_n(monkeypatch):
    """The counts and f64 sums go through onehot_sums at any n (no row
    gate, unlike the reference's f32 TPU kernel), and agree with np.add.at
    in f64. Each distinct live mask is one count row: make_case gives four
    null masks, and two columns without one share ``valid``."""
    keys, key_nulls, valid, vals, val_nulls = make_case(300, [3, 2], 9)
    cols, nulls, ops = columns_for(vals, val_nulls, OPS)
    calls = spy_on_kernel(monkeypatch)
    via_kernel = port_agg.dense_group_aggregate(
        [as_port(k) for k in keys], [as_port(m) for m in key_nulls], [3, 2],
        torch.from_numpy(valid), [as_port(c) for c in cols],
        as_port_masks(nulls), [port_agg.AggOp(o) for o in ops],
    )
    n_f64_sums = 3  # SUMs over the three float columns widen to f64
    assert calls == [((5 + n_f64_sums, 300), 12)]
    check_against_numpy(via_kernel, keys, key_nulls, [3, 2], valid, cols, nulls, ops)


def test_value_rows_beyond_max_rows_split_into_calls(monkeypatch):
    """More value rows than one kernel call takes go through several calls
    of at most MAX_ROWS rows each, and agree with np.add.at in f64."""
    keys, key_nulls, valid, vals, val_nulls = make_case(500, [3, 2], 4)
    cols, nulls, ops = columns_for(vals, val_nulls, OPS)
    calls = spy_on_kernel(monkeypatch)
    monkeypatch.setattr(onehot_agg, "MAX_ROWS", 3)
    split = port_agg.dense_group_aggregate(
        [as_port(k) for k in keys], [as_port(m) for m in key_nulls], [3, 2],
        torch.from_numpy(valid), [as_port(c) for c in cols],
        as_port_masks(nulls), [port_agg.AggOp(o) for o in ops],
    )
    R = 5 + 3  # distinct live rows, then the three f64 sums
    assert [c[0][0] for c in calls] == [3, 3, 2] and R == 8
    check_against_numpy(split, keys, key_nulls, [3, 2], valid, cols, nulls, ops)


@pytest.mark.parametrize("route_slots", [2048, 65536])
def test_nan_stays_in_its_group(monkeypatch, route_slots):
    """SQL: a NaN in a SUM poisons its own group only. The reference's
    dense path multiplies a one-hot by the values, so on the CPU one NaN
    turns every group's sum into NaN: a divergence on the reference's side,
    logged in ROADMAP queue 3. The port selects instead of multiplying.
    ``route_slots`` is the size of the slot space: 2048 puts the three
    groups in 4 slots; 65536 adds a second key so that they land in 65,536
    slots, at 0, 16384 and 32768."""
    calls = spy_on_kernel(monkeypatch)
    n = 1000
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 3, n).astype(np.int32)
    x = rng.random(n)
    x[np.nonzero(codes == 1)[0][0]] = np.nan
    key_codes, key_nulls, vocab = [torch.from_numpy(codes)], [None], [3]
    if route_slots > 2048:
        key_codes.append(torch.zeros(n, dtype=torch.int32))
        key_nulls.append(None)
        vocab.append(route_slots // 4 - 1)
    stride = route_slots // 4 if route_slots > 2048 else 1
    res = port_agg.dense_group_aggregate(
        key_codes, key_nulls, vocab, torch.ones(n, dtype=torch.bool),
        [torch.from_numpy(x)], [None], [port_agg.AggOp.SUM],
    )
    P = 4 * stride
    assert calls == [((2, n), P)]
    sums = res.values[0].numpy()
    assert np.isnan(sums[stride]) and int(np.isnan(sums).sum()) == 1
    for g in (0, 2):
        np.testing.assert_allclose(sums[g * stride], x[codes == g].sum(), rtol=1e-12)
    others = np.ones(P, dtype=bool)
    others[[0, stride, 2 * stride]] = False
    assert not sums[others].any()  # unoccupied slots, the NULL-key one too


@pytest.mark.parametrize(
    "n,vocab,seed", [(20000, [70, 60], 11), (30000, [255, 255], 12)]
)
def test_dense_aggregate_above_2048_slots_runs_the_kernel(monkeypatch, n, vocab, seed):
    """A dense slot space beyond the reference's 2048-slot one-hot gate
    (4,331 and 65,536 slots) still sends its counts and f64 SUMs through
    onehot_sums, and matches the reference's dense_group_aggregate (its
    CPU scatter route there): counts exact, floats within rtol 1e-9."""
    keys, key_nulls, valid, vals, val_nulls = make_case(n, vocab, seed)
    cols, nulls, ops = columns_for(vals, val_nulls, OPS)
    calls = spy_on_kernel(monkeypatch)
    P = (vocab[0] + 1) * (vocab[1] + 1)
    ref = ref_agg.dense_group_aggregate(
        [as_ref(k) for k in keys], [as_ref(m) for m in key_nulls], vocab,
        jnp.asarray(valid), [as_ref(c) for c in cols], [as_ref(m) for m in nulls],
        [ref_agg.AggOp(o) for o in ops],
    )
    port = port_agg.dense_group_aggregate(
        [as_port(k) for k in keys], [as_port(m) for m in key_nulls], vocab,
        torch.from_numpy(valid), [as_port(c) for c in cols],
        as_port_masks(nulls), [port_agg.AggOp(o) for o in ops],
    )
    assert calls == [((5 + 3, n), P)]
    assert np.array_equal(port.valid.numpy(), np.asarray(ref.valid))
    for i, (pv, rv) in enumerate(zip(port.values, ref.values)):
        assert_close(pv.numpy(), rv, f"value {i} ({ops[i]})")
    for i, (pm, rm) in enumerate(zip(port.value_nulls, ref.value_nulls)):
        assert (pm is None) == (rm is None)
        if rm is not None:
            assert np.array_equal(pm.numpy(), np.asarray(rm)), f"value null {i}"


def test_columns_without_nulls_share_one_count_row(monkeypatch):
    """Live-row deduplication: columns with no null mask share ``valid``'s
    count row, columns with one null mask share its row, and each count is
    still right, for a mix of nullable and non-nullable columns."""
    n = 2000
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 5, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    m1, m2 = rng.random(n) < 0.3, rng.random(n) < 0.5
    a, b = rng.random(n), rng.integers(0, 9, n)
    cols = [a, b, a, b, a, a]
    nulls = [None, None, m1, m1, m2, None]
    ops = ["count", "sum", "count", "sum", "count", "sum"]
    calls = spy_on_kernel(monkeypatch)
    t_m1 = torch.from_numpy(m1)  # one tensor: one count row
    res = port_agg.dense_group_aggregate(
        [torch.from_numpy(codes)], [None], [5], torch.from_numpy(valid),
        [torch.from_numpy(c) for c in cols],
        [None, None, t_m1, t_m1, torch.from_numpy(m2), None],
        [port_agg.AggOp(o) for o in ops],
    )
    # live rows: valid, valid & ~m1, valid & ~m2; f64 sums: columns 0 and 5
    assert calls == [((3 + 1, n), 6)]
    check_against_numpy(res, [codes], [None], [5], valid, cols, nulls, ops)
