"""The port's sort substrate against the reference's on the same numpy
input, bit for bit: ``ops/perm.py`` (gathers, stacked gathers, LSD passes),
``ops/compact.py`` and ``ops/search.py``, with NaN, -0.0, null masks, ties
and int64 extremes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ballista_tpu.columnar.batch import DeviceBatch as RefBatch
from ballista_tpu.datatypes import DataType as RefType, Field as RefField, Schema as RefSchema
from ballista_tpu.ops.compact import compact as ref_compact
from ballista_tpu.ops import perm as ref_perm
from ballista_tpu.ops import search as ref_search
from ballista_tpu_torch.columnar.batch import DeviceBatch as PortBatch
from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.ops.compact import compact as port_compact
from ballista_tpu_torch.ops import perm as port_perm
from ballista_tpu_torch.ops import search as port_search

I64 = np.iinfo(np.int64)


def columns(n: int, seed: int) -> dict:
    """Columns of every kind with the awkward values in front."""
    rng = np.random.default_rng(seed)
    f64 = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -1.5]), n)
    i64 = rng.integers(-3, 4, n).astype(np.int64)
    i64[:3] = [I64.min, I64.max, 0]
    return {
        "f64": f64,
        "f32": f64[::-1].astype(np.float32).copy(),
        "i64": i64,
        "i32": rng.integers(-5, 5, n).astype(np.int32),
        "bool": rng.random(n) < 0.5,
    }


def perm_of(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).permutation(n)


def same(got: torch.Tensor, want) -> bool:
    g, w = got.numpy(), np.asarray(want)
    return g.dtype == w.dtype and np.array_equal(g, w, equal_nan=g.dtype.kind == "f")


@pytest.mark.parametrize("n", [7, 3000])
def test_take_many_and_split_match_reference(n):
    cols = list(columns(n, n).values())
    nulls = [np.random.default_rng(1).random(n) < 0.3, None, None, np.random.default_rng(2).random(n) < 0.5, None]
    p = perm_of(n, 3)
    want = ref_perm.take_many([jnp.asarray(c) for c in cols], jnp.asarray(p))
    got = port_perm.take_many([torch.from_numpy(c) for c in cols], torch.from_numpy(p))
    assert all(same(g, w) for g, w in zip(got, want))
    assert same(port_perm.take(torch.from_numpy(cols[0]), torch.from_numpy(p)),
                ref_perm.take(jnp.asarray(cols[0]), jnp.asarray(p)))
    wc, wn = ref_perm.take_many_split(
        [jnp.asarray(c) for c in cols], [None if m is None else jnp.asarray(m) for m in nulls],
        jnp.asarray(p),
    )
    gc, gn = port_perm.take_many_split(
        [torch.from_numpy(c) for c in cols],
        [None if m is None else torch.from_numpy(m) for m in nulls],
        torch.from_numpy(p),
    )
    assert all(same(g, w) for g, w in zip(gc, wc))
    assert [m is None for m in gn] == [m is None for m in wn]
    assert all(same(g, w) for g, w in zip(gn, wn) if g is not None)


def test_take_batch_matches_reference():
    n = 2048
    cols = list(columns(n, 5).values())
    nulls = [None, np.random.default_rng(6).random(n) < 0.2, None, None, None]
    valid = np.random.default_rng(7).random(n) < 0.7
    p = perm_of(n, 8)
    wc, wn, wv = ref_perm.take_batch(
        [jnp.asarray(c) for c in cols], [None if m is None else jnp.asarray(m) for m in nulls],
        jnp.asarray(valid), jnp.asarray(p),
    )
    gc, gn, gv = port_perm.take_batch(
        [torch.from_numpy(c) for c in cols],
        [None if m is None else torch.from_numpy(m) for m in nulls],
        torch.from_numpy(valid), torch.from_numpy(p),
    )
    assert same(gv, wv)
    assert all(same(g, w) for g, w in zip(gc, wc))
    assert gn[0] is None and same(gn[1], wn[1])


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("kind", ["f64", "f32", "i64", "i32", "bool"])
def test_refine_perm_matches_reference(kind, descending):
    n = 3001
    col = columns(n, 11)[kind]
    p = perm_of(n, 12)
    want = ref_perm.refine_perm(jnp.asarray(p.astype(np.int32)), jnp.asarray(col), descending)
    got = port_perm.refine_perm(torch.from_numpy(p), torch.from_numpy(col), descending)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [16, 5000])
def test_multi_key_perm_with_null_flags_matches_reference(n):
    # the group sort's pass shape: ~valid, then (null flag, zeroed key)
    c = columns(n, 21)
    rng = np.random.default_rng(22)
    valid = rng.random(n) < 0.8
    null = rng.random(n) < 0.25
    zeroed = np.where(null, 0.0, c["f64"])
    passes = [(~valid, False), (null, False), (zeroed, False), (c["i64"], True), (c["bool"], False)]
    want = ref_perm.multi_key_perm([(jnp.asarray(a), d) for a, d in passes])
    got = port_perm.multi_key_perm([(torch.from_numpy(a), d) for a, d in passes])
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_matches_reference(seed):
    n = 3000
    c = columns(n, seed)
    rng = np.random.default_rng(seed + 40)
    names = ["a", "b", "c"]
    arrays = [c["f64"], c["i64"], c["i32"]]
    nulls = [rng.random(n) < 0.3, None, rng.random(n) < 0.1]
    valid = rng.random(4096) < 0.6
    ref = RefBatch.from_host(
        RefSchema([RefField(k, RefType(t)) for k, t in zip(names, ["float64", "int64", "int32"])]),
        arrays, nulls=nulls, capacity=4096,
    )
    port = PortBatch.from_host(
        Schema([Field(k, DataType(t)) for k, t in zip(names, ["float64", "int64", "int32"])]),
        arrays, nulls=nulls, capacity=4096, device="cpu",
    )
    want = ref_compact(ref.with_valid(jnp.asarray(valid)))
    got = port_compact(port.with_valid(torch.from_numpy(valid)))
    assert same(got.valid, want.valid)
    for g, w in zip(got.columns, want.columns):
        assert same(g, w)
    for g, w in zip(got.nulls, want.nulls):
        assert (g is None) == (w is None) and (g is None or same(g, w))


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
def test_searchsorted_matches_reference(side, dtype):
    rng = np.random.default_rng(5)
    if dtype == np.float64:
        a = np.sort(rng.choice(np.array([-np.inf, -1.0, 0.0, 0.0, 2.5, np.inf]), 500))
        v = rng.choice(np.array([-np.inf, -0.0, 0.0, 1.0, 2.5, 3.0, np.inf]), 700)
    else:
        info = np.iinfo(dtype)
        a = np.sort(rng.integers(-20, 20, 500).astype(dtype))
        a[-1] = info.max
        v = rng.integers(-25, 25, 700).astype(dtype)
        v[:3] = [info.min, info.max, 0]
    want = ref_search.searchsorted(jnp.asarray(a), jnp.asarray(v), side=side)
    got = port_search.searchsorted(torch.from_numpy(a), torch.from_numpy(v), side=side)
    assert np.array_equal(got.numpy(), np.asarray(want))
