"""The one-hot group-sum kernel's plain version against numpy and against
the TPU kernel itself (ballista_tpu/ops/pallas_agg.py, run in Pallas
interpret mode), its launch plan, and (on a card) the CUDA kernel against
the plain version."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ballista_tpu.ops import pallas_agg
from ballista_tpu_torch.ops import onehot_agg


def make_case(n: int, m: int, n_sums: int, P: int, seed: int):
    """rid in [-2, P + 1] (rows outside [0, P) are dropped), m 0/1 count
    rows, then f64 value rows."""
    rng = np.random.default_rng(seed)
    rid = rng.integers(-2, P + 2, n).astype(np.int32)
    vals = np.concatenate([
        (rng.random((m, n)) < 0.8).astype(np.float64),
        rng.random((n_sums, n)) * 100.0,
    ])
    return rid, vals


def numpy_sums(rid, vals, P):
    out = np.zeros((P, vals.shape[0]), dtype=np.float64)
    keep = (rid >= 0) & (rid < P)
    np.add.at(out, rid[keep], vals[:, keep].T)
    return out


@pytest.mark.parametrize("P", [1, 12, 2048])
@pytest.mark.parametrize("n", [1, 1000, 4099])
def test_plain_matches_numpy(n, P):
    rid, vals = make_case(n, 3, 4, P, seed=n + P)
    got = onehot_agg.onehot_sums(torch.from_numpy(rid), torch.from_numpy(vals), P)
    assert got.dtype == torch.float64 and got.shape == (P, 7)
    want = numpy_sums(rid, vals, P)
    assert np.array_equal(got.numpy()[:, :3], want[:, :3])  # counts exact
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def test_nan_stays_in_its_slot():
    rid, vals = make_case(500, 1, 2, 12, seed=7)
    rid[10] = 5
    vals[1, 10] = np.nan
    got = onehot_agg.onehot_sums(torch.from_numpy(rid), torch.from_numpy(vals), 12)
    nan = torch.isnan(got)
    assert nan[5, 1] and int(nan.sum()) == 1
    want = numpy_sums(rid, vals, 12)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=1e-12)


def test_dropped_rows_contribute_nothing():
    rid = torch.tensor([-1, 3, 3, 4, 100, 0], dtype=torch.int32)
    vals = torch.tensor([[1.0, 2.0, 4.0, 8.0, 16.0, 32.0]], dtype=torch.float64)
    got = onehot_agg.onehot_sums(rid, vals, 4)
    assert got[:, 0].tolist() == [32.0, 0.0, 0.0, 6.0]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the reference's Pallas kernel in interpret mode on the CPU."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    pallas_agg._program.cache_clear()
    yield
    pallas_agg._program.cache_clear()


@pytest.mark.parametrize("n,P", [(5000, 12), (3001, 1), (2500, 40)])
def test_plain_matches_the_pallas_kernel(pallas_interpret, n, P):
    m, n_sums = 9, 5
    rid, vals = make_case(n, m, n_sums, P, seed=n)
    rows = [jnp.asarray(vals[i], dtype=jnp.float32) for i in range(m)]
    for j in range(n_sums):
        hi, lo = pallas_agg.split_hi_lo(jnp.asarray(vals[m + j]))
        rows += [hi, lo]
    ref = np.asarray(pallas_agg.onehot_sums(jnp.asarray(rid), rows, P))
    ref_sums = np.stack([ref[:, m + 2 * j] + ref[:, m + 2 * j + 1] for j in range(n_sums)], 1)
    got = onehot_agg.onehot_sums(torch.from_numpy(rid), torch.from_numpy(vals), P).numpy()
    assert np.array_equal(got[:, :m], ref[:, :m])  # counts exact
    # the TPU kernel accumulates in f32 inside a block
    np.testing.assert_allclose(got[:, m:], ref_sums, rtol=1e-5)


@pytest.mark.parametrize(
    "n,R,P",
    [(1, 1, 1), (1 << 21, 14, 12), (1 << 20, 14, 12), (1_000_003, 14, 12),
     (1 << 20, 14, 2048), (300_001, 64, 37), (777, 64, 2048)],
)
def test_launch_plan_covers_every_row_once(n, R, P):
    plan = onehot_agg.launch_plan(n, R, P)
    # blocks own consecutive, disjoint row ranges that cover [0, n)
    assert (plan["nb"] - 1) * plan["rows_per_block"] < n <= plan["nb"] * plan["rows_per_block"]
    assert plan["rows_per_block"] % plan["tile"] == 0
    assert plan["smem"] <= 48 * 1024  # no opt-in needed
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 256
    assert plan["k"] in (1, 4)
    if plan["k"] == 1:
        assert P * R <= plan["threads"]
    assert plan["nb"] * P * R * 8 <= 64 << 20


def test_wrapper_refuses_what_the_kernel_cannot_take():
    rid = torch.zeros(4, dtype=torch.int32, device="meta")
    vals = torch.zeros(1, 4, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        onehot_agg.onehot_sums(rid, vals, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("n,R,P", [(1 << 21, 14, 12), (100_003, 14, 2048), (5, 64, 3)])
def test_cuda_kernel_matches_plain(n, R, P):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rid, vals = make_case(n, 9, R - 9, P, seed=n)
    vals[9, 0] = np.nan
    rid_d = torch.from_numpy(rid).cuda()
    vals_d = torch.from_numpy(vals).cuda()
    before = onehot_agg.launches
    got = onehot_agg.onehot_sums(rid_d, vals_d, P)
    again = onehot_agg.onehot_sums(rid_d, vals_d, P)
    assert onehot_agg.launches == before + 2
    want = onehot_agg.onehot_sums_plain(rid_d, vals_d, P)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int64), again.view(torch.int64))
    assert torch.equal(got[:, :9], want[:, :9])
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    torch.testing.assert_close(got[ok], want[ok], rtol=1e-12, atol=0)
