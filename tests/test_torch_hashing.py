"""The port's int64-emulated splitmix64 row hash against the reference's
uint64 ``hash_columns``, bit for bit: int32, int64, f32, f64 and bool
columns, alone and combined, with -0.0, NaN, +-inf and integer extremes.
NaNs with a sign bit or a payload are the one place the two differ: the
port hashes every NaN alike, the reference keeps the CPU's NaN bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ballista_tpu.ops import hashing as ref_hashing
from ballista_tpu_torch.ops import hashing as port_hashing


# NaNs with the sign bit, a payload, and a signaling NaN
ODD_NANS = np.array(
    [0xFFF8000000000000, 0x7FF8DEADBEEF0001, 0x7FF0000000000123], dtype=np.uint64
).view(np.float64)


def column(kind: str, n: int, seed: int, odd_nans: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind in ("i64", "i32"):
        dt = np.int64 if kind == "i64" else np.int32
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, n, dtype=dt)
        x[:4] = [info.min, info.max, 0, -1]
        return x
    if kind == "bool":
        return rng.random(n) < 0.5
    x = rng.normal(0, 1e6, n)
    x[:7] = [-0.0, 0.0, np.nan, np.inf, -np.inf, 1e300, -1e-300]
    if odd_nans:
        x[7:10] = ODD_NANS
    if kind == "f64":
        return x
    with np.errstate(over="ignore", invalid="ignore"):  # 1e300 narrows to inf
        return x.astype(np.float32)


def hashes(cols):
    want = np.asarray(ref_hashing.hash_columns([jnp.asarray(c) for c in cols])).view(np.int64)
    got = port_hashing.hash_columns([torch.from_numpy(c) for c in cols]).numpy()
    return got, want


@pytest.mark.parametrize("kind", ["i32", "i64", "f32", "f64", "bool"])
def test_single_column_hash_is_bit_identical(kind):
    got, want = hashes([column(kind, 4099, 1)])
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "kinds", [("i64", "i32"), ("f64", "i64"), ("i32", "f32", "bool"), ("f64", "f32", "i64", "i32")]
)
def test_combined_hash_is_bit_identical(kinds):
    got, want = hashes([column(k, 2049, 10 + i) for i, k in enumerate(kinds)])
    assert np.array_equal(got, want)


def test_negative_zero_hashes_as_zero():
    h = port_hashing.hash_columns([torch.tensor([0.0, -0.0, 0.0], dtype=torch.float64)])
    assert len(set(h.tolist())) == 1


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_every_nan_hashes_alike(dtype):
    # one GROUP BY group, one hash: sign and payload do not split NaNs, and
    # they hash as the reference hashes the positive quiet NaN
    with np.errstate(invalid="ignore"):
        nans = np.concatenate([[np.nan], ODD_NANS]).astype(dtype)
    got = port_hashing.hash_columns([torch.from_numpy(nans)]).numpy()
    want = np.asarray(ref_hashing.hash_columns([jnp.asarray(nans[:1])])).view(np.int64)
    assert np.isnan(nans).all()
    assert np.array_equal(got, np.repeat(want, len(nans)))


@pytest.mark.gpu
def test_hash_on_card_matches_cpu():
    # int64 multiplies must wrap on the card as on the CPU, and every NaN
    # must hash alike on both
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cols = [
        column(k, 1 << 20, 30 + i, odd_nans=True)
        for i, k in enumerate(["i64", "f64", "f32", "i32"])
    ]
    want = port_hashing.hash_columns([torch.from_numpy(c) for c in cols])
    got = port_hashing.hash_columns([torch.from_numpy(c).cuda() for c in cols]).cpu()
    assert torch.equal(got, want)
