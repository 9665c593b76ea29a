"""The port's stable argsort and multi-key permutation against the
reference's (ballista_tpu/ops/perm.py) on the same input: floats with
+-0.0, NaN, a NaN with its sign bit set, +-inf and ties, integers at
their extremes, booleans, both directions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ballista_tpu.ops import perm as ref_perm
from ballista_tpu_torch.ops import perm as port_perm

SIGNED_NAN = np.frombuffer(
    np.array([0xFFF8000000000001], dtype=np.uint64).tobytes(), dtype=np.float64
)[0]
SPECIALS = [0.0, -0.0, np.nan, SIGNED_NAN, np.inf, -np.inf, 1.0, -1.0, 1.0, -0.0]


def float_column(n: int, seed: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.choice(np.array(SPECIALS), n)
    x[: len(SPECIALS)] = SPECIALS[:n]
    return x.astype(dtype)


def int_column(n: int, seed: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    x = rng.integers(-3, 4, n).astype(dtype)
    x[:4] = [info.min, info.max, 0, info.min][:n]
    return x


def columns(n: int, seed: int):
    return {
        "f64": float_column(n, seed, np.float64),
        "f32": float_column(n, seed + 1, np.float32),
        "i64": int_column(n, seed + 2, np.int64),
        "i32": int_column(n, seed + 3, np.int32),
        "bool": np.random.default_rng(seed + 4).random(n) < 0.5,
    }


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("kind", ["f64", "f32", "i64", "i32", "bool"])
@pytest.mark.parametrize("n", [10, 4099])
def test_stable_argsort_matches_reference(n, kind, descending):
    x = columns(n, n)[kind]
    want = np.asarray(ref_perm.stable_argsort(jnp.asarray(x), descending))
    got = port_perm.stable_argsort(torch.from_numpy(x), descending).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [10, 4099])
def test_multi_key_perm_matches_reference(n):
    cols = columns(n, 7 * n)
    passes = [("bool", False), ("f64", True), ("i32", False), ("f32", False), ("i64", True)]
    want = np.asarray(
        ref_perm.multi_key_perm([(jnp.asarray(cols[k]), d) for k, d in passes])
    )
    got = port_perm.multi_key_perm([(torch.from_numpy(cols[k]), d) for k, d in passes])
    assert np.array_equal(got.numpy(), want)
