"""Arrow -> DeviceBatch in both packages: the port's columns, masks,
dictionaries and capacities must equal the reference's bit for bit."""

import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu.columnar import arrow_interop as ref_io
from ballista_tpu_torch.columnar import arrow_interop as port_io
from ballista_tpu_torch.columnar.batch import CapacityLadder, round_capacity
from ballista_tpu_torch.columnar.bridge import batch_from_numpy


def make_table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    words = np.array(["delta", "alpha", "", "charlie", "bravo", "zulu", "Éclair"])
    null = rng.random(n) < 0.2
    days = rng.integers(8000, 10600, n)
    return pa.table({
        "i32": pa.array(rng.integers(-1000, 1000, n).astype(np.int32)),
        "i64_small": pa.array(rng.integers(-(2**31) + 1, 2**31 - 1, n, dtype=np.int64)),
        "i64_big": pa.array(rng.integers(-(2**40), 2**40, n, dtype=np.int64)),
        "i64_null": pa.array(rng.integers(0, 50, n, dtype=np.int64), mask=null),
        "f64": pa.array(rng.normal(0, 1e3, n)),
        "f64_null": pa.array(rng.normal(0, 1, n), mask=rng.random(n) < 0.3),
        "f32": pa.array(rng.random(n).astype(np.float32)),
        "flag": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "day": pa.array(
            [datetime.date(1970, 1, 1) + datetime.timedelta(days=int(d)) for d in days]
        ),
        "s": pa.array(words[rng.integers(0, len(words), n)].tolist()),
        "s_null": pa.array(
            words[rng.integers(0, len(words), n)].tolist(), mask=rng.random(n) < 0.25
        ),
    })


def ref_numpy(b):
    """A reference DeviceBatch as plain numpy (the bridge's input)."""
    return dict(
        fields=[(f.name, f.dtype.value, f.nullable) for f in b.schema],
        columns=[np.asarray(c) for c in b.columns],
        valid=np.asarray(b.valid),
        nulls=[None if m is None else np.asarray(m) for m in b.nulls],
        dictionaries={k: list(d.values) for k, d in b.dictionaries.items()},
    )


def assert_same_batch(ref, port):
    r = ref_numpy(ref)
    assert [(f.name, f.dtype.value, f.nullable) for f in port.schema] == r["fields"]
    assert port.capacity == ref.capacity
    assert np.array_equal(port.valid.numpy(), r["valid"])
    for pc, rc in zip(port.columns, r["columns"]):
        got = pc.numpy()
        assert got.dtype == rc.dtype
        assert np.array_equal(got.view(np.uint8), rc.view(np.uint8))
    for pm, rm in zip(port.nulls, r["nulls"]):
        assert (pm is None) == (rm is None)
        if rm is not None:
            assert np.array_equal(pm.numpy(), rm)
    assert {k: list(d.values) for k, d in port.dictionaries.items()} == r["dictionaries"]


@pytest.mark.parametrize(
    "n,batch_rows,seed",
    [(1, 2048, 0), (2047, 2048, 1), (5000, 2048, 2), (9000, 4096, 3), (3001, 1000, 4)],
)
def test_table_from_arrow_matches_reference(n, batch_rows, seed):
    t = make_table(n, seed)
    ref = ref_io.table_from_arrow(t, batch_rows)
    port = port_io.table_from_arrow(t, batch_rows, device="cpu")
    assert len(port) == len(ref) == -(-n // batch_rows)
    for rb, pb in zip(ref, port):
        assert_same_batch(rb, pb)
    # narrowing is decided per table, as in the reference
    assert port_io.narrowable_int64_cols(t) == ref_io.narrowable_int64_cols(t)
    assert port[0].columns[1].dtype == torch.int32  # i64_small narrowed
    assert port[0].columns[2].dtype == torch.int64  # i64_big kept


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_from_arrow_and_round_trip(seed):
    t = make_table(777, seed)
    ref = ref_io.batch_from_arrow(t)
    port = port_io.batch_from_arrow(t, device="cpu")
    assert_same_batch(ref, port)
    back = pa.Table.from_batches([port_io.batch_to_arrow(port)])
    assert back.equals(pa.Table.from_batches([ref_io.batch_to_arrow(ref)]))
    assert back.column("s_null").equals(t.column("s_null"))
    assert back.column("day").equals(t.column("day"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bridge_carries_a_reference_batch(seed):
    t = make_table(3000, seed)
    for ref in ref_io.table_from_arrow(t, 2048):
        port = batch_from_numpy(**ref_numpy(ref), device="cpu")
        assert_same_batch(ref, port)
        # and a filtered (masked) batch keeps its mask
        keep = np.asarray(ref.valid) & (np.arange(ref.capacity) % 3 == 0)
        masked = ref.with_valid(ref.valid & keep)
        assert_same_batch(masked, batch_from_numpy(**ref_numpy(masked), device="cpu"))


def test_empty_and_capacity_ladder():
    from ballista_tpu.columnar.batch import round_capacity as ref_round

    for n in (0, 1, 2047, 2048, 2049, 3_000_607, 903_455, 1 << 21):
        assert round_capacity(n) == ref_round(n)
    assert CapacityLadder(8, 3).round(100) == 216
    t = make_table(0, 0)
    ref = ref_io.table_from_arrow(t, 2048)
    port = port_io.table_from_arrow(t, 2048, device="cpu")
    assert len(port) == len(ref) == 1
    assert_same_batch(ref[0], port[0])
