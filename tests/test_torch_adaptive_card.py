"""The adaptive capacity machinery on the card (``-m gpu``; skipped without
one): the capacity shrink's compaction (``exec/shrink.py``) and the
aggregate's presorted arm and sort path (``ops/aggregate.group_aggregate``)
against their results on the CPU, bit for bit. The CPU parity cases
against the reference are in ``tests/test_torch_shrink.py`` and
``tests/test_torch_clustered_agg.py``; this file imports no JAX."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu_torch.columnar.arrow_interop import batch_from_arrow
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.exec.base import TaskContext
from ballista_tpu_torch.exec.shrink import maybe_shrink
from ballista_tpu_torch.ops.aggregate import AggOp, group_aggregate


@pytest.mark.gpu
def test_shrink_on_the_card_matches_the_cpu():
    """The compaction on the card (the bool argsort cut before the gather)
    against its CPU result, learning and speculating."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    n = 1 << 20
    t = pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(np.random.default_rng(0).random(n)),
    })
    rng = np.random.default_rng(1)
    keep = torch.from_numpy(rng.random(1 << 20) < 0.01)
    for_dev = {}
    for dev in ("cpu", "cuda"):
        b = batch_from_arrow(t, device=dev)
        b = b.with_valid(b.valid & keep.to(dev))
        cache: dict = {}
        outs = []
        for _ in range(2):
            ctx = TaskContext(config=BallistaConfig(), plan_cache=cache, device=dev)
            outs.append(maybe_shrink(b, ctx, "site", 0))
            ctx.raise_deferred()
        for_dev[dev] = (cache, [(o.capacity, o.valid.cpu(), [c.cpu() for c in o.columns]) for o in outs])
    assert for_dev["cpu"][0] == for_dev["cuda"][0]
    for (cap, valid, cols), (cap2, valid2, cols2) in zip(for_dev["cpu"][1], for_dev["cuda"][1]):
        assert cap == cap2 and torch.equal(valid, valid2)
        assert all(torch.equal(a, b) for a, b in zip(cols, cols2))


@pytest.mark.gpu
def test_clustered_arm_on_the_card_matches_the_cpu():
    """The presorted arm and the sort path on the card against the CPU, and
    against each other, bit for bit (the fixed-order prefix kernel gives its
    plain version's bits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(7)
    n = 4096
    keys = np.sort(rng.integers(0, 300, n)).astype(np.int64)
    vals = rng.random(n) * 100 * np.pi  # not a decimal
    ivals = rng.integers(-50, 50, n).astype(np.int64)
    valid = rng.random(n) < 0.6  # dead rows between the live ones
    results = []
    for presorted in (False, True):
        on = [
            group_aggregate(
                [torch.from_numpy(keys).to(d)], [None], torch.from_numpy(valid).to(d),
                [torch.from_numpy(x).to(d) for x in (vals, ivals, vals, ivals)], [None] * 4,
                [AggOp.SUM, AggOp.SUM, AggOp.MIN, AggOp.MAX], 1024, presorted=presorted,
            )
            for d in ("cpu", "cuda")
        ]
        cpu, card = on
        flag = "sorted_ok" if presorted else "input_was_sorted"
        assert bool(getattr(cpu, flag)) and bool(getattr(card, flag))
        for a, b in zip(cpu.keys + cpu.values + [cpu.valid], card.keys + card.values + [card.valid]):
            assert np.array_equal(a.numpy().view(np.uint8), b.cpu().numpy().view(np.uint8))
        results.append(card)
    for a, b in zip(results[0].keys + results[0].values, results[1].keys + results[1].values):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
