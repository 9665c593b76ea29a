"""Compaction: move live rows to the front of a batch (port of
``ballista_tpu/ops/compact.py``).

Filters only clear validity bits. Before operators that care where rows
sit, a compaction gathers the live rows to the front, in order, by one
stable argsort pass over the invalid flag.
"""

from __future__ import annotations

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.ops.perm import stable_argsort, take_batch


def compact(batch: DeviceBatch) -> DeviceBatch:
    order = stable_argsort(~batch.valid)
    cols, nulls, _ = take_batch(list(batch.columns), list(batch.nulls), batch.valid, order)
    iota = torch.arange(batch.capacity, dtype=torch.int32, device=batch.device)
    return DeviceBatch(
        schema=batch.schema,
        columns=tuple(cols),
        nulls=tuple(nulls),
        valid=iota < batch.count_valid(),
        dictionaries=dict(batch.dictionaries),
    )
