"""Batch concatenation with dictionary unification (port of
``ballista_tpu/ops/concat.py``).

Pipeline-breaking operators (sort, final aggregate) merge a partition's
batches into one. String columns from different sources may carry different
dictionaries; they are remapped onto a merged, still sorted, dictionary
before the device concat.
"""

from __future__ import annotations

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch, round_capacity
from ballista_tpu_torch.columnar.dict_util import merge_many, remap_codes
from ballista_tpu_torch.datatypes import DataType, Schema
from ballista_tpu_torch.errors import InternalError


def unify_dictionaries(
    batches: list[DeviceBatch], schema: Schema
) -> list[DeviceBatch]:
    """Remap STRING columns of all batches onto shared dictionaries."""
    out = batches
    for i, field in enumerate(schema):
        if field.dtype != DataType.STRING:
            continue
        names = [b.schema.fields[i].name for b in out]
        dicts = [b.dictionaries.get(n) for b, n in zip(out, names)]
        if any(d is None for d in dicts):
            raise InternalError(
                f"string column {field.name!r} missing dictionary in concat"
            )
        if all(d.values == dicts[0].values for d in dicts):
            continue
        merged, remaps = merge_many(tuple(dicts))
        new_batches = []
        for b, n, remap in zip(out, names, remaps):
            cols = list(b.columns)
            cols[i] = remap_codes(b.columns[i], remap)
            dd = dict(b.dictionaries)
            dd[n] = merged
            new_batches.append(
                DeviceBatch(
                    schema=b.schema,
                    columns=tuple(cols),
                    valid=b.valid,
                    nulls=b.nulls,
                    dictionaries=dd,
                )
            )
        out = new_batches
    return out


def _cat_padded(parts: list[torch.Tensor], cap: int) -> torch.Tensor:
    # torch.cat promotes mixed int32/int64 parts like jnp.concatenate
    arr = torch.cat(parts)
    if arr.shape[0] < cap:
        arr = torch.cat([arr, arr.new_zeros(cap - arr.shape[0])])
    return arr


def concat_batches(batches: list[DeviceBatch]) -> DeviceBatch:
    """Concatenate batches (same schema) into one batch with bucketed
    capacity. Invalid rows are carried along."""
    if not batches:
        raise InternalError("concat of zero batches")
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    batches = unify_dictionaries(batches, schema)
    cap = round_capacity(sum(b.capacity for b in batches))
    cols = [
        _cat_padded([b.columns[i] for b in batches], cap) for i in range(len(schema))
    ]
    nulls: list[torch.Tensor | None] = []
    for i in range(len(schema)):
        masks = [b.nulls[i] for b in batches]
        if all(m is None for m in masks):
            nulls.append(None)
            continue
        nulls.append(
            _cat_padded(
                [
                    m if m is not None else torch.zeros_like(b.valid)
                    for m, b in zip(masks, batches)
                ],
                cap,
            )
        )
    return DeviceBatch(
        schema=schema,
        columns=tuple(cols),
        valid=_cat_padded([b.valid for b in batches], cap),
        nulls=tuple(nulls),
        dictionaries=dict(batches[0].dictionaries),
    )
