"""Carry a batch across from the reference's layout.

``batch_from_numpy`` takes a reference ``DeviceBatch`` laid out as plain
numpy arrays (the padded columns, the ``valid`` mask, the null masks and the
dictionary values) and returns the port's ``DeviceBatch`` on ``device`` (the
card unless the caller asks for the CPU), slot for slot. It is the SQL
engine's counterpart of converting a model's weights: the parity tests feed
the same batch to both packages through it.
Only plain Python and numpy values cross, so neither package imports the
other.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch, Dictionary, resolve_device
from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.errors import SchemaError


def batch_from_numpy(
    fields: Sequence[tuple[str, str, bool]],
    columns: Sequence[np.ndarray],
    valid: np.ndarray,
    nulls: Sequence[np.ndarray | None],
    dictionaries: Mapping[str, Sequence[str]],
    device: torch.device | str = "cuda",
) -> DeviceBatch:
    """``fields``: (name, DataType value such as "int64", nullable) per
    column. Every array has the batch's full capacity; the physical dtype of
    each column is kept as given (an int32 column under an INT64 field stays
    narrowed, as in the reference)."""
    device = resolve_device(device)
    schema = Schema([Field(n, DataType(t), bool(nl)) for n, t, nl in fields])
    cap = len(valid)
    if not (len(columns) == len(nulls) == len(schema)):
        raise SchemaError("fields, columns and nulls differ in length")
    for c in columns:
        if len(c) != cap:
            raise SchemaError(f"column of {len(c)} rows in a batch of {cap}")

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=device)  # a copy: inputs may be read-only

    return DeviceBatch(
        schema=schema,
        columns=tuple(put(c) for c in columns),
        valid=put(np.asarray(valid, dtype=bool)),
        nulls=tuple(
            None if m is None else put(np.asarray(m, dtype=bool)) for m in nulls
        ),
        dictionaries={k: Dictionary(tuple(v)) for k, v in dictionaries.items()},
    )
