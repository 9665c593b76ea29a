"""Data types and schemas for the columnar engine.

The reference delegates its type system to Arrow (arrow crate). Here we define
the TPU-representable subset and its mapping onto device dtypes:

- integers / floats / bool map directly to jnp dtypes
- DATE32 is int32 days-since-epoch (same as Arrow date32)
- TIMESTAMP_US is int64 microseconds
- DECIMAL(p, s) is computed as float64 on device (documented deviation: TPC-H
  money columns; checksum comparisons use tolerance — see SURVEY.md §7
  "Float reduction determinism")
- STRING ("utf8") is dictionary-encoded host-side; on device it is an int32
  code column. String predicates are evaluated over the (small) dictionary on
  host and become code-lookup predicates on device.
"""

from __future__ import annotations

import dataclasses
from enum import Enum

import numpy as np

from ballista_tpu_torch.errors import SchemaError


class DataType(Enum):
    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DATE32 = "date32"
    TIMESTAMP_US = "timestamp_us"
    STRING = "string"
    NULL = "null"

    @property
    def is_numeric(self) -> bool:
        return self in (
            DataType.INT32,
            DataType.INT64,
            DataType.FLOAT32,
            DataType.FLOAT64,
        )

    @property
    def is_integer(self) -> bool:
        return self in (DataType.INT32, DataType.INT64)

    @property
    def is_floating(self) -> bool:
        return self in (DataType.FLOAT32, DataType.FLOAT64)

    @property
    def is_temporal(self) -> bool:
        return self in (DataType.DATE32, DataType.TIMESTAMP_US)

    def to_np(self) -> np.dtype:
        """The numpy dtype of this type's device representation."""
        return np.dtype(_DEVICE_DTYPE[self])

    def to_torch(self):
        """The torch dtype of this type's device representation."""
        import torch

        return getattr(torch, _DEVICE_DTYPE[self])


# Device (and host-staging) representation for each logical type. STRING
# becomes its dictionary code column.
_DEVICE_DTYPE: dict[DataType, str] = {
    DataType.BOOL: "bool",
    DataType.INT32: "int32",
    DataType.INT64: "int64",
    DataType.FLOAT32: "float32",
    DataType.FLOAT64: "float64",
    DataType.DATE32: "int32",
    DataType.TIMESTAMP_US: "int64",
    DataType.STRING: "int32",
    DataType.NULL: "bool",
}


def common_type(a: DataType, b: DataType) -> DataType:
    """Binary-op type coercion (the subset of DataFusion's coercion we need)."""
    if a == b:
        return a
    if DataType.NULL in (a, b):
        return b if a == DataType.NULL else a
    order = [DataType.BOOL, DataType.INT32, DataType.INT64, DataType.FLOAT32, DataType.FLOAT64]
    if a in order and b in order:
        return order[max(order.index(a), order.index(b))]
    if {a, b} == {DataType.DATE32, DataType.INT32}:
        return DataType.DATE32
    if {a, b} <= {DataType.DATE32, DataType.INT64, DataType.INT32}:
        return DataType.INT64
    raise SchemaError(f"no common type for {a} and {b}")


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True

    def __repr__(self) -> str:
        return f"{self.name}: {self.dtype.value}"


@dataclasses.dataclass(frozen=True)
class Schema:
    """Ordered, named fields (Arrow Schema equivalent)."""

    fields: tuple[Field, ...]

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise SchemaError(
            f"column {name!r} not found; available: {self.names}"
        )

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise SchemaError(
            f"column {name!r} not found; available: {self.names}"
        )

    def has(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __repr__(self) -> str:
        return "Schema(" + ", ".join(map(repr, self.fields)) + ")"

    def select(self, names: list[str]) -> "Schema":
        return Schema([self.field(n) for n in names])

    def join(self, other: "Schema") -> "Schema":
        return Schema(list(self.fields) + list(other.fields))
