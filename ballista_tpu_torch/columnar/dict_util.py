"""Dictionary algebra for string columns (port of
``ballista_tpu/columnar/dict_util.py``).

Device code only sees int32 codes; string semantics live in the sorted
host dictionaries. Two columns with different dictionaries are compared or
concatenated after remapping both onto a merged dictionary: the remap is a
host-built lookup table gathered on the device.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from ballista_tpu_torch.columnar.batch import Dictionary


def merge_dictionaries(
    a: Dictionary, b: Dictionary
) -> tuple[Dictionary, np.ndarray, np.ndarray]:
    """Merged sorted dictionary + code remap tables for each input
    (``remap_a[old_code] = new_code``). The merge stays sorted, so remapped
    codes still compare like the strings they encode."""
    merged = tuple(sorted(set(a.values) | set(b.values)))
    pos = {v: i for i, v in enumerate(merged)}
    remap_a = np.asarray([pos[v] for v in a.values], dtype=np.int32)
    remap_b = np.asarray([pos[v] for v in b.values], dtype=np.int32)
    return Dictionary(merged), remap_a, remap_b


def remap_codes(codes: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """Gather codes through a host remap table (empty table -> unchanged,
    the column is all-null)."""
    if len(table) == 0:
        return codes
    t = torch.from_numpy(np.ascontiguousarray(table)).to(codes.device)
    return t[codes.clamp(0, len(table) - 1).long()]


def bisect_left(d: Dictionary, s: str) -> int:
    return bisect.bisect_left(d.values, s)


def bisect_right(d: Dictionary, s: str) -> int:
    return bisect.bisect_right(d.values, s)
