"""Dictionary algebra for string columns (port of
``ballista_tpu/columnar/dict_util.py``).

Device code only sees int32 codes; string semantics live in the sorted
host dictionaries. Two columns with different dictionaries are compared or
concatenated after remapping both onto a merged dictionary: the remap is a
host-built lookup table gathered on the device.
"""

from __future__ import annotations

import bisect
import weakref

import numpy as np
import torch

from ballista_tpu_torch.columnar.batch import Dictionary


# Results computed from dictionaries, by a tag and the identity of the
# dictionaries (see memo). An entry goes when one of its dictionaries is
# collected (a weakref.finalize callback), so it lives no longer than the
# tables and batches its dictionaries came from, and an id is never reused
# while an entry holds it.
_MEMO: dict[tuple, object] = {}
_MEMO_MAX = 1024


def memo(tag: tuple, dicts: tuple[Dictionary, ...], compute):
    """``compute()``, cached by ``tag`` and the identity of ``dicts``. A warm
    query meets the same dictionary objects again, and a customer-sized
    dictionary costs a Python pass over its strings each time. Callers only
    read the cached values."""
    key = (tag, *map(id, dicts))
    hit = _MEMO.get(key)
    if hit is not None:
        return hit
    out = compute()
    if len(_MEMO) >= _MEMO_MAX:
        _MEMO.clear()
    _MEMO[key] = out
    for d in {id(d): d for d in dicts}.values():
        weakref.finalize(d, _MEMO.pop, key, None)
    return out


def merge_many(dicts: tuple[Dictionary, ...]) -> tuple[Dictionary, tuple[np.ndarray, ...]]:
    """One merged sorted dictionary for all of ``dicts``, and each one's
    code remap table (``remap[old_code] = new_code``). The merge stays
    sorted, so remapped codes still compare like the strings they encode.
    Cached by the inputs' identity (``memo``)."""

    def compute():
        merged = tuple(sorted(set().union(*(d.values for d in dicts))))
        pos = {v: i for i, v in enumerate(merged)}
        remaps = tuple(
            np.fromiter((pos[v] for v in d.values), dtype=np.int32, count=len(d.values))
            for d in dicts
        )
        return Dictionary(merged), remaps

    return memo(("merge",), dicts, compute)


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
