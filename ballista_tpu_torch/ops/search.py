"""Vectorized binary search (port of ``ballista_tpu/ops/search.py``).

``torch.searchsorted`` with the reference's ``side``. The reference picks
between two ``jnp.searchsorted`` methods by query size, a TPU tuning that
does not change results; the card has one method.
"""

from __future__ import annotations

import torch


def searchsorted(a: torch.Tensor, v: torch.Tensor, side: str = "left") -> torch.Tensor:
    """Insertion points of ``v`` in the sorted ``a`` (int64)."""
    return torch.searchsorted(a, v.to(a.dtype).contiguous(), side=side)
