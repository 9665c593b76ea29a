"""Permutation primitives: the port's sort substrate (port of
``ballista_tpu/ops/perm.py``).

Every multi-key sort is a chain of single-key STABLE argsort passes, least
significant key first (LSD), as in the reference, so order among equal
keys is the reference's exactly. The reference chains passes because the
TPU compiler's multi-operand sort compiles slowly; on the card each pass
is one ``torch.sort(stable=True)``. Gathers of many columns by one
permutation stack the columns of each dtype and gather once, which on the
card is one launch instead of one per column.
"""

from __future__ import annotations

import torch


def stable_argsort(col: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """Stable argsort of one key (int64 positions). Descending keys are
    reversed the reference's way (floats negated, integers bit-inverted:
    ~x is -x-1, a total order reversal that keeps INT_MIN in range), so NaN
    sorts last in both directions."""
    c = col.to(torch.int32) if col.dtype == torch.bool else col
    if c.dtype.is_floating_point:
        # The card's radix sort orders bit patterns, so it puts a NaN with
        # the sign bit set (as negating a NaN gives) first; the CPU's sort
        # and the reference's put every NaN last and keep +-0.0 in input
        # order. One NaN and one zero make the two agree.
        if descending:
            c = -c
        c = torch.where(torch.isnan(c), torch.full_like(c, float("nan")), c + 0.0)
    elif descending:
        c = ~c
    return torch.sort(c, stable=True).indices


def take(col: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Gather one column by a permutation."""
    return col[perm]


def group_by_dtype(cols: list) -> dict:
    """Positions of ``cols`` grouped by dtype: the index plan of stacked
    gathers."""
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, c in enumerate(cols):
        by_dtype.setdefault(c.dtype, []).append(i)
    return by_dtype


def take_many(cols: list, perm: torch.Tensor) -> list:
    """Gather many columns by one permutation: one gather per distinct
    dtype, the columns of a dtype stacked on a trailing axis."""
    out: list = [None] * len(cols)
    for idxs in group_by_dtype(cols).values():
        if len(idxs) == 1:
            out[idxs[0]] = cols[idxs[0]][perm]
            continue
        g = torch.stack([cols[i] for i in idxs], dim=1)[perm]
        for j, i in enumerate(idxs):
            out[i] = g[:, j]
    return out


def take_many_split(
    cols: list, optionals: list, perm: torch.Tensor
) -> tuple[list, list]:
    """One stacked gather over ``cols`` and the non-None entries of
    ``optionals`` (null masks). Returns (gathered cols, gathered optionals
    with None kept in place)."""
    present = [i for i, m in enumerate(optionals) if m is not None]
    gathered = take_many(list(cols) + [optionals[i] for i in present], perm)
    out_opt: list = [None] * len(optionals)
    for j, i in enumerate(present):
        out_opt[i] = gathered[len(cols) + j]
    return gathered[: len(cols)], out_opt


def take_batch(cols: list, nulls: list, valid: torch.Tensor, perm: torch.Tensor):
    """Gather columns, null masks and ``valid`` by ``perm`` in one stacked
    pass: (columns, null masks, valid)."""
    gathered, out_nulls = take_many_split([valid] + list(cols), list(nulls), perm)
    return gathered[1:], out_nulls, gathered[0]


def refine_perm(
    perm: torch.Tensor, col: torch.Tensor, descending: bool = False
) -> torch.Tensor:
    """One LSD pass: reorder ``perm`` by ``col[perm]``, stably, so earlier
    passes' order holds among equal keys."""
    return perm[stable_argsort(col[perm], descending)]


def multi_key_perm(passes: list[tuple[torch.Tensor, bool]]) -> torch.Tensor:
    """Permutation sorting by ``passes`` (column, descending), given most
    significant first and run least significant first."""
    perm = torch.arange(passes[0][0].shape[0], device=passes[0][0].device)
    for col, desc in reversed(passes):
        perm = refine_perm(perm, col, desc)
    return perm
