"""64-bit column hashing (port of ``ballista_tpu/ops/hashing.py``).

A splitmix64 finalizer per column, combined across columns, bit-identical
to the reference's uint64 hash. torch has no uint64 ``+``, ``>>`` or ``%``,
so the hash runs on int64 bit patterns: add, xor and multiply wrap the same
way in two's complement, and a logical right shift is an arithmetic shift
masked to the bits that stay. The result is the uint64 hash's bit pattern
as int64 (the reference's ``.view(int64)``).

This int64 chain is the plain version (``hash_columns_plain``). On a CUDA
tensor ``hash_columns`` launches the hand-written partition-hash kernel
(``csrc/partition_hash.cu``, ``ops/partition.py``) in its hash-only mode,
or raises; on a CPU tensor it runs the chain.
"""

from __future__ import annotations

import torch


def _i64(u: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_C1 = _i64(0x9E3779B97F4A7C15)
_C2 = _i64(0xBF58476D1CE4E5B9)
_C3 = _i64(0x94D049BB133111EB)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int64 bit pattern."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = x + _C1
    x = (x ^ _shr(x, 30)) * _C2
    x = (x ^ _shr(x, 27)) * _C3
    return x ^ _shr(x, 31)


# the bits of the positive quiet float32 NaN (numpy's and torch's ``nan``)
_NAN_F32_BITS = 0x7FC00000


def _to_u64(col: torch.Tensor) -> torch.Tensor:
    """Any column as 64-bit lanes (int64 bit patterns). Floats hash by the
    bit pattern of their float32 value after ``+ 0.0``, which makes -0.0
    hash as +0.0; integers sign-extend, as the reference's cast to uint64
    does. Every NaN hashes as the positive quiet NaN, whatever its sign and
    payload, so that the NaNs GROUP BY puts in one group hash alike (the
    reference keeps the CPU's NaN bits; ROADMAP queue 3)."""
    if col.dtype.is_floating_point:
        bits = (col.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return torch.where(torch.isnan(col), _NAN_F32_BITS, bits)
    return col.to(torch.int64)


def hash_columns(cols: list[torch.Tensor]) -> torch.Tensor:
    """Row-wise combined hash of one or more columns: the uint64 hash's
    bits as int64[n]. The kernel on CUDA tensors, the plain chain on CPU
    tensors."""
    from ballista_tpu_torch.ops import partition

    n = len(cols)
    return partition.partition_hash(list(cols), [None] * n, [None] * n, None, 0)


def hash_columns_plain(cols: list[torch.Tensor]) -> torch.Tensor:
    """The plain version of ``hash_columns``: the int64 chain."""
    h = torch.zeros(cols[0].shape, dtype=torch.int64, device=cols[0].device)
    for c in cols:
        h = _splitmix64(h ^ _splitmix64(_to_u64(c)))
    return h
