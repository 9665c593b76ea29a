"""Hash partitioning: the one routing rule of the shuffle and of the
grace-hash spill (port of ``ballista_tpu/ops/partition.py``), and the
CUDA kernel that computes it.

A row's partition id is ``h % K`` (unsigned) of the row hash ``h`` of its
key columns (``ops/hashing.py``); invalid rows get ``K``, a drop bucket.
Key values are zeroed under their null masks first, so every NULL key
routes alike, and a STRING key hashes by its VALUE: its per-batch
dictionary codes go through a table of stable per-value hashes (blake2b),
so batches with different dictionaries route equal strings alike.

On a CUDA tensor ``partition_hash`` launches the hand-written kernel
``csrc/partition_hash.cu`` (built with nvcc at first use, loaded with
ctypes) or raises; on a CPU tensor it runs the plain version
``partition_ids_plain``. ``ops/hashing.hash_columns`` on a CUDA tensor runs
the same kernel in its hash-only mode.

Floats route as the port hashes them: -0.0 with +0.0, and every NaN alike.
The reference's jitted routing folds its ``+ 0.0`` away and routes -0.0
apart from +0.0 (ROADMAP queue 3).
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np
import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.columnar.dict_util import memo
from ballista_tpu_torch.datatypes import DataType
from ballista_tpu_torch.ops import cuda_build
from ballista_tpu_torch.ops.hashing import hash_columns_plain

SOURCE = cuda_build.CSRC / "partition_hash.cu"
MAX_COLS = 8  # key columns a launch takes (kMaxCols); more chain launches
MAX_PARTITIONS = (1 << 31) - 1

launches = 0  # kernel launches (the plain version does not count)

# the kernel's dtype codes
_DTYPE_CODES = {
    torch.bool: 0,
    torch.int32: 1,
    torch.int64: 2,
    torch.float32: 3,
    torch.float64: 4,
}
_THREADS = 256
_MAX_BLOCKS = 132 * 16  # whole waves over the H100's 132 SMs

_dict_hash_cache: dict[tuple[str, ...], np.ndarray] = {}


def _stable_string_hashes(values: tuple[str, ...]) -> np.ndarray:
    """A deterministic (cross-process) 64-bit hash of each dictionary
    value: blake2b with an 8-byte digest, read little-endian. STRING
    columns are dictionary-coded per batch, so routing must hash the value,
    never its code; blake2b, unlike Python's salted ``hash``, is stable
    across processes. Cached by the values tuple."""
    cached = _dict_hash_cache.get(values)
    if cached is None:
        cached = np.array(
            [
                int.from_bytes(hashlib.blake2b(v.encode(), digest_size=8).digest(), "little")
                for v in values
            ],
            dtype=np.uint64,
        )
        _dict_hash_cache[values] = cached
    return cached


class _KeyCol(ctypes.Structure):
    """``KeyCol`` of the kernel source."""

    _fields_ = [
        ("data", ctypes.c_void_p),
        ("nulls", ctypes.c_void_p),
        ("table", ctypes.c_void_p),
        ("table_len", ctypes.c_longlong),
        ("dtype", ctypes.c_int),
    ]


def _configure(lib) -> None:
    f = lib.partition_hash
    f.argtypes = [
        ctypes.POINTER(_KeyCol), ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    f.restype = ctypes.c_int
    lib.partition_hash_error_string.argtypes = [ctypes.c_int]
    lib.partition_hash_error_string.restype = ctypes.c_char_p


def _umod(h: torch.Tensor, k: int) -> torch.Tensor:
    """``h % k`` of uint64 bit patterns held as int64, for 1 <= k < 2^31:
    from the 32-bit halves, ((hi % k) * (2^32 % k) + lo % k) % k, every
    term non-negative and below 2^62 (torch's ``%`` is signed)."""
    hi = (h >> 32) & 0xFFFFFFFF
    lo = h & 0xFFFFFFFF
    return ((hi % k) * ((1 << 32) % k) + lo % k) % k


def _lanes(cols, nulls, tables) -> list[torch.Tensor]:
    """Each key column through its string table, then zeroed under its
    null mask (after the table: a null string hashes 0)."""
    out = []
    for c, m, t in zip(cols, nulls, tables):
        if t is not None:
            c = t[c.clamp(0, t.shape[0] - 1).long()]
        if m is not None:
            c = torch.where(m, torch.zeros((), dtype=c.dtype, device=c.device), c)
        out.append(c)
    return out


def partition_ids_plain(
    cols: list[torch.Tensor],
    nulls: list[torch.Tensor | None],
    tables: list[torch.Tensor | None],
    valid: torch.Tensor | None,
    num_partitions: int,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the int64-emulated hash
    chain of ``ops/hashing.py`` and an unsigned modulo. ``num_partitions``
    0 returns the row hashes (int64 bits) instead of partition ids."""
    h = hash_columns_plain(_lanes(cols, nulls, tables))
    if num_partitions == 0:
        return h
    pid = _umod(h, num_partitions).to(torch.int32)
    return torch.where(valid, pid, torch.full_like(pid, num_partitions))


def _check(cols, nulls, tables, valid, num_partitions) -> None:
    if not cols:
        raise ValueError("partition_hash: no key columns")
    if not len(cols) == len(nulls) == len(tables):
        raise ValueError("partition_hash: one null mask and one table per column")
    if not 0 <= num_partitions <= MAX_PARTITIONS:
        raise ValueError(f"partition_hash: K={num_partitions} outside 0..{MAX_PARTITIONS}")
    n = cols[0].shape[0]
    masks = [m for m in nulls if m is not None] + ([valid] if num_partitions else [])
    for c in cols:
        if c.dim() != 1 or c.shape[0] != n or c.dtype not in _DTYPE_CODES:
            raise TypeError(
                f"partition_hash: key column {tuple(c.shape)} {c.dtype}; want 1-d "
                f"length {n} of {sorted(map(str, _DTYPE_CODES))}"
            )
    for m in masks:
        if m is None or m.dim() != 1 or m.shape[0] != n or m.dtype != torch.bool:
            raise TypeError("partition_hash: masks must be bool[n]")
    for t in tables:
        if t is not None and (t.dim() != 1 or t.dtype != torch.int64 or t.shape[0] == 0):
            raise TypeError("partition_hash: string tables must be non-empty int64")


def partition_hash(
    cols: list[torch.Tensor],
    nulls: list[torch.Tensor | None],
    tables: list[torch.Tensor | None],
    valid: torch.Tensor | None,
    num_partitions: int,
) -> torch.Tensor:
    """Partition ids (int32[n], ``num_partitions`` for rows not ``valid``)
    or, with ``num_partitions`` 0, the row hashes (int64[n] bits) of the key
    columns ``cols`` (bool, int32, int64, f32 or f64), each with its null
    mask (or None) and, for a STRING column's codes, its table of value
    hashes (or None). On CUDA tensors the kernel; on CPU tensors the plain
    version."""
    _check(cols, nulls, tables, valid, num_partitions)
    tensors = [*cols, *(m for m in nulls if m is not None), *(t for t in tables if t is not None)]
    if num_partitions:
        tensors.append(valid)
    if all(t.device.type == "cpu" for t in tensors):
        return partition_ids_plain(cols, nulls, tables, valid, num_partitions)
    device = cols[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            "partition_hash: every tensor must be on one CUDA device (or all on the CPU)"
        )
    h = None
    for s in range(0, len(cols), MAX_COLS):
        last = s + MAX_COLS >= len(cols)
        h = _launch(
            cols[s : s + MAX_COLS], nulls[s : s + MAX_COLS], tables[s : s + MAX_COLS],
            h, valid, num_partitions if last else 0,
        )
    return h


def _launch(cols, nulls, tables, h0, valid, num_partitions) -> torch.Tensor:
    """One launch over at most MAX_COLS key columns, from the hashes ``h0``
    of earlier columns (or None)."""
    device = cols[0].device
    n = cols[0].shape[0]
    if num_partitions:
        out = torch.empty(n, dtype=torch.int32, device=device)
    else:
        out = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out
    # contiguous copies where needed; held until the launch is queued
    cols = [c.contiguous() for c in cols]
    nulls = [None if m is None else m.contiguous() for m in nulls]
    tables = [None if t is None else t.contiguous() for t in tables]
    descs = (_KeyCol * len(cols))()
    for d, c, m, t in zip(descs, cols, nulls, tables):
        d.data = c.data_ptr()
        d.nulls = 0 if m is None else m.data_ptr()
        d.table = 0 if t is None else t.data_ptr()
        d.table_len = 0 if t is None else t.shape[0]
        d.dtype = _DTYPE_CODES[c.dtype]
    valid_c = valid.contiguous() if num_partitions else None
    blocks = min(-(-n // _THREADS), _MAX_BLOCKS)
    lib = cuda_build.load(SOURCE, _configure)
    global launches
    with torch.cuda.device(device):
        rc = lib.partition_hash(
            descs, len(cols), 0 if h0 is None else h0.data_ptr(),
            0 if valid_c is None else valid_c.data_ptr(), n, num_partitions,
            out.data_ptr() if num_partitions else 0,
            0 if num_partitions else out.data_ptr(), blocks, _THREADS,
            torch.cuda.current_stream(device).cuda_stream,
        )
        if rc != 0:
            msg = lib.partition_hash_error_string(rc).decode()
            raise RuntimeError(f"partition_hash kernel launch failed: {msg} ({rc})")
        launches += 1
    return out


def partition_ids_for(
    cols: list[torch.Tensor],
    nulls: list[torch.Tensor | None],
    valid: torch.Tensor,
    num_partitions: int,
    tables: list[torch.Tensor | None] | None = None,
) -> torch.Tensor:
    """Per-row partition id in [0, num_partitions); invalid rows get
    num_partitions (a drop bucket). Column values are zeroed under null so
    every NULL key routes to the same partition; ``tables`` translates a
    STRING column's codes to value hashes first."""
    if tables is None:
        tables = [None] * len(cols)
    return partition_hash(list(cols), list(nulls), list(tables), valid, num_partitions)


def string_key_tables(
    batch: DeviceBatch, key_idxs: list[int]
) -> tuple[torch.Tensor | None, ...]:
    """Per key column: the value-hash table of a STRING key's dictionary,
    on the batch's device (None for other keys and for empty
    dictionaries). Kept per dictionary object and device, so a warm query
    uploads none."""
    out: list[torch.Tensor | None] = []
    for i in key_idxs:
        f = batch.schema.fields[i]
        d = batch.dictionaries.get(f.name) if f.dtype == DataType.STRING else None
        if d is not None and len(d.values):
            out.append(
                memo(
                    ("stable_hash", str(batch.device)), (d,),
                    lambda d=d: torch.from_numpy(
                        _stable_string_hashes(d.values).view(np.int64)
                    ).to(batch.device),
                )
            )
        else:
            out.append(None)
    return tuple(out)


def partition_ids(
    batch: DeviceBatch,
    key_idxs: list[int],
    num_partitions: int,
    dict_tables: tuple[torch.Tensor | None, ...] | None = None,
) -> torch.Tensor:
    """``partition_ids_for`` over a batch's key columns. STRING keys route
    by value through ``dict_tables`` (``string_key_tables`` by default), so
    batches with different dictionaries route equal strings alike."""
    if dict_tables is None:
        dict_tables = string_key_tables(batch, key_idxs)
    return partition_ids_for(
        [batch.columns[i] for i in key_idxs],
        [batch.nulls[i] for i in key_idxs],
        batch.valid,
        num_partitions,
        list(dict_tables),
    )
