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
the same kernel in its hash-only mode. ``partition_groups`` adds the rows
grouped by partition (a stable order and each bucket's start), which the
grace-hash spill writes from; its plain version is
``partition_groups_plain``.

The wrappers check what the kernel's C entry cannot: dtypes, lengths and
the device. The C entry checks the ranges (the column count, K, the string
tables' lengths) and returns ``cudaErrorInvalidValue``, which the wrappers
raise as ``ValueError``; on CPU tensors the wrappers check the same ranges
themselves.

Floats route as the port hashes them: -0.0 with +0.0, and every NaN alike.
The reference's jitted routing folds its ``+ 0.0`` away and routes -0.0
apart from +0.0 (ROADMAP queue 3).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import struct
import threading

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
MAX_GROUPS = 1024  # K of the grouped mode (kMaxGroups)

# Kernel launches of every mode, and of the grouped mode alone (calls;
# the plain versions do not count)
launches = 0
group_launches = 0

# the kernel's dtype codes
_DTYPE_CODES = {
    torch.bool: 0,
    torch.int32: 1,
    torch.int64: 2,
    torch.float32: 3,
    torch.float64: 4,
}
_CUDA_INVALID_VALUE = 1  # cudaErrorInvalidValue: an argument out of range

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


# ``KeyCol`` of the kernel source: data, nulls and table pointers, the
# table's length, the dtype code (and 4 bytes of padding)
_KEYCOL = struct.Struct("=QQQqi4x")


class _Launcher:
    """The loaded library and what every launch reuses: the key-column
    descriptors (one buffer a thread, refilled: the foreign call releases
    the GIL), the tile size of the grouped mode and the current-stream
    lookup. Made at the first launch."""

    def __init__(self) -> None:
        lib = cuda_build.load(SOURCE, lambda lib: None)
        keys = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong]
        lib.partition_hash.argtypes = keys + [ctypes.c_void_p] * 3
        lib.partition_groups.argtypes = keys + [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_void_p,
        ]
        lib.partition_hash.restype = lib.partition_groups.restype = ctypes.c_int
        lib.partition_groups_tile_rows.restype = ctypes.c_int
        lib.partition_hash_error_string.argtypes = [ctypes.c_int]
        lib.partition_hash_error_string.restype = ctypes.c_char_p
        self.lib = lib
        self.tile_rows = lib.partition_groups_tile_rows()
        self._local = threading.local()
        # torch's raw stream lookup (no Stream object) where it has one
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        self.stream = raw if raw is not None else (
            lambda index: torch.cuda.current_stream(index).cuda_stream
        )

    def descs(self, cols, nulls, tables):
        """This thread's descriptor buffer, filled for the key columns."""
        buf = getattr(self._local, "descs", None)
        if buf is None:
            buf = self._local.descs = ctypes.create_string_buffer(_KEYCOL.size * MAX_COLS)
        for j, (c, m, t) in enumerate(zip(cols, nulls, tables)):
            _KEYCOL.pack_into(
                buf, j * _KEYCOL.size, c.data_ptr(),
                0 if m is None else m.data_ptr(), 0 if t is None else t.data_ptr(),
                0 if t is None else t.shape[0], _DTYPE_CODES[c.dtype],
            )
        return buf

    def raise_for(self, rc: int, what: str) -> None:
        msg = self.lib.partition_hash_error_string(rc).decode()
        if rc == _CUDA_INVALID_VALUE:
            raise ValueError(
                f"{what}: an argument out of range ({msg}): 1..{MAX_COLS} key columns a "
                f"launch, K in 1..2^31-1 (grouped: 1..{MAX_GROUPS}), non-empty string tables"
            )
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


_launcher: _Launcher | None = None


def _lib() -> _Launcher:
    global _launcher
    if _launcher is None:
        _launcher = _Launcher()
    return _launcher


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


def group_by_id(pid: torch.Tensor, num_partitions: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, offsets) of partition ids ``pid`` in [0, K]: the row indices
    sorted stably by id (int32[n]) and where each id's rows start
    (int64[K + 2]; ``offsets[K]`` the rows below K, ``offsets[K + 1]`` n):
    a stable argsort and a cumulative bincount."""
    order = torch.argsort(pid, stable=True).to(torch.int32)
    offsets = torch.zeros(num_partitions + 2, dtype=torch.int64, device=pid.device)
    torch.cumsum(torch.bincount(pid, minlength=num_partitions + 1), 0, out=offsets[1:])
    return order, offsets


def partition_groups_plain(
    cols: list[torch.Tensor],
    nulls: list[torch.Tensor | None],
    tables: list[torch.Tensor | None],
    valid: torch.Tensor,
    num_partitions: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the grouped mode: ``partition_ids_plain``, then
    ``group_by_id``."""
    pid = partition_ids_plain(cols, nulls, tables, valid, num_partitions)
    return (pid, *group_by_id(pid, num_partitions))


def _check(cols, nulls, tables, valid) -> torch.device | None:
    """What the C entry cannot check: the tensors' dtypes, lengths and
    device. Returns their CUDA device, or None when all lie on the CPU."""
    if not cols:
        raise ValueError("partition_hash: no key columns")
    if not len(cols) == len(nulls) == len(tables):
        raise ValueError("partition_hash: one null mask and one table per column")
    n = cols[0].shape[0]
    device = cols[0].device
    same = True
    for c in cols:
        if c.dtype not in _DTYPE_CODES or c.dim() != 1 or c.shape[0] != n:
            raise TypeError(
                f"partition_hash: key column {tuple(c.shape)} {c.dtype}; want 1-d "
                f"length {n} of {sorted(map(str, _DTYPE_CODES))}"
            )
        same = same and c.device == device
    for m in (*nulls, valid):
        if m is not None:
            if m.dtype != torch.bool or m.dim() != 1 or m.shape[0] != n:
                raise TypeError("partition_hash: masks must be bool[n]")
            same = same and m.device == device
    for t in tables:
        if t is not None:
            if t.dtype != torch.int64 or t.dim() != 1:
                raise TypeError("partition_hash: string tables must be int64")
            same = same and t.device == device
    if same and device.type == "cpu":
        return None
    if not same or device.type != "cuda":
        raise ValueError(
            "partition_hash: every tensor must be on one CUDA device (or all on the CPU)"
        )
    return device


def _check_ranges(tables, num_partitions: int, low: int, high: int) -> None:
    """The C entry's range checks, for the CPU route (and empty inputs)."""
    if not low <= num_partitions <= high:
        raise ValueError(f"partition_hash: K={num_partitions} outside {low}..{high}")
    if any(t is not None and t.shape[0] == 0 for t in tables):
        raise ValueError("partition_hash: string tables must be non-empty")


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
    if num_partitions and valid is None:
        raise TypeError("partition_hash: partition ids need the valid mask")
    device = _check(cols, nulls, tables, valid if num_partitions else None)
    n = cols[0].shape[0]
    if device is None or n == 0:
        _check_ranges(tables, num_partitions, 0, MAX_PARTITIONS)
        if device is None:
            return partition_ids_plain(cols, nulls, tables, valid, num_partitions)
    out_dtype = torch.int32 if num_partitions else torch.int64
    out = torch.empty(n, dtype=out_dtype, device=device)
    if n:
        h = _hash_prefix(cols, nulls, tables, device)
        last = len(cols) - (len(cols) - 1) % MAX_COLS - 1
        _launch_hash(cols[last:], nulls[last:], tables[last:], h, valid, num_partitions, out)
    return out


def partition_groups(
    cols: list[torch.Tensor],
    nulls: list[torch.Tensor | None],
    tables: list[torch.Tensor | None],
    valid: torch.Tensor,
    num_partitions: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rows grouped by partition: ``(pid, order, offsets)``, with
    ``pid`` as ``partition_hash`` gives it (int32[n]), ``order`` the row
    indices sorted stably by ``pid`` (int32[n]: each bucket's rows in row
    order, the invalid rows last) and ``offsets`` where each bucket starts
    (int64[K + 2]: ``offsets[K]`` the valid rows, ``offsets[K + 1]`` n).
    1 <= K <= ``MAX_GROUPS``. On CUDA tensors the kernel's grouped mode;
    on CPU tensors ``partition_groups_plain``."""
    if valid is None:
        raise TypeError("partition_groups: the valid mask is required")
    device = _check(cols, nulls, tables, valid)
    n = cols[0].shape[0]
    if device is None or n == 0:
        _check_ranges(tables, num_partitions, 1, MAX_GROUPS)
        if device is None:
            return partition_groups_plain(cols, nulls, tables, valid, num_partitions)
        empty = torch.empty(0, dtype=torch.int32, device=device)
        return empty, empty, torch.zeros(num_partitions + 2, dtype=torch.int64, device=device)
    lib = _lib()
    ntiles = -(-n // lib.tile_rows)
    scratch_len = (num_partitions + 1) * (ntiles + 1)
    ints = torch.empty(2 * n + scratch_len, dtype=torch.int32, device=device)
    pid, order, scratch = ints[:n], ints[n : 2 * n], ints[2 * n :]
    offsets = torch.empty(num_partitions + 2, dtype=torch.int64, device=device)
    h = _hash_prefix(cols, nulls, tables, device)
    last = len(cols) - (len(cols) - 1) % MAX_COLS - 1
    cols, nulls, tables = _contiguous(cols[last:], nulls[last:], tables[last:])
    valid = valid.contiguous()
    with _on(device):
        rc = lib.lib.partition_groups(
            lib.descs(cols, nulls, tables), len(cols), 0 if h is None else h.data_ptr(),
            valid.data_ptr(), n, num_partitions, pid.data_ptr(), order.data_ptr(),
            offsets.data_ptr(), scratch.data_ptr(), scratch_len, lib.stream(device.index),
        )
    if rc:
        lib.raise_for(rc, "partition_groups")
    global launches, group_launches
    launches += 1
    group_launches += 1
    return pid, order, offsets


def _on(device: torch.device):
    """``torch.cuda.device(device)`` only when it is not the current device
    (entering it costs more host time than the launch)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _hash_prefix(cols, nulls, tables, device) -> torch.Tensor | None:
    """The hashes of all but the last launch's key columns (hash-only
    launches of MAX_COLS columns each, chained), or None for at most
    MAX_COLS key columns."""
    h = None
    for s in range(0, (len(cols) - 1) // MAX_COLS * MAX_COLS, MAX_COLS):
        out = torch.empty(cols[0].shape[0], dtype=torch.int64, device=device)
        _launch_hash(
            cols[s : s + MAX_COLS], nulls[s : s + MAX_COLS], tables[s : s + MAX_COLS], h, None,
            0, out,
        )
        h = out
    return h


def _contiguous(cols, nulls, tables):
    """Contiguous copies where needed, held by the caller until the launch
    is queued."""
    return (
        [c.contiguous() for c in cols],
        [None if m is None else m.contiguous() for m in nulls],
        [None if t is None else t.contiguous() for t in tables],
    )


def _launch_hash(cols, nulls, tables, h0, valid, num_partitions, out) -> None:
    """One launch of the ids (``num_partitions`` > 0, into int32 ``out``)
    or hash-only mode (into int64 ``out``) over at most MAX_COLS key
    columns, from the hashes ``h0`` of earlier columns (or None)."""
    cols, nulls, tables = _contiguous(cols, nulls, tables)
    valid = valid.contiguous() if num_partitions else None
    lib = _lib()
    with _on(out.device):
        rc = lib.lib.partition_hash(
            lib.descs(cols, nulls, tables), len(cols), 0 if h0 is None else h0.data_ptr(),
            0 if valid is None else valid.data_ptr(), out.shape[0],
            num_partitions, out.data_ptr() if num_partitions else 0,
            0 if num_partitions else out.data_ptr(), lib.stream(out.device.index),
        )
    if rc:
        lib.raise_for(rc, "partition_hash")
    global launches
    launches += 1


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


def batch_partition_groups(
    batch: DeviceBatch,
    key_idxs: list[int],
    num_partitions: int,
    dict_tables: tuple[torch.Tensor | None, ...] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``partition_groups`` over a batch's key columns (the routing of
    ``partition_ids``): the batch's rows grouped by partition."""
    if dict_tables is None:
        dict_tables = string_key_tables(batch, key_idxs)
    return partition_groups(
        [batch.columns[i] for i in key_idxs],
        [batch.nulls[i] for i in key_idxs],
        list(dict_tables),
        batch.valid,
        num_partitions,
    )
