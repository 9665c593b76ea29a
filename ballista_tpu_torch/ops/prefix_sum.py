"""Fixed-order f64 prefix sums: the CUDA kernel and its plain version.

``prefix_sums(x)`` takes k columns of n rows as one contiguous (k, n) f64
tensor and returns their inclusive prefixes, (k, n), in an order of adds
fixed by n alone: chunks of ``CHUNK`` rows, a running sum from +0.0 within
each chunk, the chunk totals' own prefix (by the same rule, recursively)
as each chunk's offset, and ``out = offset + local``. It is the
counterpart of the reference's ``_prefix_sum_2d``/``_mm_prefix``
(``ballista_tpu/ops/aggregate.py``), and the sort aggregate's f64 SUMs
take their prefixes from it (``ops/aggregate._column_cumsums``), so an f64
SUM is bit-reproducible from run to run: ``torch.cumsum`` on a CUDA
tensor is one device-wide scan whose order of adds can depend on timing.
The kernel computes the same association in one pass: one launch a call
(after one memset of its scratch), each input row read once and each output
row written once.

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/prefix_sum.cu`` (built with nvcc at first use, loaded with ctypes)
or raises; on a CPU tensor it runs the plain version, which associates
the adds exactly as the kernel does, so the two agree bit for bit. See
the kernel source for its bound on the card and its design.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import threading

import torch

from ballista_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "prefix_sum.cu"

CHUNK = 16  # rows a chunk: the kernel's kChunk
TILE = CHUNK ** 3  # rows a block scans (levels 0-2 of the rule): kTile

# kernel launches (the plain version does not count), counted under the
# lock: task threads launch concurrently
launches = 0
_count_lock = threading.Lock()


def levels(n: int) -> list[int]:
    """The look-back entries a column of n rows has at each level above
    the tile: its tiles of ``TILE`` rows, then the full groups of ``CHUNK``
    entries of the level below, while there is one."""
    out, t = [], -(-n // TILE)
    while t:
        out.append(t)
        t //= CHUNK
    return out


@functools.lru_cache(maxsize=1024)
def scratch_words(n: int, k: int) -> int:
    """64-bit words of one call's scratch, all cleared by the call: the
    tile counter (two words), then a (value, ~value) pair for each tile's
    total and two tail values, and for each group total above the tiles."""
    lv = levels(n)
    return 2 + 2 * k * (3 * lv[0] + sum(lv[1:]))


def prefix_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on the CPU: the same association as the
    kernel, from ``torch.cumsum`` along the chunks of a (k, m, CHUNK) view
    (torch's CPU cumsum adds left to right from +0.0)."""
    k, n = x.shape
    if n == 0:
        return x.clone()
    m = -(-n // CHUNK)
    padded = torch.zeros(k, m * CHUNK, dtype=torch.float64, device=x.device)
    padded[:, :n] = x
    local = torch.cumsum(padded.view(k, m, CHUNK), dim=2)
    offset = torch.zeros(k, m, dtype=torch.float64, device=x.device)
    if m > 1:
        offset[:, 1:] = prefix_sums_plain(local[:, :, -1].contiguous())[:, :-1]
    return (offset.unsqueeze(2) + local).reshape(k, m * CHUNK)[:, :n]


def build(verbose: bool = False) -> tuple[pathlib.Path, float, str]:
    """Compile the kernel for sm_90a into ``build/kernels`` (skipped when a
    library of the same source is already there). Returns (library path,
    build seconds, compiler output)."""
    return cuda_build.build(SOURCE, verbose)


def _configure(lib) -> None:
    f = lib.prefix_sum_f64
    f.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ]
    f.restype = ctypes.c_int
    for name in ("prefix_sum_chunk", "prefix_sum_tile"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.prefix_sum_error_string.argtypes = [ctypes.c_int]
    lib.prefix_sum_error_string.restype = ctypes.c_char_p
    if (lib.prefix_sum_chunk(), lib.prefix_sum_tile()) != (CHUNK, TILE):
        raise RuntimeError(
            f"prefix_sum.cu chunks {lib.prefix_sum_chunk()} rows in tiles of "
            f"{lib.prefix_sum_tile()}, ops/prefix_sum.py {CHUNK} in {TILE}"
        )


def _library():
    return cuda_build.load(SOURCE, _configure)


def prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """(k, n) f64 columns -> (k, n) inclusive prefixes, in the fixed
    order."""
    if x.dim() != 2:
        raise ValueError(f"prefix_sums: shape {tuple(x.shape)} (want (k, n))")
    if x.dtype != torch.float64:
        raise TypeError(f"prefix_sums: want float64, got {x.dtype}")
    if x.device.type == "cpu":
        return prefix_sums_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"prefix_sums: x on {x.device} (want CUDA or the CPU)")
    if not x.is_contiguous():
        raise ValueError("prefix_sums: x must be contiguous")
    k, n = x.shape
    if n == 0 or k == 0:
        return torch.empty_like(x)
    if k * -(-n // TILE) > 2**31 - 1:
        raise ValueError(f"prefix_sums: {k} columns of {n} rows (the grid takes 2^31 - 1 tiles)")
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch(x, k, n)
    return _launch(x, k, n)


def _launch(x: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """One memset and one launch on the current stream, with the output
    and the scratch in one allocation."""
    lib = _library()
    global launches
    words = scratch_words(n, k)
    # the scratch (the tile counter and the published pairs, which the call
    # clears; 16-byte aligned) follows the output in one block and lives as
    # long as it: the caching allocator hands the block out again only to
    # work queued after the kernel on the same stream, and a call on
    # another stream gets a block of its own
    at = (k * n + 1) & ~1
    buf = torch.empty(at + words, dtype=torch.float64, device=x.device)
    ptr = buf.data_ptr()
    rc = lib.prefix_sum_f64(
        x.data_ptr(), n, k, ptr + 8 * at, words, ptr,
        # the current stream's handle, without building the Stream object
        # that torch.cuda.current_stream returns
        torch._C._cuda_getCurrentRawStream(x.device.index),
    )
    if rc != 0:
        msg = lib.prefix_sum_error_string(rc).decode()
        raise RuntimeError(f"prefix_sums kernel launch failed: {msg} ({rc})")
    with _count_lock:
        launches += 1
    return buf.as_strided((k, n), (n, 1))
