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

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/prefix_sum.cu`` (built with nvcc at first use, loaded with ctypes)
or raises; on a CPU tensor it runs the plain version, which associates
the adds exactly as the kernel does, so the two agree bit for bit. See
the kernel source for its bound on the card and its design.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from ballista_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "prefix_sum.cu"

CHUNK = 16  # rows a chunk: the kernel's kChunk

# kernel launch sequences (the plain version does not count), counted
# under the lock: task threads launch concurrently
launches = 0
_count_lock = threading.Lock()


def levels(n: int) -> list[int]:
    """The row counts of the levels that have more than one chunk: n, then
    each level's chunk count, while it exceeds one chunk."""
    out = []
    while n > CHUNK:
        out.append(n)
        n = -(-n // CHUNK)
    return out


def scratch_rows(n: int) -> int:
    """Scratch doubles a column needs: each level's totals and their
    prefix."""
    return sum(2 * -(-r // CHUNK) for r in levels(n))


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
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    f.restype = ctypes.c_int
    lib.prefix_sum_chunk.argtypes = []
    lib.prefix_sum_chunk.restype = ctypes.c_int
    lib.prefix_sum_error_string.argtypes = [ctypes.c_int]
    lib.prefix_sum_error_string.restype = ctypes.c_char_p
    if lib.prefix_sum_chunk() != CHUNK:
        raise RuntimeError(
            f"prefix_sum.cu chunks {lib.prefix_sum_chunk()} rows, "
            f"ops/prefix_sum.py {CHUNK}"
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
    if k > 65535:
        raise ValueError(f"prefix_sums: {k} columns (the grid takes 65,535)")
    lib = _library()
    global launches
    with torch.cuda.device(x.device):
        # the scratch is freed when this returns, before the kernels run:
        # safe, because the caching allocator only hands the block out
        # again to work queued after them on the same stream
        scratch = torch.empty(max(1, k * scratch_rows(n)), dtype=torch.float64, device=x.device)
        out = torch.empty_like(x)
        rc = lib.prefix_sum_f64(
            x.data_ptr(), n, k, scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        if rc != 0:
            msg = lib.prefix_sum_error_string(rc).decode()
            raise RuntimeError(f"prefix_sums kernel launch failed: {msg} ({rc})")
        with _count_lock:
            launches += 1
    return out
