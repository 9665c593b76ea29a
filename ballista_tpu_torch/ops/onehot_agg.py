"""One-hot group sums: the CUDA kernel, its launch plan and its plain version.

``onehot_sums(rid, vals, P)`` returns ``out`` of shape (P, R) in f64 with
``out[p, r] = sum(vals[r, i] for i with rid[i] == p)``; rows whose ``rid`` is
outside [0, P) are dropped. It replaces the TPU kernel
``ballista_tpu/ops/pallas_agg.py`` (``_program``/``kernel``, reached through
``onehot_sums``), which the dense grouped aggregate (TPC-H q1) runs.

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/onehot_agg.cu`` (built with nvcc at first use, loaded with ctypes)
or raises; on a CPU tensor it runs the plain version. See the kernel source
for its bound on the card and the reasons for its design (f64 throughout,
select instead of multiply, deterministic two-pass reduction).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "onehot_agg.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"

# The slot gate of the one-hot route (the reference's _MATMUL_MAX_SLOTS);
# ops/aggregate.py routes on it, so the two cannot disagree.
MAX_SLOTS = 2048
MAX_ROWS = 64  # value rows R per call

# Launch-plan constants: 4 blocks on each of the H100's 132 SMs; partials
# capped at 64 MiB; the shared-memory tile kept under the 48 KB a block gets
# without opting in.
_MAX_BLOCKS = 4 * 132
_PARTIAL_BYTES = 64 << 20
_SMEM_BYTES = 45 << 10

launches = 0  # kernel launches (the plain version does not count)

_lock = threading.Lock()
_lib = None


def launch_plan(n: int, R: int, P: int) -> dict:
    """The kernel's launch shape for ``n`` rows, ``R`` value rows and ``P``
    slots. Depends on the shapes only, never on the card, so the blocks'
    row ranges (and with them the summation order) are fixed."""
    tile = 256
    while tile > 32 and R * (tile + 1) * 8 + 4 * tile > _SMEM_BYTES:
        tile //= 2
    pairs = P * R
    threads = min(256, -(-pairs // 32) * 32)
    k = 1 if pairs <= threads else 4
    tiles = -(-n // tile)
    nb = max(1, min(tiles, _MAX_BLOCKS, _PARTIAL_BYTES // (pairs * 8)))
    rows_per_block = -(-tiles // nb) * tile
    nb = max(1, -(-n // rows_per_block))
    smem = R * (tile + 1) * 8 + 4 * tile
    return dict(
        tile=tile, threads=threads, k=k, nb=nb,
        rows_per_block=rows_per_block, smem=smem,
    )


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required")
    return nvcc


def build(verbose: bool = False) -> tuple[pathlib.Path, float, str]:
    """Compile the kernel for sm_90a into ``build/kernels`` (skipped when a
    library of the same source is already there). Returns (library path,
    build seconds, compiler output). ``verbose`` adds ``-Xptxas -v`` (the
    registers and shared memory of each kernel)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src).hexdigest()[:12]
    out = BUILD_DIR / f"onehot_agg-{tag}.so"
    if out.exists() and not verbose:
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(SOURCE),
    ]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, secs, proc.stdout + proc.stderr


def _library():
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            f = lib.onehot_sums_f64
            f.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            f.restype = ctypes.c_int
            lib.onehot_error_string.argtypes = [ctypes.c_int]
            lib.onehot_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def onehot_sums_plain(rid: torch.Tensor, vals: torch.Tensor, P: int) -> torch.Tensor:
    """The plain PyTorch version: one f64 ``index_add_`` of the rows in
    [0, P) (rows outside go to a spare slot that is cut off)."""
    R = vals.shape[0]
    idx = torch.where((rid >= 0) & (rid < P), rid, P).long()
    out = torch.zeros(P + 1, R, dtype=torch.float64, device=vals.device)
    out.index_add_(0, idx, vals.to(torch.float64).T)
    return out[:P]


def onehot_sums(rid: torch.Tensor, vals: torch.Tensor, P: int) -> torch.Tensor:
    """(rid int32[n], vals f64[R, n], P) -> f64[P, R] group sums."""
    if rid.device.type == "cpu" and vals.device.type == "cpu":
        return onehot_sums_plain(rid, vals, P)
    if rid.device.type != "cuda" or vals.device != rid.device:
        raise ValueError(
            f"onehot_sums: rid on {rid.device}, vals on {vals.device}; "
            "both must be on one CUDA device (or both on the CPU)"
        )
    if rid.dtype != torch.int32 or vals.dtype != torch.float64:
        raise TypeError(
            f"onehot_sums: want rid int32 and vals float64, got "
            f"{rid.dtype} and {vals.dtype}"
        )
    if rid.dim() != 1 or vals.dim() != 2 or vals.shape[1] != rid.shape[0]:
        raise ValueError(
            f"onehot_sums: shapes rid {tuple(rid.shape)}, vals "
            f"{tuple(vals.shape)} (want (n,) and (R, n))"
        )
    if not (rid.is_contiguous() and vals.is_contiguous()):
        raise ValueError("onehot_sums: rid and vals must be contiguous")
    R, n = vals.shape
    if not (1 <= P <= MAX_SLOTS) or not (1 <= R <= MAX_ROWS):
        raise ValueError(
            f"onehot_sums: P={P}, R={R} outside the kernel's range "
            f"(1..{MAX_SLOTS} slots, 1..{MAX_ROWS} value rows)"
        )
    if n == 0:
        return torch.zeros(P, R, dtype=torch.float64, device=vals.device)
    plan = launch_plan(n, R, P)
    lib = _library()
    global launches
    with torch.cuda.device(rid.device):
        # ``partials`` is freed when this returns, before the kernel runs:
        # safe, because the caching allocator only hands the block out again
        # to work queued after it on the same stream
        partials = torch.empty(
            plan["nb"], P, R, dtype=torch.float64, device=vals.device
        )
        out = torch.empty(P, R, dtype=torch.float64, device=vals.device)
        rc = lib.onehot_sums_f64(
            rid.data_ptr(), vals.data_ptr(), n, R, P, plan["tile"],
            plan["threads"], plan["k"], plan["nb"], plan["rows_per_block"],
            partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(rid.device).cuda_stream,
        )
        if rc != 0:
            msg = lib.onehot_error_string(rc).decode()
            raise RuntimeError(f"onehot_sums kernel launch failed: {msg} ({rc})")
        launches += 1
    return out
