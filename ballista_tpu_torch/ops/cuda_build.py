"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface. It is compiled with nvcc for sm_90a into a shared library in
``build/kernels/`` (gitignored) at first use, tagged with the sha1 of its
source so that an edited source builds anew, and loaded with ``ctypes``.
Every kernel builds with the same flags. None of them relaxes IEEE
arithmetic (no ``--use_fast_math``, ``-ftz=true`` or ``-prec-div=false``):
the partition hash narrows f64 keys to f32 and hashes their bits, and a
flush-to-zero build would hash f32 subnormals as zero.

nvcc is looked for only when a kernel is built, never when a module is
imported: the CPU tests import every module on a machine without it.
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

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")

_lock = threading.Lock()
_libs: dict[pathlib.Path, ctypes.CDLL] = {}
# sources being built by one thread, which the others wait for (a build
# runs outside ``_lock``: nvcc takes seconds, and a thread that loads
# another, built kernel must not wait behind it)
_building: dict[pathlib.Path, threading.Event] = {}

# nvcc seconds this process spent building kernels (each build's wall
# time), the executor's compile seconds (obs/history.claim_compile_seconds)
_stats_lock = threading.Lock()
_build_seconds = 0.0


def build_seconds() -> float:
    with _stats_lock:
        return _build_seconds


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required")
    return path


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the library of ``source`` goes: its stem and source hash."""
    tag = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{source.stem}-{tag}.so"


def build_many(
    sources: list[pathlib.Path], verbose: bool = False
) -> list[tuple[pathlib.Path, float, str]]:
    """Compile each source whose library is not built yet, one nvcc each,
    all started together. Returns (library path, build seconds, compiler
    output) per source. ``verbose`` rebuilds with ``-Xptxas -v`` (the
    registers and shared memory of each kernel)."""
    started = []
    for src in sources:
        out = library_path(src)
        if out.exists() and not verbose:
            started.append((src, out, None, None, 0.0))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # one temporary per process and thread: two threads that build the
        # same source both write whole files, and the last rename wins
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *FLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        started.append((src, out, tmp, proc, time.perf_counter()))
    global _build_seconds
    results = []
    for src, out, tmp, proc, t0 in started:
        if proc is None:
            results.append((out, 0.0, ""))
            continue
        stdout, stderr = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} ({proc.returncode}):\n{stdout}\n{stderr}"
            )
        os.replace(tmp, out)
        with _stats_lock:
            _build_seconds += secs
        results.append((out, secs, stdout + stderr))
    return results


def build(source: pathlib.Path, verbose: bool = False) -> tuple[pathlib.Path, float, str]:
    """``build_many`` of one source."""
    return build_many([source], verbose)[0]


def load(source: pathlib.Path, configure) -> ctypes.CDLL:
    """The loaded library of ``source``, built if need be, with
    ``configure(lib)`` run once to declare its functions' argument types.
    One thread builds and configures it; the others that ask meanwhile
    wait for that thread, holding no lock."""
    with _lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        done = _building.get(source)
        owner = done is None
        if owner:
            done = _building[source] = threading.Event()
    if not owner:
        done.wait()
        with _lock:
            lib = _libs.get(source)
        if lib is None:
            raise RuntimeError(f"building {source.name} failed in another thread")
        return lib
    try:
        path, _, _ = build(source)
        lib = ctypes.CDLL(str(path))
        configure(lib)
        with _lock:
            _libs[source] = lib
        return lib
    finally:
        with _lock:
            del _building[source]
        done.set()
