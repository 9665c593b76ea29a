"""One-hot group sums: the CUDA kernel, its launch plan and its plain version.

``onehot_sums(rid, vals, P)`` returns ``out`` of shape (P, R) in f64 with
``out[p, r] = sum(vals[r, i] for i with rid[i] == p)``; rows whose ``rid`` is
outside [0, P) are dropped. It replaces the TPU kernel
``ballista_tpu/ops/pallas_agg.py`` (``_program``/``kernel``, reached through
``onehot_sums``), which the dense grouped aggregate (TPC-H q1) runs.

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/onehot_agg.cu`` (built with nvcc at first use, loaded with ctypes)
or raises; on a CPU tensor it runs the plain version. The kernel does n*R
work at any P up to ``MAX_SLOTS`` (65,536) and sums in an order fixed by the
shapes, the row indices and the slot ids, so two launches on the same input
are bit-identical. See the kernel source for its bound on the card and the
reasons for its design (f64 throughout, select instead of multiply,
accumulators in shared memory, deterministic two-pass reduction).
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import threading

import torch

from ballista_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "onehot_agg.cu"

# The largest dense slot space (the reference's DENSE_AGG_MAX_SLOTS):
# ops/aggregate.py routes every dense aggregate here and takes its own
# limit from this constant, so the two cannot disagree.
MAX_SLOTS = 1 << 16
MAX_ROWS = 64  # value rows R per call

# Launch-plan constants: 8 warps a block; 4 blocks for each of the H100's
# 132 SMs (in whole waves); partials capped at 64 MiB; accumulator copies
# kept within 48 KB (so small slot spaces leave room for several blocks on
# an SM); a block's shared memory at most the 227 KB it can opt into.
_WARPS = 8
_SMS = 132
_SM_SMEM = 233_472  # shared memory of an SM, for all its blocks
_BLOCKS_PER_SM = 4  # 256 threads of at most 64 registers each
_TARGET_BLOCKS = 4 * _SMS
_PARTIAL_BYTES = 64 << 20
_COPIES_BYTES = 48 << 10
_SMEM_MAX = 232_448
_RING_BYTES = 112 << 10  # the warps' rings, at most: two blocks fit an SM
# Up to 2^_TREE_BITS slots a chunk, the lanes mode finds the lanes of one
# slot by one ballot per bit of the slot id; above, by __match_any_sync.
_TREE_BITS = 6
# From this many slots on (and up to _OWNER_MAX_ROWS value rows), the warps
# of a block own disjoint slots ("owners" mode), with the staged tiles
# within _TILE_BYTES. chip_smoke.py times both modes against each other
# (uniform, Zipf and one-hot-slot ids) at 256 to 65,536 slots.
_OWNER_MIN_SLOTS = 256
_OWNER_MAX_ROWS = 32  # a lane stages all R values of its row
_TILE_BYTES = 96 << 10
_TILE_BYTES_TWO = 48 << 10  # the same, where two blocks share an SM


def _staged(R: int, tile: int) -> int:
    """Shared memory an owners block stages: three tiles of R value rows
    (rows padded to odd), a list of rows for each warp, five tiles of slot
    ids (the kernel's kTiles and kIdTiles)."""
    return 3 * R * (tile + 1) * 8 + _WARPS * tile * 2 + 5 * tile * 4


def _stages(rw: int) -> int:
    """Ring depth for ``rw`` value rows a warp: at least 16 rows' values
    (4 KB) of each warp in flight, and 30 for a warp of one or two rows (the
    kernel's instantiations are 4, 8 and 16 stages)."""
    return 16 if rw <= 2 else 8 if rw <= 5 else 4


def _ring_bytes(rw: int) -> int:
    """Shared memory of the 8 warps' rings: per stage, 32 values of each
    of ``rw`` rows and 64 slot ids."""
    return _WARPS * _stages(rw) * (rw + 1) * 32 * 8

# kernel launches (the plain version does not count), counted under the
# lock: task threads launch concurrently
launches = 0
_count_lock = threading.Lock()


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _row_blocks(n: int, R: int, P: int, chunks: int, unit: int, most: int,
                smem: int) -> tuple:
    """Row blocks: about _TARGET_BLOCKS blocks in all, at most ``most`` for
    each chunk, each a multiple of ``unit`` rows, and partials within
    64 MiB and within a quarter of the bytes read (each is written once and
    read once more). Beyond one wave, the blocks of all chunks fill whole
    waves of the card (blocks of ``smem`` bytes resident on each of its
    SMs at once), so that no last wave runs nearly empty. Returns (blocks,
    rows per block)."""
    part = P * R * 8
    nb = max(1, min(
        most, -(-_TARGET_BLOCKS // chunks),
        _PARTIAL_BYTES // part, (4 + 8 * R) * n // 4 // part,
    ))
    wave = _SMS * min(_BLOCKS_PER_SM, _SM_SMEM // (smem + 1024))
    if nb * chunks > wave:
        nb = max(1, nb * chunks // wave * wave // chunks)
    rows_per_block = -(-(-(-n // unit)) // nb) * unit
    return max(1, -(-n // rows_per_block)), rows_per_block


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, R: int, P: int, mode: str | None = None) -> dict:
    """The kernel's launch shape for ``n`` rows, ``R`` value rows and ``P``
    slots. Depends on the shapes only, never on the card, so the blocks'
    row ranges, the accumulators and the slot chunks (and with them the
    summation order) are fixed (and cached: the caller must not change the
    dict). ``mode`` is "owners" from ``_OWNER_MIN_SLOTS`` slots on and up
    to ``_OWNER_MAX_ROWS`` value rows, else "lanes" (or as given).

    "lanes": a block's 8 warps form ``copies`` groups of ``k`` warps; each
    group has its own (pc, R) accumulator and takes every copies-th 32-row
    step, and warp j of a group owns the value rows j, j + k, ... (``rw``
    of them at most; a warp with j >= R has none). ``k`` is the least power
    of two at which the warps' rings fit in 112 KB and the copies'
    accumulators in 48 KB (or 8). Each warp's ring holds ``stages`` steps
    of its values and twice as many of slot ids. The lanes of one slot in a
    warp are found by one ballot per bit of the slot id in a chunk of up to
    2^``tree_bits`` slots, by ``__match_any_sync`` above. The
    accumulator's row stride is R rounded up to odd, but for R = 2 mod 4
    only where that costs no chunk.

    "owners": one (pc, R) accumulator and a lane word for each slot (pc a
    multiple of 8); warp w owns the chunk's slots equal to w modulo 8 and
    adds the rows of its slots, 32 at a time, a lane a row. The block stages ``tile`` rows at a
    time, three tiles of values and five of slot ids, and each warp lists
    its rows of a tile. Two blocks share an SM where that costs no chunk;
    with one chunk, the blocks are one wave.

    In both, where the accumulators do not fit beside the staging buffers
    in the 227 KB of a block, the slots are cut into ``chunks`` of ``pc``
    slots, and every chunk re-reads rid."""
    if mode is None:
        mode = "owners" if P >= _OWNER_MIN_SLOTS and R <= _OWNER_MAX_ROWS else "lanes"
    if mode == "owners":
        stride = R | 1  # odd: a batch's winners hit distinct banks

        def fit(budget, tile_bytes):  # (tile, staged bytes, pc, chunks)
            tile = 512
            while tile > 32 and _staged(R, tile) > tile_bytes:
                tile //= 2
            pc = min(P, (budget - _staged(R, tile)) // ((stride * 8 + 4) * _WARPS) * _WARPS)
            return tile, _staged(R, tile), pc, -(-P // pc)

        # two blocks on an SM where that costs no chunk, else one
        tile, staged, pc, chunks = fit(_SMEM_MAX, _TILE_BYTES)
        two = fit(_SM_SMEM // 2 - 1024, _TILE_BYTES_TWO)
        if two[3] == chunks:
            tile, staged, pc, chunks = two
        pc = -(-(-(-P // chunks)) // _WARPS) * _WARPS  # even, whole rows of 8
        chunks = -(-P // pc)
        smem = pc * (stride * 8 + 4) + staged
        # with one chunk, one wave of blocks: fewer partials to write and
        # sum, and no chunk to hold the rows of a hot slot
        wave = _SMS * min(_BLOCKS_PER_SM, _SM_SMEM // (smem + 1024))
        most = wave if chunks == 1 else -(-n // tile)
        nb, rows_per_block = _row_blocks(n, R, P, chunks, tile, most, smem)
        return dict(
            mode=mode, step=32, threads=32 * _WARPS, warps=_WARPS,
            copies=1, warps_per_value_row=1, k=1, rw=R, stages=0,
            stride=stride, tile=tile, tile_shift=tile.bit_length() - 1, pc=pc,
            chunks=chunks, nb=nb, rows_per_block=rows_per_block, tree_bits=0,
            smem=smem,
        )
    k = 1
    while k < _WARPS and (
        _ring_bytes(-(-R // k)) > _RING_BYTES
        or (_WARPS // k) * P * (R | 1) * 8 > _COPIES_BYTES
    ):
        k *= 2
    copies = _WARPS // k
    rw = -(-R // k)
    ring = _ring_bytes(rw)
    room = _SMEM_MAX - ring

    def chunks_at(stride):
        return -(-P // min(P, room // (copies * stride * 8)))

    # an odd stride puts a warp's leaders on distinct banks; R = 2 mod 4
    # puts at most two on one, and is kept where R | 1 would cost a chunk
    stride = R if R % 4 == 2 and chunks_at(R) < chunks_at(R | 1) else R | 1
    chunks = chunks_at(stride)
    pc = -(-P // chunks)  # even chunks
    smem = copies * pc * stride * 8 + ring
    nb, rows_per_block = _row_blocks(
        n, R, P, chunks, 32, -(-n // (32 * copies)), smem
    )
    return dict(
        mode=mode, step=32, threads=32 * _WARPS, warps=_WARPS, copies=copies,
        warps_per_value_row=copies, k=k, rw=rw, stages=_stages(rw),
        stride=stride, tile=32, tile_shift=0, pc=pc, chunks=chunks, nb=nb,
        rows_per_block=rows_per_block, tree_bits=_TREE_BITS, smem=smem,
    )


def build(verbose: bool = False) -> tuple[pathlib.Path, float, str]:
    """Compile the kernel for sm_90a into ``build/kernels`` (skipped when a
    library of the same source is already there). Returns (library path,
    build seconds, compiler output). ``verbose`` adds ``-Xptxas -v`` (the
    registers and shared memory of each kernel)."""
    return cuda_build.build(SOURCE, verbose)


def _configure(lib) -> None:
    f = lib.onehot_sums_f64
    f.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    f.restype = ctypes.c_int
    lib.onehot_error_string.argtypes = [ctypes.c_int]
    lib.onehot_error_string.restype = ctypes.c_char_p


def _library():
    return cuda_build.load(SOURCE, _configure)


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
    if rid.dim() != 1 or vals.dim() != 2 or vals.shape[1] != rid.shape[0]:
        raise ValueError(
            f"onehot_sums: shapes rid {tuple(rid.shape)}, vals "
            f"{tuple(vals.shape)} (want (n,) and (R, n))"
        )
    R, n = vals.shape
    if not (1 <= P <= MAX_SLOTS) or not (1 <= R <= MAX_ROWS):
        raise ValueError(
            f"onehot_sums: P={P}, R={R} outside the kernel's range "
            f"(1..{MAX_SLOTS} slots, 1..{MAX_ROWS} value rows)"
        )
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
    if not (rid.is_contiguous() and vals.is_contiguous()):
        raise ValueError("onehot_sums: rid and vals must be contiguous")
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
            rid.data_ptr(), vals.data_ptr(), n, R, P, plan["threads"],
            plan["copies"], plan["stride"], plan["rw"], plan["stages"],
            plan["tree_bits"], plan["tile_shift"], plan["pc"],
            plan["chunks"], plan["nb"], plan["rows_per_block"], plan["smem"],
            partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(rid.device).cuda_stream,
        )
        if rc != 0:
            msg = lib.onehot_error_string(rc).decode()
            raise RuntimeError(f"onehot_sums kernel launch failed: {msg} ({rc})")
        with _count_lock:
            launches += 1
    return out
