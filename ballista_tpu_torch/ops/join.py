"""Join kernels: sort plus vectorized binary-search probe (port of
``ballista_tpu/ops/join.py``).

- **build**: a stable sort by (dead flag, packed 64-bit key): dead and
  null-key rows sink to the end, live rows come out compacted and
  key-sorted; every column rides one stacked gather.
- **probe**: ``searchsorted`` finds the start of the packed-key run, then
  a fixed-width window verifies the actual key columns, so hash packing can
  neither produce a wrong match nor miss a true one when distinct keys
  collide (runs longer than the window are flagged at build). A build whose
  live keys are exactly ``[lo, lo + n - 1]`` is probed by ``key - lo``
  (contiguous probe); an exact int key over a bounded domain can get a
  direct-address table (``attach_lut``).
- **expansion** (m:n): ``probe_counts`` finds each probe row's match run,
  ``expand_join`` materializes the output with a prefix sum and a
  searchsorted row assignment into a fixed output capacity.

Single int keys pack exactly; two int keys in 31/32-bit range pack exactly
as ``a << 32 | b`` (``exact2``); everything else hashes (``ops/hashing``)
with window-verified probes. Host syncs: the exact2 range check
(``_choose_pack_mode``) and ``BuildTable.flags`` each read the card once.
"""

from __future__ import annotations

import dataclasses
from enum import Enum

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.datatypes import DataType, Schema
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops.hashing import hash_columns
from ballista_tpu_torch.ops.perm import multi_key_perm, take_many_split
from ballista_tpu_torch.ops.search import searchsorted

# Max packed-key collision run the probe window resolves; longer runs set
# ``run_overflow`` at build.
COLLISION_WINDOW = 8

_I64_MAX = torch.iinfo(torch.int64).max


def _check_join_dictionaries(
    build: "BuildTable", probe: DeviceBatch, probe_key_idxs: list[int]
) -> None:
    """String join keys compare by dictionary code, so both sides must
    share the dictionary (the operator unifies them first)."""
    for bi, pi in zip(build.key_idxs, probe_key_idxs):
        bf = build.batch.schema.fields[bi]
        pf = probe.schema.fields[pi]
        if bf.dtype == DataType.STRING or pf.dtype == DataType.STRING:
            bd = build.batch.dictionaries.get(bf.name)
            pd_ = probe.dictionaries.get(pf.name)
            if bd is None or pd_ is None or bd.values != pd_.values:
                raise ExecutionError(
                    f"string join key {bf.name!r}/{pf.name!r} requires a "
                    "shared dictionary; unify dictionaries before the join"
                )


class JoinSide(Enum):
    INNER = "inner"
    LEFT = "left"  # probe rows preserved, build columns nulled on a miss
    SEMI = "semi"  # probe rows with a match (IN / EXISTS)
    ANTI = "anti"  # probe rows without a match (NOT EXISTS: null-key probe
    #   rows are kept, they match nothing)


def _is_int(t: torch.Tensor) -> bool:
    return not t.dtype.is_floating_point and t.dtype != torch.bool


def _pack_key(cols: list[torch.Tensor], mode: str) -> torch.Tensor:
    """Rows -> int64 key under a packing mode:

    - ``exact``: one integer column, as is;
    - ``exact2``: two integer columns, a in [0, 2^31) and b in [0, 2^32),
      packed ``a << 32 | b``; out-of-range probe values map to -1, below
      every in-range build key, so they never match (the build side was
      range-checked);
    - ``hash``: the 64-bit row hash (probes verify the actual columns).
    """
    if mode == "exact":
        return cols[0].to(torch.int64)
    if mode == "exact2":
        a = cols[0].to(torch.int64)
        b = cols[1].to(torch.int64)
        in_range = (a >= 0) & (a < 2**31) & (b >= 0) & (b < 2**32)
        return torch.where(in_range, (a << 32) | b, -1)
    return hash_columns(cols)


@dataclasses.dataclass
class BuildTable:
    """Build side, compacted and sorted by packed key."""

    batch: DeviceBatch  # columns in key-sorted order, live rows first
    keys: torch.Tensor  # int64[cap], dead slots forced to INT64_MAX
    key_cols: list[torch.Tensor]  # actual key columns, sorted order
    key_idxs: list[int]  # key column indices into batch.schema
    n: torch.Tensor  # int32 scalar: live build rows
    mode: str  # packing mode: "exact" | "exact2" | "hash"
    has_dups: torch.Tensor  # bool scalar: duplicate keys among live rows
    run_overflow: torch.Tensor  # bool scalar: collision run > COLLISION_WINDOW
    # contiguous-range probe (TPC-H dimension keys are 1..N): live keys
    # exactly [lo, lo + n - 1] with no duplicates
    lo: torch.Tensor  # int64 scalar: smallest live key (key 0 in exact2)
    contiguous: torch.Tensor  # bool scalar
    hi: torch.Tensor  # int64 scalar: largest live key (exact mode)
    # direct-address probe table (see attach_lut): lut2[k - lo] =
    # (first sorted row, run length)
    lut2: torch.Tensor | None = None
    _flags: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def exact(self) -> bool:
        """Packed key is injective (no window scan)."""
        return self.mode != "hash"

    def spec_flag(self) -> torch.Tensor:
        """Device bool: this build cannot serve as a unique-key probe table
        (duplicates or a collision-run overflow); validates cached build
        strategies without a host sync."""
        return self.has_dups | self.run_overflow

    def flags(self) -> tuple:
        """(has_dups, run_overflow, contiguous, lo, hi) in one device read,
        cached on the table."""
        if self._flags is None:
            got = torch.stack(
                [
                    self.has_dups.to(torch.int64),
                    self.run_overflow.to(torch.int64),
                    self.contiguous.to(torch.int64),
                    self.lo,
                    self.hi,
                ]
            ).tolist()
            self._flags = (bool(got[0]), bool(got[1]), bool(got[2]), got[3], got[4])
        return self._flags

    def check_overflow(self) -> None:
        if self.flags()[1]:
            raise ExecutionError(
                "join build side has a packed-hash collision run longer "
                f"than {COLLISION_WINDOW}; use an integer join key or "
                "reduce build size"
            )


def _build_prep(batch: DeviceBatch, key_idxs: list[int], mode: str):
    """(dead flag, packed key): the build sort's operands. NULL keys never
    match anything, so their rows are dead."""
    valid = batch.valid
    for i in key_idxs:
        nm = batch.nulls[i]
        if nm is not None:
            valid = valid & ~nm
    return ~valid, _pack_key([batch.columns[i] for i in key_idxs], mode)


def _exact2_range_ok(a: torch.Tensor, b: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Device bool: both (live) int key columns fit the exact2 ranges."""
    a = torch.where(live, a.to(torch.int64), 0)
    b = torch.where(live, b.to(torch.int64), 0)
    return ((a >= 0) & (a < 2**31) & (b >= 0) & (b < 2**32)).all()


def _build_finish(perm, dead, packed, batch: DeviceBatch, key_idxs: list[int], mode: str) -> BuildTable:
    """The build table from the sort permutation."""
    cap = batch.capacity
    dev = batch.device
    iota = torch.arange(cap, device=dev)
    n = (~dead).sum(dtype=torch.int32)
    valid_sorted = iota < n
    # a dead tail of INT64_MAX keeps ``keys`` sorted and inert to searchsorted
    keys_sorted = torch.where(valid_sorted, packed[perm], _I64_MAX)
    cols, nulls = take_many_split(list(batch.columns), list(batch.nulls), perm)
    sorted_batch = DeviceBatch(
        schema=batch.schema,
        columns=tuple(cols),
        valid=valid_sorted,
        nulls=tuple(nulls),
        dictionaries=dict(batch.dictionaries),
    )
    sorted_key_cols = [cols[i] for i in key_idxs]

    # equal actual keys are adjacent after the sort (exact packing is
    # injective; hash mode tie-breaks on the key columns), so one adjacent
    # compare finds duplicates in every mode
    pair_live = valid_sorted[1:] & valid_sorted[:-1]
    eq = keys_sorted[1:] == keys_sorted[:-1]
    for kc in sorted_key_cols:
        eq = eq & (kc[1:] == kc[:-1])
    dup = (pair_live & eq).any()
    last_i = (n.to(torch.int64) - 1).clamp(0, cap - 1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    if mode == "exact":
        # live keys exactly [lo, lo + n - 1] and unique <=> min and count
        # pin the max
        lo = keys_sorted[0]
        hi = keys_sorted[last_i]
        contiguous = (n > 0) & ~dup & (hi - lo == n.to(torch.int64) - 1)
    elif mode == "exact2":
        # the packed sort orders by the first key (the high word): a unique
        # contiguous first key admits direct indexing by key 0, with the
        # second key verified against the build row
        k0 = sorted_key_cols[0].to(torch.int64)
        lo = k0[0]
        dup0 = (pair_live & (k0[1:] == k0[:-1])).any()
        contiguous = (n > 0) & ~dup0 & (k0[last_i] - lo == n.to(torch.int64) - 1)
        hi = zero  # packed extremes: no direct-address table for exact2
    else:
        lo = zero
        contiguous = torch.zeros((), dtype=torch.bool, device=dev)
        hi = zero

    if mode != "hash":
        run_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        # length of each equal-packed run among live rows: the probe scans
        # a fixed window, so a longer run must fail loudly
        changed = torch.cat(
            [torch.ones(1, dtype=torch.bool, device=dev), keys_sorted[1:] != keys_sorted[:-1]]
        )
        seg = torch.cumsum(changed.to(torch.int64), 0) - 1
        seg = torch.where(valid_sorted, seg, cap)
        lengths = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        lengths = lengths.index_add_(0, seg, torch.ones_like(seg))[:cap]
        run_overflow = lengths.max() > COLLISION_WINDOW

    return BuildTable(
        batch=sorted_batch,
        keys=keys_sorted,
        key_cols=sorted_key_cols,
        key_idxs=list(key_idxs),
        n=n,
        mode=mode,
        has_dups=dup,
        run_overflow=run_overflow,
        lo=lo,
        contiguous=contiguous,
        hi=hi,
    )


def _choose_pack_mode(batch: DeviceBatch, key_idxs: list[int]) -> str:
    """The packing mode. exact2 needs a range check read by the host (one
    sync per build)."""
    key_cols = [batch.columns[i] for i in key_idxs]
    if len(key_cols) == 1 and _is_int(key_cols[0]):
        return "exact"
    if len(key_cols) == 2 and all(_is_int(c) for c in key_cols):
        live = batch.valid
        for i in key_idxs:
            nm = batch.nulls[i]
            if nm is not None:
                live = live & ~nm
        if bool(_exact2_range_ok(key_cols[0], key_cols[1], live)):
            return "exact2"
    return "hash"


def build_side(batch: DeviceBatch, key_idxs: list[int]) -> BuildTable:
    """Sort the build side by (dead, packed key) and finish the table.
    SQL equality: NULL keys never match, so such rows are dead."""
    mode = _choose_pack_mode(batch, key_idxs)
    dead, packed = _build_prep(batch, key_idxs, mode)
    # hash mode tie-breaks on the actual key columns, so duplicate keys
    # land adjacent (expansion needs contiguous runs; duplicate detection
    # one compare)
    passes = [(dead, False), (packed, False)]
    if mode == "hash":
        passes.extend((batch.columns[i], False) for i in key_idxs)
    perm = multi_key_perm(passes)
    return _build_finish(perm, dead, packed, batch, list(key_idxs), mode)


# Direct-address probe tables stay below this domain span.
LUT_MAX_DOMAIN = 1 << 26


def _lut(keys_sorted: torch.Tensor, lo: torch.Tensor, n: torch.Tensor, size: int) -> torch.Tensor:
    """int32[(size, 2)] direct-address table: row k - lo = (first sorted
    build row with key k, run length). The dead tail maps to a spare slot
    that is cut."""
    cap_b = keys_sorted.shape[0]
    dev = keys_sorted.device
    iota = torch.arange(cap_b, device=dev)
    rel = torch.where(iota < n, keys_sorted - lo, size).clamp(0, size)
    first = torch.full((size + 1,), cap_b, dtype=torch.int64, device=dev)
    first = first.scatter_reduce_(0, rel, iota, reduce="amin")[:size]
    count = torch.zeros(size + 1, dtype=torch.int64, device=dev)
    count = count.index_add_(0, rel, torch.ones_like(rel))[:size]
    return torch.stack([torch.where(count > 0, first, 0), count], dim=1).to(torch.int32)


def attach_lut(build: BuildTable, size: int) -> None:
    """Build and attach the direct-address probe table. ``size`` must cover
    ``hi - lo + 1``: callers check that from fresh flags, or by a deferred
    device flag (``lut_stale``)."""
    build.lut2 = _lut(build.keys, build.lo, build.n, size)


def lut_stale(build: BuildTable, size: int) -> torch.Tensor:
    """Device bool: the attached table no longer covers the live-key
    domain (the validator of cached table sizes)."""
    return (build.hi - build.lo) >= size


def _probe_live(probe: DeviceBatch, probe_key_idxs: list[int]) -> torch.Tensor:
    """Live probe rows whose keys are not NULL (NULL never matches)."""
    live = probe.valid
    for i in probe_key_idxs:
        nm = probe.nulls[i]
        if nm is not None:
            live = live & ~nm
    return live


def _joined_dicts(build: DeviceBatch, probe: DeviceBatch) -> dict:
    dicts = dict(build.dictionaries)
    for name, d in probe.dictionaries.items():
        if name in dicts and dicts[name].values != d.values:
            raise ExecutionError(
                f"string column {name!r} exists on both join sides with "
                "different dictionaries; rename/disambiguate before joining"
            )
        dicts[name] = d
    return dicts


def probe_side(
    build: BuildTable,
    probe: DeviceBatch,
    probe_key_idxs: list[int],
    join_type: JoinSide,
    out_schema: Schema | None = None,
    contiguous: bool = False,
) -> DeviceBatch:
    """Probe a unique-key build and construct the joined batch (probe
    capacity): probe columns, then build columns.

    ``contiguous=True``: the caller asserts (validated against
    ``build.contiguous``) that the live build keys are exactly
    ``[lo, lo + n - 1]`` and unique, so the match row is ``key - lo`` with
    a range check: no binary search, no verify gather."""
    _check_join_dictionaries(build, probe, probe_key_idxs)
    probe_keys = [probe.columns[i] for i in probe_key_idxs]
    packed = _pack_key(probe_keys, build.mode)
    cap_b = build.keys.shape[0]
    live = _probe_live(probe, probe_key_idxs)

    verify_after = False  # exact2: index by key 0, verify the rest
    if contiguous:
        if build.mode == "exact2":
            rel = probe_keys[0].to(torch.int64) - build.lo
            verify_after = True
        else:
            rel = packed - build.lo
        match = live & (rel >= 0) & (rel < build.n.to(torch.int64))
        cand = rel.clamp(0, cap_b - 1)
    elif build.lut2 is not None:
        # direct-address table: one gather, no search, no verify (exact
        # packing is injective)
        size = build.lut2.shape[0]
        rel = packed - build.lo
        g = build.lut2[rel.clamp(0, size - 1)]
        match = live & (rel >= 0) & (rel < size) & (g[:, 1] > 0)
        cand = g[:, 0].to(torch.int64).clamp(0, cap_b - 1)
    else:
        idx = searchsorted(build.keys, packed)
        # every true match lies in the packed-key run starting at idx
        window = 1 if build.exact else COLLISION_WINDOW
        match = torch.zeros_like(live)
        cand = idx.clamp(0, cap_b - 1)
        for j in range(window):
            cand_j = (idx + j).clamp(0, cap_b - 1)
            ok = (idx + j < build.n) & live
            for bk, pk in zip(build.key_cols, probe_keys):
                ok = ok & (bk[cand_j] == pk)
            cand = torch.where(ok & ~match, cand_j, cand)
            match = match | ok

    if join_type in (JoinSide.SEMI, JoinSide.ANTI):
        if verify_after:
            vk, _ = take_many_split(list(build.key_cols), [], cand)
            for bk, pk in zip(vk, probe_keys):
                match = match & (bk == pk)
        if join_type == JoinSide.SEMI:
            return probe.with_valid(match)
        return probe.with_valid(probe.valid & ~match)

    # INNER / LEFT: probe columns ++ build columns gathered at the candidate
    b = build.batch
    gath_cols, gath_m = take_many_split(list(b.columns), list(b.nulls), cand)
    if verify_after:
        # the key columns came along in the main gather
        for bi, pk in zip(build.key_idxs, probe_keys):
            match = match & (gath_cols[bi] == pk)
    gath_nulls: list[torch.Tensor | None] = []
    for m in gath_m:
        if join_type == JoinSide.LEFT:
            gath_nulls.append(~match if m is None else (m | ~match))
        else:
            gath_nulls.append(m)
    return DeviceBatch(
        schema=out_schema if out_schema is not None else probe.schema.join(b.schema),
        columns=tuple(probe.columns) + tuple(gath_cols),
        valid=match if join_type == JoinSide.INNER else probe.valid,
        nulls=tuple(probe.nulls) + tuple(gath_nulls),
        dictionaries=_joined_dicts(b, probe),
    )


# -- expansion (m:n) joins ----------------------------------------------------


def probe_counts(
    build: BuildTable, probe: DeviceBatch, probe_key_idxs: list[int]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per probe row: (first matching build row, match count, live flag).

    Exact packing: the match run is the packed-key run, found by a
    two-sided ``searchsorted`` (any duplication). Hash packing: a window
    scan (runs are bounded by COLLISION_WINDOW, checked at build); equal
    keys are contiguous thanks to the build's tie-break sort."""
    _check_join_dictionaries(build, probe, probe_key_idxs)
    probe_keys = [probe.columns[i] for i in probe_key_idxs]
    packed = _pack_key(probe_keys, build.mode)
    live = _probe_live(probe, probe_key_idxs)
    cap_b = build.keys.shape[0]
    n = build.n.to(torch.int64)

    if build.mode != "hash":
        if build.lut2 is not None:
            # first row and run length in one gather
            size = build.lut2.shape[0]
            rel = packed - build.lo
            g = build.lut2[rel.clamp(0, size - 1)].to(torch.int64)
            inb = live & (rel >= 0) & (rel < size)
            return g[:, 0], torch.where(inb, g[:, 1], 0), live
        # the dead tail's keys are INT64_MAX; clamping to n keeps a probe
        # key of INT64_MAX from matching dead slots
        lo = torch.minimum(searchsorted(build.keys, packed, side="left"), n)
        hi = torch.minimum(searchsorted(build.keys, packed, side="right"), n)
        return lo, torch.where(live, hi - lo, 0), live

    idx = searchsorted(build.keys, packed)
    first = torch.zeros_like(idx)
    found = torch.zeros_like(live)
    count = torch.zeros_like(idx)
    for j in range(COLLISION_WINDOW):
        cand_j = (idx + j).clamp(0, cap_b - 1)
        ok = (idx + j < n) & live
        for bk, pk in zip(build.key_cols, probe_keys):
            ok = ok & (bk[cand_j] == pk)
        first = torch.where(ok & ~found, cand_j, first)
        found = found | ok
        count = count + ok.to(torch.int64)
    return first, count, live


def expand_join(
    build: BuildTable,
    probe: DeviceBatch,
    first: torch.Tensor,
    count: torch.Tensor,
    eff: torch.Tensor,
    out_cap: int,
    join_type: JoinSide,
) -> tuple[DeviceBatch, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Materialize the m:n join output (probe ++ build columns).

    ``eff`` = output rows per probe row (INNER: ``count``; LEFT:
    ``max(count, 1)`` over preserved rows); ``out_cap`` is the output
    capacity (rows past it are lost, so the caller checks
    ``eff.sum() <= out_cap``). Returns ``(batch, i, k, real)``: the source
    probe row of each output row, the match ordinal within its run, and
    whether the row is a key match (not a LEFT null-extension row)."""
    cap_b = build.keys.shape[0]
    cap_p = probe.capacity
    inc = torch.cumsum(eff.to(torch.int64), 0)
    total = inc[-1]
    j = torch.arange(out_cap, device=inc.device)
    i = searchsorted(inc, j, side="right").clamp(0, cap_p - 1)
    k = j - (inc[i] - eff[i])
    valid_out = j < total
    real = valid_out & (k < count[i])
    bidx = (first[i] + k).clamp(0, cap_b - 1)

    b = build.batch
    p_cols, p_nulls = take_many_split(list(probe.columns), list(probe.nulls), i)
    b_cols, b_m = take_many_split(list(b.columns), list(b.nulls), bidx)
    out_nulls: list[torch.Tensor | None] = list(p_nulls)
    for m in b_m:
        if join_type == JoinSide.LEFT:
            out_nulls.append(~real if m is None else (m | ~real))
        else:
            out_nulls.append(m)
    batch = DeviceBatch(
        schema=probe.schema.join(b.schema),
        columns=tuple(p_cols) + tuple(b_cols),
        valid=valid_out if join_type != JoinSide.INNER else real,
        nulls=tuple(out_nulls),
        dictionaries=_joined_dicts(b, probe),
    )
    return batch, i, k, real
