#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ballista_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--sf 1] [--seed 42] [--warm 3] [--profile]

Phases, each of which fails the run (non-zero exit) when it fails:

1. Card: name, count, and ``nvidia-smi`` name and power limit. Without a
   CUDA device the script exits non-zero and prints no result.
2. Build: compile ``ballista_tpu_torch/csrc/onehot_agg.cu`` for sm_90a with
   nvcc and print the build seconds and the ``-Xptxas -v`` report.
3. Kernel against its plain version at q1's shapes (n = 2^21 and 2^20,
   R = 14, P = 12, and q1's R = 6 once columns without nulls share a count
   row), at P = 2048, 4096 and 65,536 and at a ragged n, with out-of-range
   slot ids and a NaN row: counts exact, sums within rtol 1e-12, the NaN in
   its own slot, two launches bit-identical. Times (CUDA events, after a
   warm-up): the kernel, the plain version, and one library call
   (``index_add_``) as a yardstick; the bound from the bytes and f64 adds.
   Then a sweep over slots P (1 to 65,536) and value rows R at q1's batch
   size, timing the kernel against its plain version (each point checked,
   two launches bit-identical), which finds for each R the P*R at which
   the kernel first loses to the plain scatter. Then the kernel's two
   launch modes ("lanes" and "owners", see ``ops/onehot_agg.launch_plan``)
   against each other and against ``index_add_`` from 256 slots on, on
   uniform slot ids, on Zipf-distributed ones (s = 1, hot slots scattered)
   and on ids of which 90% fall in one slot. Then the port's sort on the
   card against the CPU, on keys with +-0.0, NaN, a sign-bit NaN and +-inf.
4. Main path: TPC-H ``lineitem`` at ``--sf`` (seed 42) through
   ``TorchContext(device="cuda").sql(q).collect()`` for q1, q6 and a dense
   GROUP BY over four string keys (480 slots, ``WIDE_SQL``), one cold and
   ``--warm`` warm runs each, checked against a numpy oracle written here
   (filter, ``np.unique``, ``np.add.at`` in f64): keys and counts exact,
   floats within rtol 1e-9. The kernel's launch counter is zeroed
   just before and read just after; q1 must launch it (at SF >= 1, at
   least 4 times in one run).
   With ``--profile``, one more warm run of each query is traced with
   ``torch.profiler`` (device time by kernel, device idle share).
5. One JSON line of kernel results, then the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12  # f64 outside the tensor cores


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3: the kernel against its plain version ---------------------------


def kernel_case(n: int, m: int, n_sums: int, P: int, seed: int) -> dict:
    """One comparison at (n rows, m count rows + n_sums sum rows, P slots),
    with slot ids in [-1, P] (both ends dropped) and one NaN."""
    import torch

    from ballista_tpu_torch.ops import onehot_agg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rid = torch.randint(-1, P + 1, (n,), generator=g, device=dev, dtype=torch.int32)
    R = m + n_sums
    vals = torch.empty(R, n, dtype=torch.float64, device=dev)
    vals[:m] = (torch.rand(m, n, generator=g, device=dev) < 0.9).to(torch.float64)
    vals[m:] = torch.rand(n_sums, n, generator=g, device=dev, dtype=torch.float64) * 1e4
    # one NaN in the first sum row, on a row that lands in slot `nan_slot`
    nan_row = int(torch.nonzero((rid >= 0) & (rid < P))[0, 0])
    nan_slot = int(rid[nan_row])
    vals[m, nan_row] = float("nan")

    got = onehot_agg.onehot_sums(rid, vals, P)
    again = onehot_agg.onehot_sums(rid, vals, P)
    want = onehot_agg.onehot_sums_plain(rid, vals, P)
    torch.cuda.synchronize()
    tag = f"n={n} R={R} P={P}"
    check(got.shape == (P, R), f"{tag}: shape {tuple(got.shape)}")
    check(
        torch.equal(got.view(torch.int64), again.view(torch.int64)),
        f"{tag}: two launches differ",
    )
    check(torch.equal(got[:, :m], want[:, :m]), f"{tag}: counts differ")
    nan_mask = torch.isnan(got)
    expect_nan = torch.zeros_like(nan_mask)
    expect_nan[nan_slot, m] = True
    check(torch.equal(nan_mask, expect_nan), f"{tag}: NaN not confined to its slot")
    ok = ~expect_nan
    err = (got[ok] - want[ok]).abs()
    rel = (err / want[ok].abs().clamp(min=1e-300)).max().item()
    check(
        torch.allclose(got[ok], want[ok], rtol=1e-12, atol=0.0),
        f"{tag}: sums differ, max rel err {rel:.3e}",
    )

    # timing (the NaN stays; it does not change the work)
    # the yardstick is one index_add_ call into a (P + 1, R) buffer whose
    # spare row takes the dropped rows (repeated calls accumulate; the work
    # is the same)
    idx = torch.where((rid >= 0) & (rid < P), rid, P).long()
    vt = vals.T
    buf = torch.zeros(P + 1, R, dtype=torch.float64, device=dev)

    def library():
        return buf.index_add_(0, idx, vt)

    ms = time_ms(lambda: onehot_agg.onehot_sums(rid, vals, P))
    plain_ms = time_ms(lambda: onehot_agg.onehot_sums_plain(rid, vals, P))
    library_ms = time_ms(library)
    bytes_moved = 4 * n + 8 * R * n + 8 * P * R
    ms_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    ms_ops = n * R / FP64_FLOPS * 1e3
    res = dict(
        n=n, R=R, P=P, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(ms_bytes, ms_ops),
        bound_by="bytes" if ms_bytes >= ms_ops else "operations",
        max_abs_err=err.max().item(), max_rel_err=rel,
        plan=onehot_agg.launch_plan(n, R, P),
    )
    log(f"kernel {tag}: ok  {json.dumps(res)}")
    return res


def slot_ids(n: int, P: int, dist: str, g):
    """Slot ids in [0, P) on the card: "uniform"; "zipf" (the slot of rank
    k drawn with weight 1/k, ranks scattered over the slots by a random
    permutation); "hot90" (90% of the rows in slot P // 3, the rest
    uniform)."""
    import torch

    dev = torch.device("cuda")
    rid = torch.randint(0, P, (n,), generator=g, device=dev, dtype=torch.int32)
    if dist == "hot90":
        hot = torch.rand(n, generator=g, device=dev) < 0.9
        return torch.where(hot, torch.full_like(rid, P // 3), rid)
    if dist == "zipf":
        cdf = torch.cumsum(1.0 / torch.arange(1, P + 1, device=dev, dtype=torch.float64), 0)
        u = torch.rand(n, generator=g, device=dev, dtype=torch.float64) * cdf[-1]
        rank = torch.searchsorted(cdf, u).clamp(max=P - 1)
        perm = torch.randperm(P, generator=g, device=dev)
        return perm[rank].to(torch.int32)
    return rid


def check_sums(tag: str, got, again, want, m: int) -> None:
    """Two launches bit-identical, the m count rows exact, every sum within
    rtol 1e-12 of the plain version."""
    import torch

    check(
        torch.equal(got.view(torch.int64), again.view(torch.int64)),
        f"{tag}: two launches differ",
    )
    check(torch.equal(got[:, :m], want[:, :m]), f"{tag}: counts differ")
    check(torch.allclose(got, want, rtol=1e-12, atol=0.0), f"{tag}: sums differ")


def modes(n: int, Rs: tuple, Ps: tuple, dists: tuple, seed: int) -> dict:
    """The kernel in each launch mode ("lanes", "owners") and one
    ``index_add_`` call, per slot-id distribution, R and P; each launch
    checked against the plain version."""
    import torch

    from ballista_tpu_torch.ops import onehot_agg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    auto = onehot_agg.launch_plan
    points = []
    try:
        for R in Rs:
            m = max(1, R // 2)
            vals = torch.empty(R, n, dtype=torch.float64, device=dev)
            vals[:m] = (torch.rand(m, n, generator=g, device=dev) < 0.9).to(torch.float64)
            vals[m:] = torch.rand(R - m, n, generator=g, device=dev, dtype=torch.float64)
            for dist in dists:
                for P in Ps:
                    rid = slot_ids(n, P, dist, g)
                    want = onehot_agg.onehot_sums_plain(rid, vals, P)
                    buf = torch.zeros(P + 1, R, dtype=torch.float64, device=dev)
                    idx, vt = rid.long(), vals.T
                    point = dict(R=R, P=P, dist=dist, auto=auto(n, R, P)["mode"])
                    for mode in ("lanes", "owners"):
                        onehot_agg.launch_plan = (
                            lambda n_, R_, P_, mode=mode: auto(n_, R_, P_, mode)
                        )
                        got = onehot_agg.onehot_sums(rid, vals, P)
                        again = onehot_agg.onehot_sums(rid, vals, P)
                        check_sums(f"{mode} n={n} R={R} P={P} {dist}", got, again, want, m)
                        point[mode + "_ms"] = time_ms(
                            lambda: onehot_agg.onehot_sums(rid, vals, P), iters=10
                        )
                        onehot_agg.launch_plan = auto
                    point["library_ms"] = time_ms(lambda: buf.index_add_(0, idx, vt), iters=10)
                    points.append(point)
    finally:
        onehot_agg.launch_plan = auto
    res = dict(n=n, points=points)
    log(f"modes: {json.dumps(res)}")
    return res


def crossover(n: int, Rs: tuple, Ps: tuple, seed: int) -> dict:
    """Kernel and plain-version times over a grid of (R, P) at ``n`` rows,
    each point checked (two launches bit-identical, counts exact, sums
    within rtol 1e-12). For each R, the smallest P*R at which the kernel is
    slower than the plain version (None if it never is on the grid)."""
    import torch

    from ballista_tpu_torch.ops import onehot_agg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    points, loses_at = [], {}
    for R in Rs:
        m = max(1, R // 2)
        vals = torch.empty(R, n, dtype=torch.float64, device=dev)
        vals[:m] = (torch.rand(m, n, generator=g, device=dev) < 0.9).to(torch.float64)
        vals[m:] = torch.rand(R - m, n, generator=g, device=dev, dtype=torch.float64)
        loses_at[R] = None
        for P in Ps:
            rid = torch.randint(0, P, (n,), generator=g, device=dev, dtype=torch.int32)
            got = onehot_agg.onehot_sums(rid, vals, P)
            again = onehot_agg.onehot_sums(rid, vals, P)
            want = onehot_agg.onehot_sums_plain(rid, vals, P)
            check_sums(f"crossover n={n} R={R} P={P}", got, again, want, m)
            ms = time_ms(lambda: onehot_agg.onehot_sums(rid, vals, P), iters=10)
            plain_ms = time_ms(lambda: onehot_agg.onehot_sums_plain(rid, vals, P), iters=10)
            plan = onehot_agg.launch_plan(n, R, P)
            points.append(dict(
                R=R, P=P, PR=P * R, ms=ms, plain_ms=plain_ms, mode=plan["mode"],
                chunks=plan["chunks"],
            ))
            if loses_at[R] is None and ms > plain_ms:
                loses_at[R] = P * R
    res = dict(n=n, points=points, kernel_loses_at_PR=loses_at)
    log(f"crossover: {json.dumps(res)}")
    return res


def sort_check(seed: int) -> dict:
    """``ops/sort.stable_argsort`` on the card against the CPU, in both
    directions, on f64 and f32 keys holding +-0.0, NaN, a NaN with its sign
    bit set, +-inf and ties: at n = 8 and at n = 2^21, so that both of
    torch's CUDA sort paths (the in-block sort and the radix sort) run."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops.sort import stable_argsort

    signed_nan = np.frombuffer(
        np.array([0xFFF8000000000001], dtype=np.uint64).tobytes(), dtype=np.float64
    )[0]
    specials = np.array(
        [0.0, -0.0, np.nan, signed_nan, np.inf, -np.inf, 1.0, -1.0, -0.0, 1.0]
    )
    rng = np.random.default_rng(seed)
    checked = 0
    for n in (8, 1 << 21):
        x = rng.choice(specials, n)
        x[: min(n, 8)] = specials[[3, 1, 0, 2, 4, 5, 8, 6]][:n]
        for dt in (torch.float64, torch.float32):
            t = torch.from_numpy(x).to(dt)
            for desc in (False, True):
                want = stable_argsort(t, desc)
                got = stable_argsort(t.cuda(), desc).cpu()
                check(
                    torch.equal(got, want),
                    f"sort n={n} {dt} descending={desc}: the card's permutation "
                    "differs from the CPU's",
                )
                checked += 1
    res = dict(cases=checked, ok=True)
    log(f"sort: ok  {json.dumps(res)}")
    return res


# -- phase 4: the main path against a numpy oracle ---------------------------


def oracle_q1(cols: dict):
    import numpy as np

    keep = cols["l_shipdate"] <= 10471  # date '1998-12-01' - interval '90' day
    rf = cols["l_returnflag"][keep]
    ls = cols["l_linestatus"][keep]
    qty = cols["l_quantity"][keep]
    price = cols["l_extendedprice"][keep]
    disc = cols["l_discount"][keep]
    tax = cols["l_tax"][keep]
    keys = np.char.add(rf.astype("U1"), ls.astype("U1"))
    uniq, inv = np.unique(keys, return_inverse=True)
    g = len(uniq)

    def gsum(v):
        out = np.zeros(g, dtype=np.float64)
        np.add.at(out, inv, v.astype(np.float64))
        return out

    cnt = np.zeros(g, dtype=np.int64)
    np.add.at(cnt, inv, 1)
    disc_price = price * (1 - disc)
    return {
        "l_returnflag": [k[0] for k in uniq],
        "l_linestatus": [k[1] for k in uniq],
        "sum_qty": gsum(qty),
        "sum_base_price": gsum(price),
        "sum_disc_price": gsum(disc_price),
        "sum_charge": gsum(disc_price * (1 + tax)),
        "avg_qty": gsum(qty) / cnt,
        "avg_price": gsum(price) / cnt,
        "avg_disc": gsum(disc) / cnt,
        "count_order": cnt,
    }


# A dense GROUP BY over four string keys of lineitem: 8 * 5 * 4 * 3 = 480
# slots (each vocabulary plus NULL), where q1 has 12.
WIDE_SQL = (
    "select l_shipmode, l_shipinstruct, l_returnflag, l_linestatus, "
    "count(*) as count_order, sum(l_quantity) as sum_qty, "
    "sum(l_extendedprice) as sum_base_price, avg(l_discount) as avg_disc "
    "from lineitem group by l_shipmode, l_shipinstruct, l_returnflag, "
    "l_linestatus order by l_shipmode, l_shipinstruct, l_returnflag, l_linestatus"
)


def oracle_wide(cols: dict):
    import numpy as np

    names = ("l_shipmode", "l_shipinstruct", "l_returnflag", "l_linestatus")
    # each key's sorted values and codes, mixed into one group number whose
    # order is that of the key tuples
    vocab, code = [], np.zeros(len(cols[names[0]]), dtype=np.int64)
    for c in names:
        v, inv = np.unique(cols[c], return_inverse=True)
        vocab.append(v)
        code = code * len(v) + inv
    groups, inv = np.unique(code, return_inverse=True)
    g = len(groups)

    def gsum(v):
        out = np.zeros(g, dtype=np.float64)
        np.add.at(out, inv, v.astype(np.float64))
        return out

    cnt = np.zeros(g, dtype=np.int64)
    np.add.at(cnt, inv, 1)
    out = {}
    rest = groups
    for c, v in reversed(list(zip(names, vocab))):
        out[c] = list(v[rest % len(v)])
        rest = rest // len(v)
    out = {c: out[c] for c in names}
    out.update(
        count_order=cnt,
        sum_qty=gsum(cols["l_quantity"]),
        sum_base_price=gsum(cols["l_extendedprice"]),
        avg_disc=gsum(cols["l_discount"]) / cnt,
    )
    return out


def oracle_q6(cols: dict):
    import numpy as np

    d = cols["l_shipdate"]
    disc = cols["l_discount"]
    keep = (
        (d >= 8766) & (d < 9131)  # [1994-01-01, 1995-01-01)
        & (disc >= 0.05) & (disc <= 0.07) & (cols["l_quantity"] < 24)
    )
    return {"revenue": np.array([np.sum(cols["l_extendedprice"][keep] * disc[keep])])}


def compare(name: str, got, want: dict) -> None:
    import numpy as np

    check(got.column_names == list(want), f"{name}: columns {got.column_names}")
    for c, w in want.items():
        a = got.column(c).to_pylist()
        check(len(a) == len(w), f"{name}.{c}: {len(a)} rows, oracle {len(w)}")
        if isinstance(w, np.ndarray) and w.dtype.kind == "f":
            check(
                np.allclose(np.asarray(a, dtype=np.float64), w, rtol=1e-9, atol=0.0),
                f"{name}.{c}: {a} vs oracle {w.tolist()}",
            )
        else:
            check(list(a) == list(w), f"{name}.{c}: {a} vs oracle {list(w)}")


def profile_query(ctx, q: str, sql: str) -> dict:
    """One warm run under torch.profiler: wall time, device time summed over
    kernels (one stream, so kernels do not overlap), the device's idle share
    of the wall time, and the kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, plan = ctx.sql(sql).collect_with_plan()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    log(f"{q} plan with host-side operator metrics:\n{plan.display(with_metrics=True)}")

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    # device-side rows only (kernels, copies, fills): the host-side aten::
    # rows carry the same device time again, attributed to the op
    events = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == DeviceType.CUDA and dev_us(e) > 0
    ]
    busy_s = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:12]
    res = {
        "wall_s": wall,
        "device_busy_s": busy_s,
        "device_idle_share": (1.0 - busy_s / wall) if busy_s else None,
        "top": [[e.key[:80], e.count, dev_us(e) / 1e3] for e in top],
    }
    log(f"{q} profile: {json.dumps(res)}")
    return res


def main_path(sf: float, seed: int, warm: int, profile: bool) -> dict:
    import numpy as np
    import torch

    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.ops import onehot_agg
    from ballista_tpu_torch.tpch import gen_table

    t0 = time.perf_counter()
    table = gen_table("lineitem", sf, seed)
    log(f"lineitem sf={sf} seed={seed}: {table.num_rows} rows, "
        f"{table.num_columns} columns, generated in {time.perf_counter() - t0:.1f}s")
    cols = {}
    for c in ("l_quantity", "l_extendedprice", "l_discount", "l_tax"):
        cols[c] = table.column(c).to_numpy()
    cols["l_shipdate"] = table.column("l_shipdate").cast("int32").to_numpy()
    for c in ("l_returnflag", "l_linestatus", "l_shipmode", "l_shipinstruct"):
        cols[c] = np.asarray(table.column(c).to_pylist())
    oracles = {"q1": oracle_q1(cols), "q6": oracle_q6(cols), "wide": oracle_wide(cols)}

    ctx = TorchContext(device="cuda")
    ctx.register_table("lineitem", table)
    queries = {
        q: (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text()
        for q in ("q1", "q6")
    }
    queries["wide"] = WIDE_SQL
    out = {}
    torch.cuda.reset_peak_memory_stats()
    onehot_agg.launches = 0  # main path starts here
    for q, sql in queries.items():
        before = onehot_agg.launches
        t = time.perf_counter()
        res = ctx.sql(sql).collect()
        cold = time.perf_counter() - t
        cold_launches = onehot_agg.launches - before
        compare(q, res, oracles[q])
        warm_s = []
        for _ in range(warm):
            t = time.perf_counter()
            res = ctx.sql(sql).collect()
            torch.cuda.synchronize()
            warm_s.append(time.perf_counter() - t)
            compare(q, res, oracles[q])
        out[q] = dict(
            cold_s=cold, warm_s=warm_s, rows=res.num_rows,
            kernel_launches_cold_run=cold_launches,
        )
        log(f"{q}: ok  {json.dumps(out[q])}")
    launches = onehot_agg.launches  # main path ends here
    peak = torch.cuda.max_memory_allocated()
    if profile:
        for q, sql in queries.items():
            out[q]["profile"] = profile_query(ctx, q, sql)
    check(out["q1"]["kernel_launches_cold_run"] > 0, "q1 did not launch the kernel")
    check(out["wide"]["kernel_launches_cold_run"] > 0, "wide did not launch the kernel")
    if sf >= 1:
        check(
            out["q1"]["kernel_launches_cold_run"] >= 4,
            f"q1 launched the kernel {out['q1']['kernel_launches_cold_run']} "
            "times in one run; at SF>=1 it must launch at least 4",
        )
    log(f"main path: kernel launches {launches}, peak device memory "
        f"{peak} bytes ({peak / 2**30:.3f} GiB)")
    out["launches"] = launches
    out["peak_bytes"] = peak
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument(
        "--profile", action="store_true",
        help="after the main path, trace one warm run of each query with "
        "torch.profiler and print the device time by kernel",
    )
    args = ap.parse_args()

    check((ROOT / "ballista_tpu_torch").is_dir(), f"no ballista_tpu_torch beside {__file__}")
    import torch

    check(torch.cuda.is_available(), "no CUDA device: the port's smoke run needs a card")
    sys.path.insert(0, str(ROOT))
    from ballista_tpu_torch.ops import onehot_agg

    # 1. card
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"card: {name}, count {count}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build
    path, secs, report = onehot_agg.build(verbose=True)
    log(f"build: {path.name} in {secs:.2f}s")
    for line in report.splitlines():
        if "registers" in line or "smem" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain; the sort on the card vs the CPU
    cases = [
        kernel_case(1 << 21, 9, 5, 12, seed=1),   # q1 partial, full batch
        kernel_case(1 << 20, 9, 5, 12, seed=2),   # q1 partial, tail batch
        kernel_case(1 << 20, 9, 5, 2048, seed=3),  # the old 2048-slot gate
        kernel_case(1_000_003, 9, 5, 12, seed=4),  # ragged n
        kernel_case(300_001, 16, 48, 37, seed=5),  # R = 64, ragged
        kernel_case(1 << 20, 9, 5, 4096, seed=7),  # several slot chunks
        kernel_case(1 << 21, 9, 5, 65536, seed=8),  # the largest dense space
        kernel_case(1 << 21, 1, 5, 12, seed=9),   # q1 now: one shared count row
        kernel_case(1 << 20, 1, 5, 12, seed=11),  # q1 now, tail batch (padded)
    ]
    sweep = crossover(
        1 << 21, Rs=(6, 14, 64),
        Ps=(1, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 512, 1024, 2048, 8192,
            65536),
        seed=6,
    )
    by_mode = modes(
        1 << 21, Rs=(6, 14), Ps=(256, 1024, 2048, 8192, 65536),
        dists=("uniform", "zipf", "hot90"), seed=12,
    )
    sorted_ok = sort_check(seed=10)

    # 4. main path
    mp = main_path(args.sf, args.seed, args.warm, args.profile)
    q1, q1_now = cases[0], cases[7]

    # 5. results
    kernels = [{
        "name": "onehot_sums",
        "route": "cuda",
        "source": "ballista_tpu_torch/csrc/onehot_agg.cu",
        "replaces": "ballista_tpu/ops/pallas_agg.py:66",
        "launches": mp["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": q1["ms"],
        "plain_ms": q1["plain_ms"],
        "bound_ms": q1["bound_ms"],
        "bound_by": q1["bound_by"],
        "library_ms": q1["library_ms"],
        "bound_share": q1["bound_ms"] / q1["ms"],
        # q1's shape now (R = 6: columns without nulls share a count row)
        "ms_at_q1_now": q1_now["ms"],
        "bound_ms_at_q1_now": q1_now["bound_ms"],
        "bound_share_at_q1_now": q1_now["bound_ms"] / q1_now["ms"],
    }]
    log(json.dumps({
        "cases": cases,
        "crossover": sweep["kernel_loses_at_PR"],
        "modes": by_mode["points"],
        "sort": sorted_ok,
        "queries": {q: mp[q] for q in ("q1", "q6", "wide")},
        "peak_bytes": mp["peak_bytes"],
        "sf": args.sf,
    }))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
