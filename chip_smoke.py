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
   R = 14, P = 12), at P = 2048 and at a ragged n, with out-of-range slot
   ids and a NaN row: counts exact, sums within rtol 1e-12, the NaN in its
   own slot, two launches bit-identical. Times (CUDA events, after a
   warm-up): the kernel, the plain version, and one library call
   (``index_add_``) as a yardstick; the bound from the bytes and f64 adds.
   Then a sweep over slots P and value rows R at q1's batch size, timing
   the kernel against its plain version, which finds the P*R at which the
   kernel's P*n*R scan starts to lose to the plain scatter.
4. Main path: TPC-H ``lineitem`` at ``--sf`` (seed 42) through
   ``TorchContext(device="cuda").sql(q).collect()`` for q1 and q6, one cold
   and ``--warm`` warm runs each, checked against a numpy oracle written
   here (filter, ``np.unique``, ``np.add.at`` in f64): keys and counts
   exact, floats within rtol 1e-9. The kernel's launch counter is zeroed
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


def crossover(n: int, Rs: tuple, Ps: tuple, seed: int) -> dict:
    """Kernel and plain-version times over a grid of (R, P) at ``n`` rows,
    each point checked (counts exact, sums within rtol 1e-12). For each R,
    the smallest P*R at which the kernel is slower than the plain version
    (None if it never is on the grid)."""
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
            want = onehot_agg.onehot_sums_plain(rid, vals, P)
            tag = f"crossover n={n} R={R} P={P}"
            check(torch.equal(got[:, :m], want[:, :m]), f"{tag}: counts differ")
            check(
                torch.allclose(got, want, rtol=1e-12, atol=0.0), f"{tag}: sums differ"
            )
            ms = time_ms(lambda: onehot_agg.onehot_sums(rid, vals, P), iters=10)
            plain_ms = time_ms(lambda: onehot_agg.onehot_sums_plain(rid, vals, P), iters=10)
            points.append(dict(R=R, P=P, PR=P * R, ms=ms, plain_ms=plain_ms))
            if loses_at[R] is None and ms > plain_ms:
                loses_at[R] = P * R
    res = dict(n=n, points=points, kernel_loses_at_PR=loses_at)
    log(f"crossover: {json.dumps(res)}")
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
    for c in ("l_returnflag", "l_linestatus"):
        cols[c] = np.asarray(table.column(c).to_pylist())
    oracles = {"q1": oracle_q1(cols), "q6": oracle_q6(cols)}

    ctx = TorchContext(device="cuda")
    ctx.register_table("lineitem", table)
    queries = {
        q: (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text()
        for q in ("q1", "q6")
    }
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

    # 3. kernel vs plain
    cases = [
        kernel_case(1 << 21, 9, 5, 12, seed=1),   # q1 partial, full batch
        kernel_case(1 << 20, 9, 5, 12, seed=2),   # q1 partial, tail batch
        kernel_case(1 << 20, 9, 5, 2048, seed=3),  # the slot gate
        kernel_case(1_000_003, 9, 5, 12, seed=4),  # ragged n
        kernel_case(300_001, 16, 48, 37, seed=5),  # R = 64, ragged
    ]
    sweep = crossover(
        1 << 21, Rs=(6, 14, 64), Ps=(4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 512),
        seed=6,
    )

    # 4. main path
    mp = main_path(args.sf, args.seed, args.warm, args.profile)
    q1 = cases[0]

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
    }]
    log(json.dumps({
        "cases": cases,
        "crossover": sweep["kernel_loses_at_PR"],
        "queries": {q: mp[q] for q in ("q1", "q6")},
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
