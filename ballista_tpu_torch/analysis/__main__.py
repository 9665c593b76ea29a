"""Combined static-analysis gate: ``python -m ballista_tpu_torch.analysis``.

The port's copy of ``ballista_tpu/analysis/__main__.py``: the reference's
analyzers over ``ballista_tpu_torch/``, with ``devlint`` in ``jaxlint``'s
slot (the port runs no JAX program). Twelve analyzers, one exit code and
one summary line each:

- **planlint** — the port's plan verifier over the TPC-H q1-q22 corpus
  (logical + physical tiers, plus distributed stage DAGs).
- **serde-audit** — structural closure of the proto vocabulary
  (round-trip byte stability or written exemption for every node class).
- **devlint** — the card's hazards (host syncs, value-dependent sizes,
  float sums in no fixed order) in the device programs, and the device
  programs closed over the source in both directions
  (``compilecache.registry.check_vocabulary``).
- **racelint** — lock-discipline + state-machine lint over the
  concurrent control plane, the ``obs/`` trace ring/outbox, and the
  kernel builder and wrappers (``ops/cuda_build.py``, ``ops/onehot_agg.py``,
  ``ops/partition.py``, ``ops/prefix_sum.py``).
- **compile-vocab** — the device-program closure
  (``compilecache/registry.py``): every declared program resolves in the
  source (``check_programs``), and every operator class of the TPC-H
  physical and stage plans declares the programs it may run
  (``check_plan``).
- **lifelint** — resource-lifecycle + error-taxonomy lint over the
  control & data planes, with its runtime counterpart in
  :mod:`ballista_tpu_torch.analysis.reswitness`.
- **proto-drift** — the repo's proto TEXT (``proto/*.proto``) against the
  port's generated DESCRIPTOR plus the committed field-number ledger
  (``proto/field_numbers.json``), both read and never written.
- **config-registry** — every ``ballista.*`` config-key literal and
  ``BALLISTA_*`` env read site must resolve to a declared registry
  entry, and ``ballista_tpu_torch/docs/config.md`` must match the
  generated table.
- **eqlint** — the no-uncertified-mutation closure over ``rewrite.py``.
- **detlint** — determinism lint (unordered set iteration, undeclared
  RNG, wall-clock reads in the data plane, completion-order merges).
- **stalelint** — cache-coherence lint over the declared cache registry
  (``analysis/cachereg.py``).
- **durlint** — distributed-durability lint over the declared state
  registry (``analysis/durreg.py``); its runtime counterpart is the
  durability witness (:mod:`ballista_tpu_torch.analysis.durwitness`,
  ``BALLISTA_DUR_WITNESS=1``).

Suppression budgets for every AST analyzer live in ONE ledger
(:mod:`ballista_tpu_torch.analysis.budget`) enforced here.

Analyzers run CONCURRENTLY by default (the two TPC-H-corpus analyzers —
planlint and compile-vocab — share one worker since both build the same
context); ``--serial`` restores one-at-a-time execution. Output order is
fixed regardless.

Flags: ``--json`` emits one machine-readable document (per-analyzer
ok/summary/seconds, the suppression ledger, and the failure list);
``--list`` prints the registered analyzer names one per line; ``--dot``
prints the racelint lock-order graph (Graphviz) and exits; ``--tables``
prints the canonical status state machines and exits;
``--write-config-docs`` regenerates ``ballista_tpu_torch/docs/config.md``
and exits; ``--skip a,b`` / ``--only a,b`` select analyzers;
``--queries 1,3,6`` limits the TPC-H corpus; ``--device`` is where the
corpus analyzers' contexts hold their tables (default ``cuda``, as every
entry point of the port; ``cpu`` needs no card).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

ANALYZERS = (
    "planlint", "serde-audit", "devlint", "racelint", "compile-vocab",
    "lifelint", "proto-drift", "config-registry", "eqlint", "detlint",
    "stalelint", "durlint",
)

# analyzers sharing one worker under parallel execution: planlint and
# compile-vocab both build a TorchContext + the TPC-H corpus; running them
# in a single group avoids doing that heavy setup twice concurrently
_SHARED_CORPUS = ("planlint", "compile-vocab")


def _corpus_context(device: str):
    """A context holding the TPC-H tables at SF=0.001 on ``device``."""
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.tpch import gen_all

    ctx = TorchContext(device=device)
    for name, tab in gen_all(scale=0.001).items():
        ctx.register_table(name, tab)
    return ctx


def run_planlint(queries=None, device: str = "cuda") -> tuple[bool, str]:
    import pathlib

    from ballista_tpu_torch.analysis import (
        verify_logical,
        verify_physical,
        verify_stages,
    )
    from ballista_tpu_torch.distributed_plan import DistributedPlanner
    from ballista_tpu_torch.exec.planner import PhysicalPlanner
    from ballista_tpu_torch.plan.optimizer import optimize

    qdir = (
        pathlib.Path(__file__).resolve().parents[2]
        / "benchmarks" / "queries"
    )
    ctx = _corpus_context(device)
    qs = list(queries) if queries else list(range(1, 23))
    checks = 0
    for i in qs:
        sql = (qdir / f"q{i}.sql").read_text()
        optimized = optimize(ctx.sql_to_logical(sql))
        checks += verify_logical(optimized, sql=sql).checks
        phys = ctx.create_physical_plan(optimized, sql=sql)
        checks += verify_physical(phys, sql=sql).checks
        dist = PhysicalPlanner(
            ctx, 2, config=ctx.config, distributed=True
        ).plan(optimized)
        stages = DistributedPlanner().plan_query_stages(f"job-q{i}", dist)
        checks += verify_stages(stages, sql=sql).checks
    return True, f"{len(qs)} TPC-H queries verified ({checks} checks)"


def run_serde_audit(device: str = "cuda") -> tuple[bool, str]:
    from ballista_tpu_torch.analysis.serde_audit import (
        audit_expressions,
        audit_logical,
        audit_physical,
    )

    results = [
        audit_expressions(), audit_logical(), audit_physical(device=device)
    ]
    ok = all(r.ok for r in results)
    return ok, "; ".join(r.summary() for r in results)


def run_devlint() -> tuple[bool, str]:
    from ballista_tpu_torch.analysis import budget, devlint
    from ballista_tpu_torch.compilecache import registry

    problems = registry.check_vocabulary()
    diags = devlint.lint_paths()
    sup = devlint.suppression_count()
    if problems or diags:
        return False, "\n".join(problems + [str(d) for d in diags])
    over = budget.check("devlint", sup)
    if over:
        return False, over
    return True, (
        f"0 findings, {sup} suppressions, {len(registry.PROGRAMS)} device "
        f"programs and {len(registry.HOST_ONLY)} host-only entries closed "
        "over the source"
    )


def run_racelint() -> tuple[bool, str]:
    from ballista_tpu_torch.analysis import budget, racelint

    analysis = racelint.analyze()  # one parse+fixpoint for all three views
    diags = analysis.diagnostics()
    sup = analysis.suppression_count()
    edges = analysis.lock_edges()
    if diags:
        return False, "\n".join(str(d) for d in diags)
    over = budget.check("racelint", sup)
    if over:
        return False, over
    return True, (
        f"0 findings, {sup} suppressions, lock-order graph: "
        f"{len(edges)} edges, acyclic"
    )


def run_compile_vocab(queries=None, device: str = "cuda") -> tuple[bool, str]:
    """Closed device-program gate: every entry of
    compilecache.registry.PROGRAMS must resolve in the source, and every
    operator class in the TPC-H physical/stage plans must be mapped in
    OPERATOR_KERNELS."""
    import pathlib

    from ballista_tpu_torch.compilecache import registry
    from ballista_tpu_torch.distributed_plan import DistributedPlanner
    from ballista_tpu_torch.exec.planner import PhysicalPlanner
    from ballista_tpu_torch.plan.optimizer import optimize

    problems = registry.check_programs()

    qdir = (
        pathlib.Path(__file__).resolve().parents[2]
        / "benchmarks" / "queries"
    )
    ctx = _corpus_context(device)
    qs = list(queries) if queries else list(range(1, 23))
    kernels: set[str] = set()
    for i in qs:
        sql = (qdir / f"q{i}.sql").read_text()
        optimized = optimize(ctx.sql_to_logical(sql))
        phys = ctx.create_physical_plan(optimized, sql=sql)
        problems += [
            f"q{i} (physical): {p}" for p in registry.check_plan(phys)
        ]
        kernels |= registry.plan_kernels(phys)
        dist = PhysicalPlanner(
            ctx, 2, config=ctx.config, distributed=True
        ).plan(optimized)
        stages = DistributedPlanner().plan_query_stages(f"job-q{i}", dist)
        for st in stages:
            problems += [
                f"q{i} (stage {st.stage_id}): {p}"
                for p in registry.check_plan(st.plan)
            ]
            kernels |= registry.plan_kernels(st.plan)
    if problems:
        return False, "\n".join(problems)
    return True, (
        f"{len(registry.PROGRAMS)} device programs registered; {len(qs)} "
        f"TPC-H queries lower onto {len(kernels)} of them, all declared"
    )


def run_lifelint() -> tuple[bool, str]:
    from ballista_tpu_torch.analysis import budget, lifelint

    diags = lifelint.lint_paths()
    sup = lifelint.suppression_count()
    transfers = lifelint.transfer_sites()
    if diags:
        return False, "\n".join(str(d) for d in diags)
    over = budget.check("lifelint", sup)
    if over:
        return False, over
    return True, (
        f"0 findings, {sup} suppressions, {len(transfers)} declared "
        "ownership transfers"
    )


def run_proto_drift() -> tuple[bool, str]:
    from ballista_tpu_torch.analysis import protodrift

    return protodrift.run()


def run_config_registry() -> tuple[bool, str]:
    from ballista_tpu_torch.analysis import configlint

    return configlint.run()


def run_eqlint() -> tuple[bool, str]:
    from ballista_tpu_torch.analysis import budget, eqlint

    diags = eqlint.lint_paths()
    sup = eqlint.suppression_count()
    if diags:
        return False, "\n".join(str(d) for d in diags)
    over = budget.check("eqlint", sup)
    if over:
        return False, over
    return True, (
        f"0 findings, {sup} suppressions (plan mutation closed over "
        "rewrite.py)"
    )


def run_detlint() -> tuple[bool, str]:
    from ballista_tpu_torch.analysis import budget, detlint

    diags = detlint.lint_paths()
    sup = detlint.suppression_count()
    nondet = detlint.nondet_sites()
    if diags:
        return False, "\n".join(str(d) for d in diags)
    over = budget.check("detlint", sup)
    if over:
        return False, over
    return True, (
        f"0 findings, {sup} suppressions, {len(nondet)} declared "
        "nondeterminism sites"
    )


def run_stalelint() -> tuple[bool, str]:
    from ballista_tpu_torch.analysis import budget, cachereg, stalelint

    problems = cachereg.verify_anchors()
    docs = cachereg.docs_in_sync()
    if docs:
        problems.append(docs)
    diags = stalelint.lint_paths()
    sup = stalelint.suppression_count()
    if problems or diags:
        return False, "\n".join(problems + [str(d) for d in diags])
    over = budget.check("stalelint", sup)
    if over:
        return False, over
    return True, (
        f"0 findings, {sup} suppressions, {len(cachereg.CACHES)} declared "
        f"caches / {len(cachereg.CONTRACTS)} invalidation contracts"
    )


def run_durlint() -> tuple[bool, str]:
    from ballista_tpu_torch.analysis import budget, durlint, durreg

    problems = durreg.verify_anchors()
    docs = durreg.docs_in_sync()
    if docs:
        problems.append(docs)
    diags = durlint.lint_paths()
    sup = durlint.suppression_count()
    if problems or diags:
        return False, "\n".join(problems + [str(d) for d in diags])
    over = budget.check("durlint", sup)
    if over:
        return False, over
    return True, (
        f"0 findings, {sup} suppressions, {len(durreg.STATE)} declared "
        f"state entries / {len(durreg.CONTRACTS)} persistence contracts"
    )


def _runners(queries, device: str = "cuda"):
    """Resolved at call time from module attributes, so tests can
    monkeypatch individual runners."""
    return {
        "planlint": lambda: run_planlint(queries, device),
        "serde-audit": lambda: run_serde_audit(device),
        "devlint": run_devlint,
        "racelint": run_racelint,
        "compile-vocab": lambda: run_compile_vocab(queries, device),
        "lifelint": run_lifelint,
        "proto-drift": run_proto_drift,
        "config-registry": run_config_registry,
        "eqlint": run_eqlint,
        "detlint": run_detlint,
        "stalelint": run_stalelint,
        "durlint": run_durlint,
    }


def run_all(
    skip=(), only=(), queries=None, out=print, parallel=True,
    as_json=False, device: str = "cuda",
) -> int:
    """Run the selected analyzers; returns the process exit code."""
    runners = _runners(queries, device)
    selected = [
        n
        for n in ANALYZERS
        if n not in skip and (not only or n in only)
    ]

    def run_one(name) -> dict:
        t0 = time.perf_counter()
        try:
            ok, summary = runners[name]()
        except Exception as e:  # noqa: BLE001 — an analyzer crash is a fail
            ok, summary = False, f"analyzer crashed: {type(e).__name__}: {e}"
        return {
            "name": name,
            "ok": ok,
            "summary": summary,
            "seconds": round(time.perf_counter() - t0, 3),
        }

    results: dict[str, dict] = {}
    if parallel and len(selected) > 1:
        from concurrent.futures import ThreadPoolExecutor

        corpus = [n for n in selected if n in _SHARED_CORPUS]
        singles = [n for n in selected if n not in _SHARED_CORPUS]
        groups: list[list[str]] = ([corpus] if corpus else []) + [
            [n] for n in singles
        ]

        def run_group(names: list[str]) -> list[dict]:
            return [run_one(n) for n in names]

        with ThreadPoolExecutor(
            max_workers=min(8, len(groups)), thread_name_prefix="analysis"
        ) as pool:
            for group_results in pool.map(run_group, groups):
                for r in group_results:
                    results[r["name"]] = r
    else:
        for name in selected:
            results[name] = run_one(name)

    failed = [n for n in ANALYZERS if n in results and not results[n]["ok"]]
    if as_json:
        from ballista_tpu_torch.analysis import budget

        try:
            suppressions = budget.ledger()
        except Exception as e:  # noqa: BLE001 — ledger breakage must not
            # mask the analyzer verdicts in CI output
            suppressions = {"error": f"{type(e).__name__}: {e}"}
        doc = {
            "ok": not failed,
            "failed": failed,
            "analyzers": [
                {**results[n]}
                if n in results
                else {"name": n, "skipped": True}
                for n in ANALYZERS
            ],
            "suppressions": suppressions,
        }
        out(json.dumps(doc, indent=2, sort_keys=True))
        return 1 if failed else 0
    for name in ANALYZERS:
        if name not in results:
            out(f"{name}: SKIPPED")
            continue
        r = results[name]
        out(f"{name}: {'OK' if r['ok'] else 'FAIL'} — {r['summary']}")
    if failed:
        out(f"FAILED: {', '.join(failed)}")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ballista_tpu_torch.analysis")
    ap.add_argument("--skip", default="", help="comma-separated analyzers")
    ap.add_argument("--only", default="", help="comma-separated analyzers")
    ap.add_argument(
        "--queries", default="",
        help="comma-separated TPC-H query numbers for planlint",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="machine-readable output (per-analyzer verdicts, timings, "
        "suppression ledger) for CI annotation",
    )
    ap.add_argument(
        "--serial", action="store_true",
        help="run analyzers one at a time instead of concurrently",
    )
    ap.add_argument(
        "--list", action="store_true",
        help="print the registered analyzer names (one per line) and "
        "exit (a test pins this matrix)",
    )
    ap.add_argument(
        "--dot", action="store_true",
        help="print the racelint lock-order graph (Graphviz) and exit",
    )
    ap.add_argument(
        "--tables", action="store_true",
        help="print the canonical status state machines and exit",
    )
    ap.add_argument(
        "--write-config-docs", action="store_true",
        help="regenerate ballista_tpu_torch/docs/config.md from the config "
        "registries and exit",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where the corpus analyzers' contexts hold their tables: "
        "cuda (default; raises without a card) or cpu",
    )
    args = ap.parse_args(argv)
    if args.list:
        for name in ANALYZERS:
            print(name)
        return 0
    if args.write_config_docs:
        from ballista_tpu_torch.analysis import configlint

        configlint.docs_path().write_text(configlint.render_config_docs())
        print(f"wrote {configlint.docs_path()}")
        return 0
    if args.dot:
        from ballista_tpu_torch.analysis import racelint

        print(racelint.lock_order_dot())
        return 0
    if args.tables:
        from ballista_tpu_torch.analysis.statemachine import render_tables

        print(render_tables())
        return 0
    skip = tuple(s for s in args.skip.split(",") if s)
    only = tuple(s for s in args.only.split(",") if s)
    queries = [int(q) for q in args.queries.split(",") if q] or None
    if args.device != "cpu":
        # no card, no gate: fail before any analyzer runs
        from ballista_tpu_torch.columnar.batch import resolve_device

        resolve_device(args.device)
    return run_all(
        skip=skip, only=only, queries=queries,
        parallel=not args.serial, as_json=args.json, device=args.device,
    )


if __name__ == "__main__":
    sys.exit(main())
