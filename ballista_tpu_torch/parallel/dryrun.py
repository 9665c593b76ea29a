"""Mesh dry run: the distributed stage pipeline on an N-shard mesh, held
against a numpy oracle (port of ``ballista_tpu/parallel/dryrun.py``).

``python -m ballista_tpu_torch.parallel.dryrun N [--device cpu]`` runs a
fact-and-dimension join with a grouped aggregate on a mesh of N shards
(``BALLISTA_TPU_MESH_SHARDS`` set to N for the run) through
``TorchContext`` and asserts that the plan routes through
``MeshJoinExec`` and ``MeshAggregateExec``. It then runs the same query
through a standalone cluster whose executor advertises N devices, and
asserts the mesh operators in the scheduler's stage plans and in the
operators the executor reports having run. It runs on the card unless
asked for the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np


@contextlib.contextmanager
def _shards(n: int):
    old = os.environ.get("BALLISTA_TPU_MESH_SHARDS")
    os.environ["BALLISTA_TPU_MESH_SHARDS"] = str(n)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("BALLISTA_TPU_MESH_SHARDS", None)
        else:
            os.environ["BALLISTA_TPU_MESH_SHARDS"] = old


def _check(out, want) -> None:
    np.testing.assert_array_equal(out.grp.to_numpy(), want.grp.to_numpy())
    np.testing.assert_allclose(out.s.to_numpy(), want["sum"].to_numpy(), rtol=1e-9)
    np.testing.assert_array_equal(out.c.to_numpy(), want["count"].to_numpy())


def run(n_devices: int, device: str = "cuda") -> None:
    import pyarrow as pa

    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.exec.context import TorchContext

    rng = np.random.default_rng(7)
    n, n_dim = 20_000, 230
    fact = pa.table(
        {
            "k": pa.array(rng.integers(0, n_dim + 20, n)),  # some misses
            "v": pa.array(rng.uniform(0, 10, n)),
        }
    )
    dim = pa.table(
        {
            "id": pa.array(np.arange(n_dim, dtype=np.int64)),
            "grp": pa.array((np.arange(n_dim) % 13).astype(np.int64)),
        }
    )
    sql = (
        "SELECT grp, SUM(v) AS s, COUNT(*) AS c FROM fact "
        "JOIN dim ON k = id GROUP BY grp ORDER BY grp"
    )
    df = fact.to_pandas().merge(dim.to_pandas(), left_on="k", right_on="id")
    want = (
        df.groupby("grp").v.agg(["sum", "count"]).reset_index()
        .sort_values("grp").reset_index(drop=True)
    )
    with _shards(n_devices):
        ctx = TorchContext(device=device)
        rt = ctx.mesh_runtime()
        assert rt is not None and rt.mesh.n_dev == n_devices, (
            "the mesh runtime must be active for the dry run"
        )
        ctx.register_table("fact", fact)
        ctx.register_table("dim", dim)
        # the plan must route through the mesh operators, not the serial
        # coalesce funnel
        disp = ctx.create_physical_plan(ctx.sql_to_logical(sql)).display()
        assert "MeshJoinExec" in disp and "MeshAggregateExec" in disp, disp
        _check(ctx.sql(sql).collect().to_pandas(), want)

        # the scheduler path: the executor advertises N devices, the
        # scheduler plans a fused mesh stage chain, the stage plan crosses
        # serde and the executor runs it over its own mesh
        dctx = BallistaContext.standalone(device=device)
        try:
            sched = dctx._standalone_cluster.scheduler
            deadline = time.time() + 30
            specs = []
            while time.time() < deadline:
                specs = [em.specification for em in sched.executor_manager.all_executors()]
                if any((s.n_devices or 1) >= n_devices for s in specs):
                    break
                time.sleep(0.1)
            else:
                raise AssertionError(f"executor never advertised {n_devices} devices: {specs}")
            dctx.register_table("fact", fact)
            dctx.register_table("dim", dim)
            _check(dctx.sql(sql).collect().to_pandas(), want)
            stage_disp = "\n".join(
                stage.plan.display()
                for job in sched.jobs.values()
                for stage in job.stages.values()
            )
            ran = {
                r["operator"]
                for job in sched.jobs.values()
                for records in job.op_metrics.values()
                for r in records
            }
            for op in ("MeshJoinExec", "MeshAggregateExec"):
                assert op in stage_disp, f"{op} missing from the stage plans:\n{stage_disp}"
                assert op in ran, f"the executor ran no {op}: {sorted(ran)}"
        finally:
            dctx.close()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8, help="shard count (default 8)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    run(args.n, args.device)
    # the closed device-program vocabulary, the mesh tier's programs among
    # them: a program added without registering it fails the dry run too
    from ballista_tpu_torch.compilecache import registry

    problems = registry.check_vocabulary()
    for p in problems:
        print(f"  VOCABULARY {p}")
    if problems:
        raise SystemExit(f"{len(problems)} device-program vocabulary findings (see above)")
    print(f"compile-vocab: {len(registry.PROGRAMS)} device programs registered, report closed")
    print(f"dryrun ok on {args.n} shards of {args.device}")


if __name__ == "__main__":
    main()
