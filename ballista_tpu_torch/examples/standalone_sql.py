"""Standalone-cluster SQL: scheduler and executor in one process.

The port of the reference's ``examples/standalone_sql.py`` (the analogue
of Ballista's examples/standalone-sql.rs): boot an in-process cluster (a
gRPC control plane and a Flight data plane), register a CSV, run SQL,
print the result.

Run:  python -m ballista_tpu_torch.examples.standalone_sql [--device cpu] [--rows N]
"""

from __future__ import annotations

import os
import random
import tempfile

from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.examples import parse_args, show, write_csv

ROWS = 100
SQL = (
    "SELECT region, COUNT(1) AS n, SUM(amount) AS total "
    "FROM test GROUP BY region ORDER BY region"
)


def make_data(rows: int = ROWS) -> list[tuple[str, float]]:
    """The CSV's rows, (region, amount), as the reference writes them."""
    rng = random.Random(0)
    return [
        (rng.choice(["east", "west", "north"]), round(rng.uniform(1, 100), 2))
        for _ in range(rows)
    ]


def run(rows: int = ROWS, device: str = "cuda"):
    with tempfile.TemporaryDirectory(prefix="ballista-example-") as tmp:
        # a small CSV on disk, like the reference's testdata file
        path = os.path.join(tmp, "sales.csv")
        write_csv(path, ["region", "amount"], make_data(rows))

        config = (
            BallistaConfig.builder()
            .with_setting("ballista.shuffle.partitions", "1")
        )
        ctx = BallistaContext.standalone(config=config, device=device)
        try:
            ctx.sql(
                f"CREATE EXTERNAL TABLE test STORED AS CSV "
                f"WITH HEADER ROW LOCATION '{path}'"
            ).collect()
            return ctx.sql(SQL).collect()
        finally:
            ctx.close()


def main(argv=None) -> None:
    args = parse_args(argv, __doc__, ROWS)
    show(run(args.rows, args.device))


if __name__ == "__main__":
    main()
