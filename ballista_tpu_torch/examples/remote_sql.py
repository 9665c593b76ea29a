"""Remote-cluster SQL: connect a client to a running scheduler.

The port of the reference's ``examples/remote_sql.py``: start a scheduler
and an executor (here in process, so that the example stands alone; in a
deployment ``python -m ballista_tpu_torch.scheduler`` and ``python -m
ballista_tpu_torch.executor`` on their own hosts), then connect by address,
register a file-backed table, and run SQL over gRPC with the results
fetched over Arrow Flight.

Run:  python -m ballista_tpu_torch.examples.remote_sql [--device cpu] [--rows N]
"""

from __future__ import annotations

import os
import random
import tempfile

from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.examples import parse_args, show, write_csv
from ballista_tpu_torch.standalone import StandaloneCluster

ROWS = 1000
SQL = (
    "SELECT customer, COUNT(*) AS n, SUM(total) AS spent "
    "FROM orders GROUP BY customer ORDER BY spent DESC LIMIT 5"
)


def make_data(rows: int = ROWS) -> list[tuple[int, float]]:
    """The CSV's rows, (customer, total), as the reference writes them."""
    rng = random.Random(1)
    return [(rng.randrange(50), round(rng.uniform(5, 500), 2)) for _ in range(rows)]


def run(rows: int = ROWS, device: str = "cuda"):
    # stands in for the scheduler and executor processes
    cluster = StandaloneCluster.start(device=device)
    try:
        with tempfile.TemporaryDirectory(prefix="ballista-example-") as tmp:
            # a CSV both "hosts" can see (shared storage in a deployment)
            path = os.path.join(tmp, "orders.csv")
            write_csv(path, ["customer", "total"], make_data(rows))

            # the remote client: what would run on another machine
            ctx = BallistaContext.remote("localhost", cluster.scheduler_port, device=device)
            try:
                ctx.sql(
                    f"CREATE EXTERNAL TABLE orders STORED AS CSV "
                    f"WITH HEADER ROW LOCATION '{path}'"
                )
                return ctx.sql(SQL).collect()
            finally:
                ctx.close()
    finally:
        cluster.stop()


def main(argv=None) -> None:
    args = parse_args(argv, __doc__, ROWS)
    show(run(args.rows, args.device))


if __name__ == "__main__":
    main()
