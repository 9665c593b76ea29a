"""DataFrame-builder API: compose queries without SQL.

The port of the reference's ``examples/dataframe.py`` (the analogue of
Ballista's ``read_csv().filter().aggregate()`` chains, ref
python/src/dataframe.rs:55-137): the same logical plans the SQL front end
produces, built in code.

Run:  python -m ballista_tpu_torch.examples.dataframe [--device cpu] [--rows N]
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from ballista_tpu_torch import functions as F
from ballista_tpu_torch.examples import parse_args, show
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.expr import col, lit

ROWS = 10_000


def make_data(rows: int = ROWS) -> pa.Table:
    """The trips table, as the reference makes it."""
    rng = np.random.default_rng(2)
    return pa.table(
        {
            "vendor": pa.array(rng.integers(1, 4, rows)),
            "passengers": pa.array(rng.integers(1, 6, rows)),
            "fare": pa.array(np.round(rng.uniform(3, 80, rows), 2)),
        }
    )


def run(rows: int = ROWS, device: str = "cuda"):
    ctx = TorchContext(device=device)
    ctx.register_table("trips", make_data(rows))

    df = (
        ctx.table("trips")
        .filter(col("passengers") > lit(1))
        .aggregate(
            [col("vendor")],
            [
                F.count_star().alias("trips"),
                F.sum("fare").alias("revenue"),
                F.avg("fare").alias("avg_fare"),
            ],
        )
        .sort(col("vendor"))
    )
    return df.collect()


def main(argv=None) -> None:
    args = parse_args(argv, __doc__, ROWS)
    show(run(args.rows, args.device))


if __name__ == "__main__":
    main()
