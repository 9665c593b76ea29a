"""UDF plugin: drop a .py file in a plugin dir, use it from SQL.

The port of the reference's ``examples/udf_plugin.py`` (the analogue of
Ballista's plugin manager, ref core/src/plugin/mod.rs:36-127, which
dlopens .so files): a plugin is a Python module with
``register(register_udf)``, and its bodies are torch functions of the
batch's columns on the batch's device.

Run:  python -m ballista_tpu_torch.examples.udf_plugin [--device cpu] [--rows N]
"""

from __future__ import annotations

import os
import tempfile
import textwrap

import numpy as np
import pyarrow as pa

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.examples import parse_args, show
from ballista_tpu_torch.exec.context import TorchContext

ROWS = 1000
SQL = (
    "SELECT COUNT(*) AS n, AVG(relu(x)) AS avg_relu_x, "
    "AVG(squared_distance(x, y)) AS mean_sq_dist FROM points"
)
PLUGIN = textwrap.dedent(
    """
    import torch
    from ballista_tpu_torch.datatypes import DataType

    def register(register_udf):
        register_udf(
            "relu", lambda x: torch.clamp(x, min=0.0),
            DataType.FLOAT64,
        )
        register_udf(
            "squared_distance", lambda a, b: (a - b) * (a - b),
            DataType.FLOAT64, min_args=2, max_args=2,
        )
    """
)


def make_data(rows: int = ROWS) -> pa.Table:
    """The points table, as the reference makes it."""
    rng = np.random.default_rng(3)
    return pa.table(
        {
            "x": pa.array(rng.normal(0, 2, rows)),
            "y": pa.array(rng.normal(1, 2, rows)),
        }
    )


def run(rows: int = ROWS, device: str = "cuda"):
    with tempfile.TemporaryDirectory(prefix="ballista-plugins-") as plugin_dir:
        with open(os.path.join(plugin_dir, "my_math.py"), "w") as f:
            f.write(PLUGIN)

        ctx = TorchContext(
            BallistaConfig().with_setting("ballista.plugin_dir", plugin_dir),
            device=device,
        )
        ctx.register_table("points", make_data(rows))
        return ctx.sql(SQL).collect()


def main(argv=None) -> None:
    args = parse_args(argv, __doc__, ROWS)
    show(run(args.rows, args.device))


if __name__ == "__main__":
    main()
