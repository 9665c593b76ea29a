"""The reference's four examples (``examples/*.py``), run on the port:
``python -m ballista_tpu_torch.examples.<name> [--device cpu] [--rows N]``.

- :mod:`standalone_sql` — a CSV through an in-process cluster, configured
  with ``BallistaConfig.builder().with_setting(...)``;
- :mod:`remote_sql` — a client connected by address to a running
  scheduler;
- :mod:`dataframe` — the DataFrame builder, without SQL;
- :mod:`udf_plugin` — a UDF plugin file whose bodies are torch.

Each keeps the reference script's data, seed, query and printed table, and
has ``make_data(rows)`` (the rows it registers), ``run(rows, device)``
(the result as an Arrow table) and ``main(argv=None)``. ``--device``
defaults to ``cuda`` (without a card the example raises); ``--rows``
defaults to the reference's count.
"""

from __future__ import annotations

import argparse
import csv


def parse_args(argv, doc: str, rows: int) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--rows", type=int, default=rows, help=f"rows of data (default {rows})")
    return p.parse_args(argv)


def write_csv(path: str, header: list[str], rows: list[tuple]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def show(table) -> None:
    """Print ``table`` as ``DataFrame.show()`` does."""
    print(table.slice(0, 20).to_pandas().to_string(index=False))
