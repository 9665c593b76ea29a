"""The port's four examples (``ballista_tpu_torch/examples/``) against the
reference's (``examples/``) on the CPU.

Each reference script runs in a subprocess as ``tests/test_examples.py``
runs it, beside ``python -m ballista_tpu_torch.examples.<name> --device
cpu``: both exit 0 and print the same rows (keys and counts exactly,
floats to rtol 1e-9 once parsed). Then each example runs in this process
at 50,000 rows and its result is held against a numpy oracle over its
``make_data``.
"""

from __future__ import annotations

import importlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import CPU_MESH_ENV

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ["dataframe", "remote_sql", "standalone_sql", "udf_plugin"]
RTOL = 1e-9


def parse_rows(text: str) -> tuple[list[str], list[list]]:
    """``DataFrame.show()``'s text as (header, rows), each cell an int, a
    float or a string."""

    def cell(s: str):
        for kind in (int, float):
            try:
                return kind(s)
            except ValueError:
                pass
        return s

    lines = [ln.split() for ln in text.strip().splitlines()]
    return lines[0], [[cell(c) for c in ln] for ln in lines[1:]]


def assert_same_rows(got: tuple, want: tuple) -> None:
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1]) > 0
    for g_row, w_row in zip(got[1], want[1]):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=RTOL, abs=0), (got, want)
            else:
                assert g == w and type(g) is type(w), (got, want)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_the_reference_rows(name):
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / f"{name}.py")],
            env=dict(CPU_MESH_ENV), cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ),
        "port": subprocess.Popen(
            [sys.executable, "-m", f"ballista_tpu_torch.examples.{name}", "--device", "cpu"],
            env=dict(CPU_MESH_ENV), cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ),
    }
    out = {}
    for side, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{side} {name} failed:\n{stdout}\n{stderr[-3000:]}"
        out[side] = parse_rows(stdout)
    assert_same_rows(out["port"], out["reference"])


def _columns(table) -> dict:
    return {c: table.column(c).to_numpy() for c in table.column_names}


def oracle_standalone_sql(rows: list) -> dict:
    region = np.array([r[0] for r in rows])
    amount = np.array([r[1] for r in rows])
    keys = sorted(set(region.tolist()))
    return {
        "region": np.array(keys),
        "n": np.array([(region == k).sum() for k in keys]),
        "total": np.array([amount[region == k].sum() for k in keys]),
    }


def oracle_remote_sql(rows: list) -> dict:
    customer = np.array([r[0] for r in rows])
    total = np.array([r[1] for r in rows])
    keys = np.unique(customer)
    spent = np.array([total[customer == k].sum() for k in keys])
    top = np.argsort(-spent, kind="stable")[:5]
    return {
        "customer": keys[top],
        "n": np.array([(customer == k).sum() for k in keys[top]]),
        "spent": spent[top],
    }


def oracle_dataframe(table) -> dict:
    c = _columns(table)
    keep = c["passengers"] > 1
    vendor, fare = c["vendor"][keep], c["fare"][keep]
    keys = np.unique(vendor)
    return {
        "vendor": keys,
        "trips": np.array([(vendor == k).sum() for k in keys]),
        "revenue": np.array([fare[vendor == k].sum() for k in keys]),
        "avg_fare": np.array([fare[vendor == k].mean() for k in keys]),
    }


def oracle_udf_plugin(table) -> dict:
    c = _columns(table)
    x, y = c["x"], c["y"]
    return {
        "n": np.array([len(x)]),
        "avg_relu_x": np.array([np.maximum(x, 0.0).mean()]),
        "mean_sq_dist": np.array([((x - y) * (x - y)).mean()]),
    }


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_against_numpy_oracle(name):
    mod = importlib.import_module(f"ballista_tpu_torch.examples.{name}")
    rows = 50_000
    got = _columns(mod.run(rows, device="cpu"))
    want = globals()[f"oracle_{name}"](mod.make_data(rows))
    assert list(got) == list(want)
    for col, w in want.items():
        g = got[col]
        assert len(g) == len(w), col
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=col)
        else:
            assert g.tolist() == w.tolist(), col
