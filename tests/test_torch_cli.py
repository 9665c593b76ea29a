"""The shell (``cli.py``) and the stage diagram (``utils.py``) of the port
against the reference's, on the CPU: the six cases of
``tests/test_cli.py`` and ``tests/test_plugin_and_utils.py``'s
``test_produce_diagram``.

Each script runs through both packages' ``main(argv)`` in this process
(the port's with ``--device cpu``), and the two outputs must be equal
line for line once each "Query took N seconds" is masked: tables,
backslash commands, print formats, errors and quiet mode. One case runs
``python -m ballista_tpu_torch.cli`` as a process, and one runs the port's
shell against a port cluster (``--host``/``--port``). The Graphviz text of
q3's stage DAG (TPC-H at SF=0.002) is the reference's, byte for byte.
"""

from __future__ import annotations

import io
import json
import re
import subprocess
import sys

import pyarrow as pa
import pytest

from ballista_tpu import cli as ref_cli
from ballista_tpu_torch import cli

TOOK = re.compile(r"Query took \d+\.\d+ seconds")


def _main(pkg, argv: list[str], stdin: str, monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    if pkg is cli:
        argv = [*argv, "--device", "cpu"]
    assert pkg.main(argv) == 0
    return TOOK.sub("Query took N seconds", capsys.readouterr().out)


def both(argv: list[str], stdin: str, monkeypatch, capsys) -> str:
    got = _main(cli, argv, stdin, monkeypatch, capsys)
    want = _main(ref_cli, argv, stdin, monkeypatch, capsys)
    assert got == want
    return got


def _ddl(path, cols: str = "a bigint") -> str:
    return f"create external table t ({cols}) stored as csv with header row location '{path}';\n"


def test_cli_script_local(tmp_path, monkeypatch, capsys):
    csv = tmp_path / "t.csv"
    csv.write_text("a,b\n1,x\n2,y\n3,x\n")
    out = both([], _ddl(csv, "a bigint, b varchar")
               + "select b, count(*) as n from t group by b order by b;\n"
               "\\d\n\\d t\n\\h\n\\h substr\n\\q\n", monkeypatch, capsys)
    assert "x" in out and "y" in out
    assert "table_name" in out and "column_name" in out
    assert "substr" in out and "row(s) in set" in out


def test_cli_print_formats(tmp_path, monkeypatch, capsys):
    csv = tmp_path / "t.csv"
    csv.write_text("a\n1\n2\n")
    out = both(["-q"], _ddl(csv) + "\\pset format csv\nselect * from t order by a;\n", monkeypatch, capsys)
    assert "a\n1\n2" in out.replace('"', "")
    out = both(["-q"], _ddl(csv) + "\\pset format json\nselect * from t order by a;\n", monkeypatch, capsys)
    assert json.loads([ln for ln in out.splitlines() if ln.startswith("[")][0]) == [{"a": 1}, {"a": 2}]
    out = both(["-q"], _ddl(csv) + "\\pset format ndjson\nselect * from t order by a;\n", monkeypatch, capsys)
    assert [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")] == [{"a": 1}, {"a": 2}]
    out = both(["-q", "--format", "tsv"], _ddl(csv) + "\\pset format nope\n\\pset\nselect * from t;\n",
               monkeypatch, capsys)
    assert "invalid format 'nope'" in out and "format is tsv" in out


def test_cli_file_mode(tmp_path, monkeypatch, capsys):
    csv = tmp_path / "t.csv"
    csv.write_text("a\n5\n7\n")
    script = tmp_path / "q.sql"
    script.write_text(_ddl(csv) + "select sum(a) as s from t;\n")
    out = both(["-f", str(script)], "", monkeypatch, capsys)
    assert "12" in out


def test_cli_quiet_and_errors(monkeypatch, capsys):
    out = both(["-q"], "select * from nosuch;\n\\nope\n\\quiet\n\\q\n", monkeypatch, capsys)
    assert "error:" in out and "row(s) in set" not in out
    assert "unknown command \\nope" in out and "quiet is on" in out


def test_cli_multiline_statement(tmp_path, monkeypatch, capsys):
    csv = tmp_path / "t.csv"
    csv.write_text("a\n1\n2\n3\n")
    out = both(["-q"], _ddl(csv) + "select\n  sum(a) as s\nfrom t\nwhere a > 1;\n", monkeypatch, capsys)
    assert "5" in out


@pytest.mark.parametrize("fmt", cli.PRINT_FORMATS)
def test_format_batch_unit(fmt):
    t = pa.table({"x": pa.array([1, 2]), "s": pa.array(["a", "b"]), "f": pa.array([0.5, None])})
    assert cli.format_batch(t, fmt) == ref_cli.format_batch(t, fmt)
    empty = pa.table({"x": pa.array([], type=pa.int64())})
    assert cli.format_batch(empty, fmt) == ref_cli.format_batch(empty, fmt)
    assert cli.format_batch(empty, "table") == "(empty)"
    assert cli.list_functions() == ref_cli.list_functions()


def test_cli_process_and_its_device(tmp_path, monkeypatch, capsys):
    """``python -m ballista_tpu_torch.cli --device cpu`` prints what
    ``main`` prints; without ``--device`` and without a card it exits
    non-zero before it reads a statement."""
    from tests.conftest import CPU_MESH_ENV

    csv = tmp_path / "t.csv"
    csv.write_text("a\n5\n7\n")
    script = _ddl(csv) + "select sum(a) as s from t;\n\\d\n"
    proc = subprocess.run(
        [sys.executable, "-m", "ballista_tpu_torch.cli", "--device", "cpu"],
        input=script, env=CPU_MESH_ENV, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert TOOK.sub("Query took N seconds", proc.stdout) == _main(cli, [], script, monkeypatch, capsys)
    import torch

    if not torch.cuda.is_available():
        proc = subprocess.run(
            [sys.executable, "-m", "ballista_tpu_torch.cli"],
            input=script, env=CPU_MESH_ENV, capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr
        assert "row(s) in set" not in proc.stdout


def test_cli_remote_mode_matches_local(tmp_path, monkeypatch, capsys):
    """``--host``/``--port``: the port's shell as a client of a port
    cluster prints what the local shell prints."""
    from ballista_tpu_torch.client.context import BallistaContext

    csv = tmp_path / "t.csv"
    csv.write_text("a,b\n1,x\n2,y\n3,x\n")
    script = (_ddl(csv, "a bigint, b varchar")
              + "select b, count(*) as n, sum(a) as s from t group by b order by b;\n\\d\n\\d t\n")
    cluster = BallistaContext.standalone(device="cpu")
    try:
        port = cluster._standalone_cluster.scheduler_port
        remote = _main(cli, ["--host", "localhost", "--port", str(port)], script, monkeypatch, capsys)
    finally:
        cluster.close()
    assert remote == _main(cli, [], script, monkeypatch, capsys)
    assert "2 row(s) in set" in remote


def test_produce_diagram():
    """The reference's diagram case, then q3's stage DAG from both
    packages' stage splitters: the same dot text."""
    from ballista_tpu.distributed_plan import DistributedPlanner as RefDistributedPlanner
    from ballista_tpu.exec.context import TpuContext
    from ballista_tpu.exec.planner import PhysicalPlanner as RefPlanner
    from ballista_tpu.plan.optimizer import optimize as ref_optimize
    from ballista_tpu.utils import produce_diagram as ref_produce_diagram
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.datatypes import DataType, Field, Schema
    from ballista_tpu_torch.distributed_plan import DistributedPlanner, UnresolvedShuffleExec
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.exec.pipeline import CoalescePartitionsExec
    from ballista_tpu_torch.exec.planner import PhysicalPlanner
    from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec
    from ballista_tpu_torch.plan.optimizer import optimize
    from ballista_tpu_torch.tpch import gen_all
    from ballista_tpu_torch.utils import produce_diagram, write_diagram
    from test_torch_stages import query_sql

    schema = Schema([Field("a", DataType.INT64)])
    s1 = ShuffleWriterExec("job", 1, CoalescePartitionsExec(UnresolvedShuffleExec(1, schema, 2, 2)), [], 1)
    s2 = ShuffleWriterExec("job", 2, CoalescePartitionsExec(UnresolvedShuffleExec(1, schema, 2, 2)), [], 1)
    dot = produce_diagram([s1, s2])
    assert dot.startswith("digraph G {") and dot.endswith("}")
    assert "cluster1" in dot and "cluster2" in dot and 'label = "Stage 1"' in dot
    assert "UnresolvedShuffleExec stage=1" in dot and "[style=dashed]" in dot

    data = gen_all(0.002, 42)
    ref, port = TpuContext(), TorchContext(device="cpu")
    for name, t in data.items():
        ref.register_table(name, t)
        port.register_table(name, t)
    sql = query_sql("q3", data)
    stages = DistributedPlanner().plan_query_stages(
        "job", PhysicalPlanner(port, 4, config=BallistaConfig(), distributed=True).plan(optimize(port.sql_to_logical(sql)))
    )
    ref_stages = RefDistributedPlanner().plan_query_stages(
        "job", RefPlanner(ref, 4, config=ref.config, distributed=True).plan(ref_optimize(ref.sql_to_logical(sql)))
    )
    assert len(stages) == len(ref_stages) > 2
    got = produce_diagram([s.plan for s in stages])
    assert got == ref_produce_diagram([s.plan for s in ref_stages])
    assert got.count("[style=dashed]") >= 2
    import tempfile

    with tempfile.NamedTemporaryFile("r", suffix=".dot") as f:
        write_diagram(f.name, [s.plan for s in stages])
        assert f.read() == got
