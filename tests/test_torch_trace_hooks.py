"""The trace hooks of the port against the reference: with
``ballista.tpu.trace`` on, EXPLAIN ANALYZE records an ``explain_analyze``
span (a fresh trace id, the statement's first 200 characters), and under
it every spill set that wrote bytes records a ``spill_pass`` event
(``buckets``, ``bytes``, ``rows``) and every callable-cache miss a
``trace_cache_miss`` event. On a budgeted q3 the span and event names and
their attribute keys equal the reference's, and each pass's buckets and
rows are exact. A JSONL path gets the same spans. The spill managers'
resource-witness tokens balance (acquired at a manager's start, released
at its close)."""

import json
import pathlib

import pytest
import torch

from ballista_tpu.compilecache import tracecache as ref_tracecache
from ballista_tpu.config import BallistaConfig as RefConfig
from ballista_tpu.exec.context import TpuContext
from ballista_tpu.obs import trace as ref_trace
from ballista_tpu_torch.analysis import reswitness
from ballista_tpu_torch.compilecache import tracecache
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.exec.base import plan_counters
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.obs import trace
from ballista_tpu_torch.tpch import gen_all

QDIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "queries"
# the smallest scale at which q3 spills under a 1 MB budget
# (tests/test_torch_out_of_core.py)
SCALE = 0.006
BUDGET = {"ballista.tpu.hbm_budget_mb": "1", "ballista.shuffle.partitions": "1"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the budgeted runs (see
    tests/test_torch_out_of_core.py: the spill passes' many small ops run
    tens of times slower when every worker's pool oversubscribes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tables():
    return gen_all(SCALE, 42)


@pytest.fixture
def tracing_off():
    yield
    trace.configure("off")
    ref_trace.configure("off")


def _spans(snapshot, trace_id):
    return [s for s in snapshot if s.trace_id == trace_id]


def _analyze(ctx, sql, mod, clear):
    clear()
    before = {s.span_id for s in mod.snapshot()}
    ctx.sql("EXPLAIN ANALYZE " + sql).collect()
    new = [s for s in mod.snapshot() if s.span_id not in before]
    root = [s for s in new if s.name == "explain_analyze"]
    assert len(root) == 1, [s.name for s in new]
    return root[0], _spans(new, root[0].trace_id)


def test_budgeted_q3_spans_match_the_reference(tables, tracing_off):
    sql = (QDIR / "q3.sql").read_text()
    settings = {**BUDGET, "ballista.tpu.trace": "on"}
    ref = TpuContext(RefConfig(settings))
    port = TorchContext(BallistaConfig(settings), device="cpu")
    for name, t in tables.items():
        ref.register_table(name, t)
        port.register_table(name, t)
    ref_root, ref_spans = _analyze(ref, sql, ref_trace, ref_tracecache.clear)
    root, spans = _analyze(port, sql, trace, tracecache.clear)
    assert root.attrs == {"sql": ("EXPLAIN ANALYZE " + sql)[:200]} == ref_root.attrs
    assert root.parent_id == "" and root.trace_id != ref_root.trace_id

    def shape(ss):
        return {s.name: sorted(s.attrs) for s in ss}

    assert shape(spans) == shape(ref_spans)
    assert set(shape(spans)) == {"explain_analyze", "spill_pass", "trace_cache_miss"}
    assert all(s.parent_id == root.span_id for s in spans if s is not root)

    def passes(ss):
        return sorted((s.attrs["buckets"], s.attrs["rows"]) for s in ss if s.name == "spill_pass")

    assert passes(spans) == passes(ref_spans)
    assert len(passes(spans)) >= 2
    assert all(s.attrs["bytes"] > 0 for s in spans if s.name == "spill_pass")


def test_trace_path_gets_the_spans_as_jsonl(tables, tmp_path, tracing_off):
    path = tmp_path / "trace.jsonl"
    sql = (QDIR / "q3.sql").read_text()
    port = TorchContext(BallistaConfig({**BUDGET, "ballista.tpu.trace": str(path)}), device="cpu")
    for name, t in tables.items():
        port.register_table(name, t)
    port.sql("EXPLAIN ANALYZE " + sql).collect()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    root = [ln for ln in lines if ln["name"] == "explain_analyze"]
    assert len(root) == 1 and root[0]["attrs"] == {"sql": ("EXPLAIN ANALYZE " + sql)[:200]}
    passes = [ln for ln in lines if ln["name"] == "spill_pass"]
    assert passes and all(int(p["attrs"]["bytes"]) > 0 for p in passes)
    assert all(ln["trace_id"] == root[0]["trace_id"] for ln in lines)


def test_trace_off_records_nothing(tables, tracing_off):
    port = TorchContext(BallistaConfig(BUDGET), device="cpu")
    for name, t in tables.items():
        port.register_table(name, t)
    before = trace.ring_size()
    port.sql("EXPLAIN ANALYZE " + (QDIR / "q3.sql").read_text()).collect()
    assert trace.ring_size() == before


def test_spill_witness_tokens_balance(tables):
    """Every spill manager of a budgeted q3 (one per task attempt that
    spilled) registers with the resource witness and releases at its
    close: nothing is live after the run."""
    reswitness.reset()
    reswitness.enable(True)
    try:
        port = TorchContext(BallistaConfig(BUDGET), device="cpu")
        for name, t in tables.items():
            port.register_table(name, t)
        _, plan = port.sql((QDIR / "q3.sql").read_text()).collect_with_plan()
        assert plan_counters(plan, ("spill_passes",))["spill_passes"] >= 2
        assert reswitness.acquired_counts().get("spill-manager", 0) >= 1
        assert [e for e in reswitness.live() if e["kind"] == "spill-manager"] == []
        reswitness.assert_drained()
    finally:
        reswitness.enable(False)
        reswitness.reset()
