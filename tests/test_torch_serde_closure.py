"""Serde-closure audit of the port (``ballista_tpu_torch/analysis/serde_audit.py``),
the cases of ``tests/test_serde_closure.py``: every expression, logical
node and physical operator class of the port either round-trips
byte-stably through the port's codec or carries a written exemption, the
mesh operators among them, and a mesh node of the reference's wire
decodes to the port's operator."""

import pytest

from ballista_tpu.analysis import serde_audit as ref_audit
from ballista_tpu_torch.analysis.serde_audit import (
    EXEMPT_EXPR,
    EXEMPT_LOGICAL,
    EXEMPT_PHYSICAL,
    audit_expressions,
    audit_logical,
    audit_physical,
)


def test_expression_vocabulary_closed():
    r = audit_expressions()
    assert r.ok, r.summary()
    assert len(r.covered) >= 19, r.summary()


def test_logical_vocabulary_closed():
    r = audit_logical()
    assert r.ok, r.summary()
    assert len(r.covered) >= 14, r.summary()


def test_physical_vocabulary_closed():
    r = audit_physical()
    assert r.ok, r.summary()
    # the reference's covered classes, its mesh tier (4 classes) and the
    # shuffle plumbing among them
    assert set(r.covered) == set(ref_audit.audit_physical().covered), r.summary()
    assert len(r.covered) >= 25, r.summary()
    for cls in ("ShuffleWriterExec", "UnresolvedShuffleExec"):
        assert cls in r.covered, r.summary()


def test_exemplars_and_exemptions_are_the_references():
    assert EXEMPT_EXPR == ref_audit.EXEMPT_EXPR
    assert EXEMPT_LOGICAL == ref_audit.EXEMPT_LOGICAL
    assert EXEMPT_PHYSICAL == ref_audit.EXEMPT_PHYSICAL
    assert audit_expressions().covered == ref_audit.audit_expressions().covered
    assert audit_logical().covered == ref_audit.audit_logical().covered


def test_a_class_without_serde_is_missing():
    """A new operator class of the port with no wire form is reported by
    name (the closure is over the port's classes)."""
    from ballista_tpu_torch.exec.base import ExecutionPlan

    class SeededExec(ExecutionPlan):
        pass

    SeededExec.__module__ = "ballista_tpu_torch.exec.seeded"
    try:
        r = audit_physical()
        assert not r.ok and r.missing == ["SeededExec"], r.summary()
    finally:
        del SeededExec
        import gc

        gc.collect()


def test_exemptions_stay_justified():
    """Every exemption names a reason; the lists stay short — exemption is
    for classes that BY DESIGN never cross a process boundary."""
    for table in (EXEMPT_EXPR, EXEMPT_LOGICAL, EXEMPT_PHYSICAL):
        for cls, reason in table.items():
            assert len(reason) > 15, f"{cls}: justify the exemption"
    assert len(EXEMPT_PHYSICAL) <= 2
    assert len(EXEMPT_LOGICAL) == 0


def test_decoded_scan_reencodes():
    """Regression for an audit finding: a DECODED memory scan must be
    re-encodable (scheduler persistent-state reload re-encodes stage
    plans for dispatch); table_name must survive the round trip for
    file scans too."""
    import pyarrow as pa

    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.serde import BallistaCodec

    ctx = TorchContext(device="cpu")
    ctx.register_table("m", pa.table({"a": [1, 2]}))
    codec = BallistaCodec(provider=ctx)
    scan = ctx.scan("m", None, 2)
    scan.table_name = "m"
    enc = codec.physical_to_proto(scan).SerializeToString()
    back = codec.physical_from_proto(pb.PhysicalPlanNode.FromString(enc))
    assert back.table_name == "m"
    enc2 = codec.physical_to_proto(back).SerializeToString()
    assert enc2 == enc


def test_mesh_window_is_refused_by_name():
    """The reference's mesh-window case: a MeshWindowExec crosses the
    reference's wire, and the port decodes the node by name into its own
    MeshWindowExec, bound to the decoding side's mesh handle, which
    encodes to the same bytes (it was refused before the mesh tier was
    ported)."""
    import pyarrow as pa

    from ballista_tpu.exec.context import TpuContext
    from ballista_tpu.exec.mesh import MeshWindowExec
    from ballista_tpu.expr import logical as RL
    from ballista_tpu.serde import BallistaCodec as RefCodec
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.exec.mesh import MeshWindowExec as PortMeshWindowExec
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.serde import BallistaCodec

    ref = TpuContext()
    ref.register_table("m", pa.table({"a": [1, 2], "b": [0.5, 1.5]}))

    class _Handle:  # planning-only stand-in, as the scheduler uses
        pass

    scan = ref.scan("m", None, 1)
    scan.table_name = "m"
    plan = MeshWindowExec(
        scan,
        [RL.WindowFunction("row_number", (RL.col("a"),), ((RL.col("b"), False, None),))],
        ["rn"],
        _Handle(),
    )
    enc = RefCodec(provider=ref, mesh_runtime=_Handle()).physical_to_proto(plan).SerializeToString()
    ctx = TorchContext(device="cpu")
    ctx.register_table("m", pa.table({"a": [1, 2], "b": [0.5, 1.5]}))
    handle = _Handle()
    codec = BallistaCodec(provider=ctx, mesh_runtime=handle)
    back = codec.physical_from_proto(pb.PhysicalPlanNode.FromString(enc))
    assert isinstance(back, PortMeshWindowExec) and back.runtime is handle
    assert back.display() == plan.display()
    assert codec.physical_to_proto(back).SerializeToString() == enc


@pytest.mark.parametrize("domain", ["expr", "logical", "physical"])
def test_audit_reports_render(domain):
    r = {
        "expr": audit_expressions,
        "logical": audit_logical,
        "physical": audit_physical,
    }[domain]()
    s = r.summary()
    assert domain in s and "round-tripped" in s
