"""Wire-drift gate of the port (``ballista_tpu_torch/analysis/protodrift.py``),
the cases of ``tests/test_proto_drift.py``: the repo's proto TEXT
(``proto/*.proto``) against the port's generated DESCRIPTOR
(``ballista_tpu_torch/proto/*_pb2.py``) and the committed field-number
ledger (``proto/field_numbers.json``), both packages speaking one wire.
Every parse, diff and ledger check also runs through the reference's
protodrift and must give the same result."""

import copy
import dataclasses
import json
import textwrap

from ballista_tpu.analysis import protodrift as ref_protodrift
from ballista_tpu_torch.analysis import protodrift as port_protodrift
from ballista_tpu_torch.proto import ballista_tpu_pb2, etcd_pb2

# the functions whose result must be the reference's on the same input
_HELD = ("parse_proto_text", "diff_models", "check_ledger", "run", "generate_ledger")


def _plain(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


class _HeldAgainstReference:
    """The port's protodrift; the functions of ``_HELD`` also run through
    the reference's on the same arguments and must agree."""

    def __getattr__(self, name):
        fn = getattr(port_protodrift, name)
        if name not in _HELD:
            return fn

        def held(*args, **kw):
            got = fn(*copy.deepcopy(args), **copy.deepcopy(kw))
            want = getattr(ref_protodrift, name)(*args, **kw)
            assert _plain(got) == _plain(want), name
            return got

        return held


protodrift = _HeldAgainstReference()


def test_reads_the_repos_proto_and_the_ports_descriptor():
    assert port_protodrift.ledger_path() == ref_protodrift.ledger_path()
    pairs = port_protodrift._pairs()
    assert [path for path, _ in pairs] == [path for path, _ in ref_protodrift._pairs()]
    assert [mod.__name__ for _, mod in pairs] == [
        "ballista_tpu_torch.proto.ballista_tpu_pb2", "ballista_tpu_torch.proto.etcd_pb2",
    ]


def _ledger():
    return json.loads(protodrift.ledger_path().read_text())


# ------------------------------------------------------------ tier-1 gate --


def test_proto_text_descriptor_and_ledger_in_sync():
    ok, msg = protodrift.run()
    assert ok, msg


def test_ledger_file_matches_generated_content():
    """The committed ledger must be exactly what the descriptor implies
    plus (possibly) retired entries — i.e. regenerating adds nothing."""
    committed = _ledger()
    generated = protodrift.generate_ledger()
    for pkg, msgs in generated.items():
        assert pkg in committed, pkg
        for msg, fields in msgs.items():
            if msg == "__retired__":
                continue
            assert committed[pkg].get(msg) == fields, msg


def test_known_wire_surface_is_covered():
    """Spot anchors: the descriptor model sees the hand-made descriptor-
    mutated additions, so the diff genuinely covers them."""
    desc = protodrift.descriptor_model(ballista_tpu_pb2)
    assert "PhysicalMeshWindowNode" in desc.messages  # a mutation
    assert "ShuffleLocationsResult" in desc.messages  # a mutation
    assert desc.messages["ShuffleReaderExecNode"]["eager"][0] == 5
    assert "metrics" in desc.messages["PollWorkParams"]  # a mutation
    assert "GetShuffleLocations" in desc.services["SchedulerGrpc"]
    # etcd streams carry their streaming flags
    e = protodrift.descriptor_model(etcd_pb2)
    assert e.services["Watch"]["Watch"][2:] == (True, True)


# ------------------------------------------------------- text-side drift --

_MINI = textwrap.dedent(
    """
    syntax = "proto3";
    package mini;
    enum Kind {
      K_A = 0;
      K_B = 1;
    }
    message Inner {
      string tag = 1;
    }
    message Outer {
      message Nested { bool on = 1; }
      repeated Inner items = 1;
      Kind kind = 2;
      oneof which {
        int64 num = 3;
        string name = 4;
      }
      map<string, string> attrs = 5;
    }
    service Svc {
      rpc Get (Inner) returns (stream Outer) {}
    }
    """
)


def test_text_parser_covers_the_grammar():
    m = protodrift.parse_proto_text(_MINI)
    assert m.package == "mini"
    assert m.messages["Outer"]["items"] == (1, True, "Inner")
    assert m.messages["Outer"]["kind"] == (2, False, "Kind")
    assert m.messages["Outer"]["num"] == (3, False, "int64")  # oneof
    assert m.messages["Outer"]["attrs"] == (
        5, False, "map<string,string>"
    )
    assert m.messages["Outer.Nested"]["on"] == (1, False, "bool")
    assert m.enums["Kind"] == {"K_A": 0, "K_B": 1}
    assert m.services["Svc"]["Get"] == ("Inner", "Outer", False, True)


def test_diff_detects_each_drift_class():
    base = protodrift.parse_proto_text(_MINI)

    def mutated(fn):
        m = copy.deepcopy(base)
        fn(m)
        return protodrift.diff_models(base, m)

    # field renumber
    d = mutated(lambda m: m.messages["Outer"].update(
        items=(9, True, "Inner")
    ))
    assert any("NUMBER drift" in p for p in d), d
    # type change
    d = mutated(lambda m: m.messages["Inner"].update(
        tag=(1, False, "bytes")
    ))
    assert any("type drift" in p for p in d), d
    # repeated flip
    d = mutated(lambda m: m.messages["Outer"].update(
        items=(1, False, "Inner")
    ))
    assert any("repeated-label drift" in p for p in d), d
    # removed field
    d = mutated(lambda m: m.messages["Inner"].pop("tag"))
    assert any("in proto text only" in p for p in d), d
    # added message
    d = mutated(lambda m: m.messages.update(Ghost={}))
    assert any("NOT in proto text" in p for p in d), d
    # enum value drift
    d = mutated(lambda m: m.enums["Kind"].update(K_B=7))
    assert any("enum Kind" in p for p in d), d
    # rpc signature drift (streaming flag)
    d = mutated(lambda m: m.services["Svc"].update(
        Get=("Inner", "Outer", False, False)
    ))
    assert any("signature drift" in p for p in d), d
    # no drift -> no findings
    assert protodrift.diff_models(base, copy.deepcopy(base)) == []


# --------------------------------------------------------- ledger rules --


def test_ledger_rejects_renumber_rename_remove_and_reuse():
    good = protodrift.generate_ledger()

    def run_with(mut):
        led = copy.deepcopy(good)
        mut(led)
        ok, msg = protodrift.run(ledger=led)
        return ok, msg

    ok, msg = run_with(lambda led: None)
    assert ok, msg

    ok, msg = run_with(
        lambda led: led["ballista_tpu"]["FieldP"].update(name=42)
    )
    assert not ok and "RENUMBERED" in msg

    # descriptor field absent from the ledger = unappended new field
    ok, msg = run_with(
        lambda led: led["ballista_tpu"]["FieldP"].pop("dtype")
    )
    assert not ok and "not in the ledger" in msg

    # ledger field absent from the descriptor = silent removal
    ok, msg = run_with(
        lambda led: led["ballista_tpu"]["FieldP"].update(ghost_field=7)
    )
    assert not ok and "gone from the descriptor" in msg

    # retired number reused by a live field of another name
    ok, msg = run_with(
        lambda led: led["ballista_tpu"].update(
            __retired__={"FieldP": {"old_name": 1}}
        )
    )
    assert not ok and "REUSES retired number" in msg

    # whole message missing from the ledger
    ok, msg = run_with(lambda led: led["ballista_tpu"].pop("SchemaP"))
    assert not ok and "missing from the field-number ledger" in msg
