"""protodrift: wire-schema drift detection for protoc-less proto edits
(the port's copy of ``ballista_tpu/analysis/protodrift.py``).

Wire changes are made by mutating the serialized ``FileDescriptorProto``
inside the generated ``*_pb2.py`` and editing ``proto/*.proto`` **by hand,
in parallel**. The port's descriptors (``ballista_tpu_torch/proto/``) are
copies of the reference's, and both packages speak the one wire that the
mixed-fleet tests rely on, so the port is held to the repo's proto text and
field ledger, which it reads and never writes. protodrift proves the two
views of the wire format agree:

- **text↔descriptor diff** — ``proto/ballista_tpu.proto`` (and
  ``etcd.proto``) is parsed with a minimal proto3 grammar and compared
  against the LIVE descriptor pool of the generated module: message set,
  per-field name/number/label/type, enum values, and service RPC
  signatures (incl. streaming flags) must all agree. The descriptor is
  what actually crosses the wire; the text is what humans review — drift
  between them is a silent protocol fork.
- **field-number ledger** — ``proto/field_numbers.json`` commits every
  ``(message, field) -> number`` assignment ever made. Numbers are the
  real wire contract (names never cross it): the ledger forbids
  *renumbering* an existing field, *reusing* a retired number for a new
  field, and *removing* a field without retiring its number into the
  ledger's ``__retired__`` section. A new field must be appended to the
  ledger in the same commit — which is exactly the reviewable artifact a
  protoc setup would have produced.

Run via ``python -m ballista_tpu_torch.analysis`` (analyzer name
``proto-drift``) or :func:`run` directly; ``generate_ledger()`` emits the
current descriptor's ledger for bootstrap / intentional updates.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re

# descriptor FieldDescriptor.type -> proto text scalar name
_SCALAR_TYPES = {
    1: "double", 2: "float", 3: "int64", 4: "uint64", 5: "int32",
    6: "fixed64", 7: "fixed32", 8: "bool", 9: "string", 12: "bytes",
    13: "uint32", 15: "sfixed32", 16: "sfixed64", 17: "sint32",
    18: "sint64",
}
_TYPE_MESSAGE = 11
_TYPE_ENUM = 14
_LABEL_REPEATED = 3


@dataclasses.dataclass
class ProtoModel:
    """One file's wire surface, from either the text or the descriptor."""

    package: str = ""
    # message fq-name (dot-nested, package-relative) ->
    #   field name -> (number, repeated, type-terminal-name)
    messages: dict[str, dict[str, tuple[int, bool, str]]] = (
        dataclasses.field(default_factory=dict)
    )
    # enum name -> {value name -> number}
    enums: dict[str, dict[str, int]] = dataclasses.field(
        default_factory=dict
    )
    # service name -> {rpc name -> (in, out, in_stream, out_stream)}
    services: dict[str, dict[str, tuple[str, str, bool, bool]]] = (
        dataclasses.field(default_factory=dict)
    )


# --------------------------------------------------------------------------
# proto3 text parser (the subset these files use)
# --------------------------------------------------------------------------

_FIELD_RE = re.compile(
    r"^(repeated\s+|optional\s+)?"
    r"(map\s*<\s*[\w.]+\s*,\s*[\w.]+\s*>|[\w.]+)\s+"
    r"(\w+)\s*=\s*(\d+)\s*(?:\[[^\]]*\])?\s*;$"
)
_ENUM_VAL_RE = re.compile(r"^(\w+)\s*=\s*(\d+)\s*;$")
_RPC_RE = re.compile(
    r"^rpc\s+(\w+)\s*\(\s*(stream\s+)?([\w.]+)\s*\)\s*"
    r"returns\s*\(\s*(stream\s+)?([\w.]+)\s*\)\s*(?:\{\s*\})?;?$"
)


def _strip_comments(text: str) -> str:
    text = re.sub(r"//[^\n]*", "", text)
    return re.sub(r"/\*.*?\*/", "", text, flags=re.S)


def _norm_type(t: str) -> str:
    """Package-insensitive terminal type name ('.ballista_tpu_torch.ExprNode' ->
    'ExprNode'); map types canonicalized without spaces."""
    t = t.strip()
    m = re.match(r"map\s*<\s*([\w.]+)\s*,\s*([\w.]+)\s*>", t)
    if m:
        return f"map<{_norm_type(m.group(1))},{_norm_type(m.group(2))}>"
    return t.split(".")[-1]


def _split_statements(body: str):
    """Yield (statement, block) at one brace depth: 'message Foo' with its
    braced body, or a plain ';'-terminated statement with block None."""
    i, n = 0, len(body)
    while i < n:
        ch = body[i]
        if ch in " \t\r\n":
            i += 1
            continue
        j = i
        depth = 0
        while j < n:
            c = body[j]
            if c == "{":
                if depth == 0:
                    head = body[i:j].strip()
                    depth = 1
                    k = j + 1
                    while k < n and depth:
                        if body[k] == "{":
                            depth += 1
                        elif body[k] == "}":
                            depth -= 1
                        k += 1
                    yield head, body[j + 1:k - 1]
                    i = k
                    break
            elif c == ";" and depth == 0:
                yield body[i:j + 1].strip(), None
                i = j + 1
                break
            j += 1
        else:
            leftover = body[i:].strip()
            if leftover:
                yield leftover, None
            return


def parse_proto_text(text: str) -> ProtoModel:
    model = ProtoModel()
    text = _strip_comments(text)
    for head, block in _split_statements(text):
        if head.startswith("package"):
            model.package = head.split()[1].rstrip(";")
        elif head.startswith("message "):
            _parse_message(head.split()[1], block or "", "", model)
        elif head.startswith("enum "):
            model.enums[head.split()[1]] = _parse_enum(block or "")
        elif head.startswith("service "):
            model.services[head.split()[1]] = _parse_service(block or "")
        # syntax / option / import: irrelevant to the wire surface here
    return model


def _parse_message(
    name: str, block: str, prefix: str, model: ProtoModel
) -> None:
    fq = f"{prefix}.{name}" if prefix else name
    fields: dict[str, tuple[int, bool, str]] = {}
    for head, sub in _split_statements(block):
        if head.startswith("message "):
            _parse_message(head.split()[1], sub or "", fq, model)
        elif head.startswith("enum "):
            model.enums[head.split()[1]] = _parse_enum(sub or "")
        elif head.startswith("oneof "):
            for oh, _os in _split_statements(sub or ""):
                m = _FIELD_RE.match(oh)
                if m:
                    fields[m.group(3)] = (
                        int(m.group(4)),
                        bool(m.group(1) and "repeated" in m.group(1)),
                        _norm_type(m.group(2)),
                    )
        elif head.startswith(("option ", "reserved ")):
            continue
        else:
            m = _FIELD_RE.match(head)
            if m:
                fields[m.group(3)] = (
                    int(m.group(4)),
                    bool(m.group(1) and "repeated" in m.group(1)),
                    _norm_type(m.group(2)),
                )
    model.messages[fq] = fields


def _parse_enum(block: str) -> dict[str, int]:
    out: dict[str, int] = {}
    for head, _sub in _split_statements(block):
        if head.startswith(("option ", "reserved ")):
            continue
        m = _ENUM_VAL_RE.match(head)
        if m:
            out[m.group(1)] = int(m.group(2))
    return out


def _parse_service(block: str) -> dict[str, tuple[str, str, bool, bool]]:
    out: dict[str, tuple[str, str, bool, bool]] = {}
    for head, sub in _split_statements(block):
        src = head if sub is None else f"{head} {{}}"
        m = _RPC_RE.match(re.sub(r"\s+", " ", src).strip())
        if m:
            out[m.group(1)] = (
                _norm_type(m.group(3)),
                _norm_type(m.group(5)),
                bool(m.group(2)),
                bool(m.group(4)),
            )
    return out


# --------------------------------------------------------------------------
# descriptor side
# --------------------------------------------------------------------------


def _is_repeated(fd) -> bool:
    rep = getattr(fd, "is_repeated", None)
    if rep is not None:  # modern spelling (label is deprecated); this is
        return bool(rep() if callable(rep) else rep)  # a property here
    return fd.label == _LABEL_REPEATED


def _field_type_name(fd) -> str:
    if fd.type == _TYPE_MESSAGE:
        mt = fd.message_type
        if mt.GetOptions().map_entry:
            return (
                f"map<{_field_type_name(mt.fields_by_name['key'])},"
                f"{_field_type_name(mt.fields_by_name['value'])}>"
            )
        return mt.name
    if fd.type == _TYPE_ENUM:
        return fd.enum_type.name
    return _SCALAR_TYPES.get(fd.type, f"type#{fd.type}")


def _walk_message(md, prefix: str, model: ProtoModel) -> None:
    fq = f"{prefix}.{md.name}" if prefix else md.name
    fields: dict[str, tuple[int, bool, str]] = {}
    for fd in md.fields:
        is_map = (
            fd.type == _TYPE_MESSAGE
            and fd.message_type.GetOptions().map_entry
        )
        fields[fd.name] = (
            fd.number,
            _is_repeated(fd) and not is_map,
            _field_type_name(fd),
        )
    model.messages[fq] = fields
    for nested in md.nested_types:
        if nested.GetOptions().map_entry:
            continue  # synthesized map entry, shown as map<> on the field
        _walk_message(nested, fq, model)
    for en in md.enum_types:
        model.enums[en.name] = {v.name: v.number for v in en.values}


def descriptor_model(pb2_module) -> ProtoModel:
    model = ProtoModel()
    fd = pb2_module.DESCRIPTOR
    model.package = fd.package
    for md in fd.message_types_by_name.values():
        _walk_message(md, "", model)
    for en in fd.enum_types_by_name.values():
        model.enums[en.name] = {v.name: v.number for v in en.values}
    for svc in fd.services_by_name.values():
        model.services[svc.name] = {
            m.name: (
                m.input_type.name,
                m.output_type.name,
                bool(m.client_streaming),
                bool(m.server_streaming),
            )
            for m in svc.methods
        }
    return model


# --------------------------------------------------------------------------
# diff + ledger
# --------------------------------------------------------------------------


def diff_models(text: ProtoModel, desc: ProtoModel) -> list[str]:
    """Human-readable drift between the .proto TEXT and the generated
    DESCRIPTOR (empty == in sync)."""
    out: list[str] = []
    if text.package != desc.package:
        out.append(
            f"package drift: text {text.package!r} vs descriptor "
            f"{desc.package!r}"
        )
    for name in sorted(set(text.messages) - set(desc.messages)):
        out.append(f"message {name}: in proto text but NOT in descriptor")
    for name in sorted(set(desc.messages) - set(text.messages)):
        out.append(f"message {name}: in descriptor but NOT in proto text")
    for name in sorted(set(text.messages) & set(desc.messages)):
        tf, df = text.messages[name], desc.messages[name]
        for f in sorted(set(tf) - set(df)):
            out.append(f"{name}.{f}: in proto text only")
        for f in sorted(set(df) - set(tf)):
            out.append(f"{name}.{f}: in descriptor only")
        for f in sorted(set(tf) & set(df)):
            tnum, trep, ttyp = tf[f]
            dnum, drep, dtyp = df[f]
            if tnum != dnum:
                out.append(
                    f"{name}.{f}: field NUMBER drift (text ={tnum}, "
                    f"descriptor ={dnum})"
                )
            if trep != drep:
                out.append(
                    f"{name}.{f}: repeated-label drift (text "
                    f"{'repeated' if trep else 'singular'}, descriptor "
                    f"{'repeated' if drep else 'singular'})"
                )
            if ttyp != dtyp:
                out.append(
                    f"{name}.{f}: type drift (text {ttyp}, descriptor "
                    f"{dtyp})"
                )
    for name in sorted(set(text.enums) ^ set(desc.enums)):
        side = "text" if name in text.enums else "descriptor"
        out.append(f"enum {name}: only in {side}")
    for name in sorted(set(text.enums) & set(desc.enums)):
        if text.enums[name] != desc.enums[name]:
            out.append(
                f"enum {name}: value drift (text {text.enums[name]} vs "
                f"descriptor {desc.enums[name]})"
            )
    for name in sorted(set(text.services) ^ set(desc.services)):
        side = "text" if name in text.services else "descriptor"
        out.append(f"service {name}: only in {side}")
    for name in sorted(set(text.services) & set(desc.services)):
        ts, ds = text.services[name], desc.services[name]
        for rpc in sorted(set(ts) ^ set(ds)):
            side = "text" if rpc in ts else "descriptor"
            out.append(f"service {name}.{rpc}: only in {side}")
        for rpc in sorted(set(ts) & set(ds)):
            if ts[rpc] != ds[rpc]:
                out.append(
                    f"service {name}.{rpc}: signature drift (text "
                    f"{ts[rpc]} vs descriptor {ds[rpc]})"
                )
    return out


def check_ledger(desc: ProtoModel, ledger: dict) -> list[str]:
    """Enforce the committed field-number ledger against the live
    descriptor: no renumber, no silent remove, no reuse of retired
    numbers, every new field appended."""
    out: list[str] = []
    pkg = ledger.get(desc.package)
    if pkg is None:
        return [f"ledger has no package section {desc.package!r}"]
    retired: dict[str, dict[str, int]] = pkg.get("__retired__", {})
    for msg, fields in sorted(desc.messages.items()):
        lfields = pkg.get(msg)
        if lfields is None:
            out.append(
                f"message {msg} missing from the field-number ledger — "
                "append it (analysis.protodrift.generate_ledger())"
            )
            continue
        for fname, (num, _rep, _typ) in sorted(fields.items()):
            lnum = lfields.get(fname)
            if lnum is None:
                out.append(
                    f"{msg}.{fname} (= {num}) not in the ledger — new "
                    "fields must be appended to proto/field_numbers.json "
                    "in the same commit"
                )
            elif int(lnum) != num:
                out.append(
                    f"{msg}.{fname}: RENUMBERED (ledger ={lnum}, "
                    f"descriptor ={num}) — field numbers are the wire "
                    "contract and may never change"
                )
            rnum = retired.get(msg, {}).get(fname)
            if rnum is not None:
                out.append(
                    f"{msg}.{fname}: name is retired in the ledger but "
                    "live in the descriptor"
                )
        for fname, lnum in sorted(lfields.items()):
            if fname in fields:
                continue
            out.append(
                f"{msg}.{fname} (= {lnum}) is in the ledger but gone "
                "from the descriptor — removed fields must move to "
                '"__retired__" (their number may never be reused)'
            )
        for fname, rnum in sorted(retired.get(msg, {}).items()):
            for live_name, (num, _r, _t) in fields.items():
                if num == int(rnum) and live_name != fname:
                    out.append(
                        f"{msg}.{live_name}: REUSES retired number "
                        f"{rnum} (was {fname}) — old peers would decode "
                        "it as the retired field"
                    )
    for msg in sorted(set(pkg) - {"__retired__"} - set(desc.messages)):
        out.append(
            f"ledger message {msg} is gone from the descriptor — move "
            'its fields to "__retired__"'
        )
    return out


def generate_ledger(pb2_modules=None) -> dict:
    """The CURRENT descriptor's ledger content (bootstrap / intentional
    update after review)."""
    out: dict = {}
    for _path, mod in _pairs(pb2_modules):
        desc = descriptor_model(mod)
        out[desc.package] = {
            msg: {f: num for f, (num, _r, _t) in sorted(fields.items())}
            for msg, fields in sorted(desc.messages.items())
        }
        out[desc.package]["__retired__"] = {}
    return out


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def _repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2]


def ledger_path() -> pathlib.Path:
    return _repo_root() / "proto" / "field_numbers.json"


def _pairs(pb2_modules=None):
    if pb2_modules is not None:
        return pb2_modules
    from ballista_tpu_torch.proto import ballista_tpu_pb2, etcd_pb2

    return [
        (_repo_root() / "proto" / "ballista_tpu.proto", ballista_tpu_pb2),
        (_repo_root() / "proto" / "etcd.proto", etcd_pb2),
    ]


def run(pb2_modules=None, ledger: dict | None = None) -> tuple[bool, str]:
    """Text↔descriptor diff + ledger check over every proto pair.
    Returns (ok, summary/problem report)."""
    problems: list[str] = []
    stats: list[str] = []
    if ledger is None:
        lp = ledger_path()
        if lp.exists():
            ledger = json.loads(lp.read_text())
        else:
            problems.append(
                f"missing {lp} — bootstrap with generate_ledger()"
            )
            ledger = {}
    for path, mod in _pairs(pb2_modules):
        text_model = parse_proto_text(pathlib.Path(path).read_text())
        desc_model = descriptor_model(mod)
        d = diff_models(text_model, desc_model)
        problems += [f"{pathlib.Path(path).name}: {p}" for p in d]
        problems += [
            f"{pathlib.Path(path).name}: {p}"
            for p in check_ledger(desc_model, ledger)
        ]
        stats.append(
            f"{pathlib.Path(path).name} ({len(desc_model.messages)} msgs, "
            f"{sum(len(f) for f in desc_model.messages.values())} fields)"
        )
    if problems:
        return False, "\n".join(problems)
    return True, "in sync: " + ", ".join(stats)
