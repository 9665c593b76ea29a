"""Plan/stage visualization helpers (port of ``ballista_tpu/utils.py``).

ref ballista/rust/core/src/utils.rs:105-220 — ``produce_diagram`` writes a
Graphviz dot file with one cluster per query stage and edges from each
stage's UnresolvedShuffleExec leaves to the producing stage's writer node.
"""

from __future__ import annotations

from ballista_tpu_torch.distributed_plan import UnresolvedShuffleExec
from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec


def _node_label(plan) -> str:
    name = type(plan).__name__
    extra = ""
    if isinstance(plan, ShuffleWriterExec):
        keys = ", ".join(str(k) for k in plan.partition_keys)
        extra = (
            f" hash[{keys}] x{plan.output_partitions}"
            if plan.partition_keys
            else f" x{plan.output_partitions}"
        )
    elif isinstance(plan, UnresolvedShuffleExec):
        extra = f" stage={plan.stage_id}"
    return name + extra


def produce_diagram(stages: list[ShuffleWriterExec]) -> str:
    """Render a stage DAG as Graphviz dot text (ref utils.rs:105-142; the
    reference writes to a file — see :func:`write_diagram`)."""
    lines = ["digraph G {"]
    # stage-local operator trees (one cluster per stage, ref :111-123)
    node_ids: dict[tuple[int, int], str] = {}  # (stage, seq) -> dot id
    readers: list[tuple[str, int]] = []  # (dot id, producing stage)
    writers: dict[int, str] = {}  # stage -> writer dot id

    for stage in stages:
        sid = stage.stage_id
        lines.append(f"\tsubgraph cluster{sid} {{")
        lines.append(f'\t\tlabel = "Stage {sid}";')
        counter = [0]

        def draw(plan, parent_id: str | None, sid=sid, counter=counter):
            nid = f"stage_{sid}_{counter[0]}"
            counter[0] += 1
            lines.append(f'\t\t{nid} [shape=box, label="{_node_label(plan)}"];')
            if parent_id is not None:
                lines.append(f"\t\t{nid} -> {parent_id};")
            if isinstance(plan, ShuffleWriterExec):
                writers[sid] = nid
            if isinstance(plan, UnresolvedShuffleExec):
                readers.append((nid, plan.stage_id))
            for child in plan.children():
                draw(child, nid)

        draw(stage, None)
        lines.append("\t}")

    # cross-stage edges: producing stage's writer -> consuming reader leaf
    # (ref :125-137 second pass)
    for reader_id, produced_by in readers:
        w = writers.get(produced_by)
        if w is not None:
            lines.append(f"\t{w} -> {reader_id} [style=dashed];")
    lines.append("}")
    return "\n".join(lines)


def write_diagram(filename: str, stages: list[ShuffleWriterExec]) -> None:
    """File-writing variant matching the reference signature (utils.rs:105)."""
    with open(filename, "w") as f:
        f.write(produce_diagram(stages))
