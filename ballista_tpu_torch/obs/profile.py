"""Per-operator runtime profiling: the EXPLAIN ANALYZE substrate.

:func:`instrument_plan` walks a physical plan tree and wraps every
operator's ``execute`` (as an instance attribute shadowing the class
method — parents call ``child.execute(...)``, so the wrapper sees every
batch) to meter, per operator:

- ``output_rows`` — valid rows produced. Recorded as LAZY device scalars
  (``batch.valid.sum()``): nothing syncs on the hot path, and
  :func:`operator_metrics` resolves every device counter of the plan with
  one device-to-host copy at report time (``resolve_device_counters``).
- ``output_batches`` / ``output_bytes`` — batch count and the device
  residency of what was produced (capacity x dtype widths, host
  arithmetic — no sync).
- ``elapsed`` (timer) — wall seconds spent INSIDE this operator's
  iterator, i.e. cumulative over the operator and its inputs (the Spark
  UI convention; subtracting a child's elapsed gives self time).

The same counters feed two consumers: ``EXPLAIN ANALYZE`` renders
:func:`annotated_display`, and the executor's ShippingMetricsCollector
serializes :func:`operator_metrics` into ``CompletedTask`` so that a
scheduler aggregates them per (job, stage, partition)
(``metrics_from_proto``, which the scheduler decodes them with).
"""

from __future__ import annotations

import time

from ballista_tpu_torch.datatypes import DataType

# device-resident width per column dtype (bytes/row at capacity) — host
# arithmetic only, mirroring columnar/batch.py's storage choices
_DTYPE_BYTES = {
    DataType.BOOL: 1,
    DataType.INT32: 4,
    DataType.INT64: 8,
    DataType.FLOAT32: 4,
    DataType.FLOAT64: 8,
    DataType.DATE32: 4,
    DataType.TIMESTAMP_US: 8,
    DataType.STRING: 4,  # dictionary codes
}


def batch_nbytes(batch) -> int:
    """Approximate device bytes of one DeviceBatch (capacity-padded), from
    schema dtypes — no device sync."""
    cap = int(batch.valid.shape[0]) if batch.valid is not None else 0
    per_row = sum(_DTYPE_BYTES.get(f.dtype, 8) for f in batch.schema)
    return cap * (per_row + 1)  # +1 for the valid mask


def instrument_plan(plan) -> None:
    """Wrap every node's ``execute`` with the metering shim (idempotent:
    re-instrumenting an already-wrapped node is a no-op, so cached plan
    instances survive repeated EXPLAIN ANALYZE runs)."""

    def wrap(node) -> None:
        if getattr(node, "_obs_metered", False):
            return
        orig = node.execute

        def metered(partition, ctx, _orig=orig, _node=node):
            m = _node.metrics
            it = iter(_orig(partition, ctx))
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        m.timers["elapsed"] = m.timers.get("elapsed", 0.0) + (
                            time.perf_counter() - t0
                        )
                        break
                    m.timers["elapsed"] = m.timers.get("elapsed", 0.0) + (
                        time.perf_counter() - t0
                    )
                    m.add("output_batches")
                    if batch.valid is not None:
                        # lazy device scalar; operator_metrics resolves it
                        m.add("output_rows", batch.valid.sum())
                        m.add("output_bytes", batch_nbytes(batch))
                    yield batch
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()

        node.execute = metered
        node._obs_metered = True
        for c in node.children():
            wrap(c)

    wrap(plan)


def reset_plan_metrics(plan) -> None:
    """Clear every node's counters/timers. Called at the top of each task
    ATTEMPT (run_with_capacity_retry re-invokes its fn on CapacityError/
    SpeculationMiss with the same plan instance): without the reset, the
    shipped metrics would sum the aborted partial attempt into the final
    one — inflated rows/bytes/elapsed poisoning exactly the stats
    substrate AQE re-plans from."""
    for _path, node in walk_paths(plan):
        node.metrics.reset()


def walk_paths(plan):
    """Yield ``(path, node)`` in display (pre-)order; path is the
    dot-joined child-index chain ("0", "0.0", "0.1", ...) — a stable
    operator identity across serialization (proto carries no object
    ids)."""

    def rec(node, path):
        yield path, node
        for i, c in enumerate(node.children()):
            yield from rec(c, f"{path}.{i}")

    yield from rec(plan, "0")


def resolve_device_counters(plan) -> int:
    """Replace every device-scalar counter of the plan tree by its host
    int, all of them with one stacked device-to-host copy (one wait for
    the whole task, not one a counter). Returns the counters resolved."""
    import torch

    cells = [
        (node.metrics.counters, k)
        for _path, node in walk_paths(plan)
        for k, v in node.metrics.counters.items()
        if isinstance(v, torch.Tensor)
    ]
    if not cells:
        return 0
    vals = torch.stack([c[k].reshape(()).to(torch.int64) for c, k in cells]).tolist()
    for (c, k), v in zip(cells, vals):
        c[k] = int(v)
    return len(cells)


def operator_metrics(plan) -> list[dict]:
    """Per-operator metric records for one executed plan tree — the
    payload the ShippingMetricsCollector sends home. Device-scalar
    counters resolve here, all with one copy (``resolve_device_counters``)."""
    resolve_device_counters(plan)
    out = []
    for path, node in walk_paths(plan):
        out.append(
            {
                "path": path,
                "operator": type(node).__name__,
                "describe": node.describe(),
                "counters": node.metrics.summary(),
            }
        )
    return out


# ---------------------------------------------------------------------------
# wire conversion (OperatorMetricP)
# ---------------------------------------------------------------------------


def metrics_to_proto(records: list[dict]):
    from ballista_tpu_torch.proto import pb

    out = []
    for r in records:
        out.append(
            pb.OperatorMetricP(
                path=r["path"],
                operator=r["operator"],
                describe=r.get("describe", ""),
                counters=[
                    pb.KeyValuePair(key=k, value=repr(v))
                    for k, v in sorted(r["counters"].items())
                ],
            )
        )
    return out


def _num(s: str):
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            return 0


def metrics_from_proto(protos) -> list[dict]:
    return [
        {
            "path": p.path,
            "operator": p.operator,
            "describe": p.describe,
            "counters": {kv.key: _num(kv.value) for kv in p.counters},
        }
        for p in protos
    ]


def annotated_display(plan) -> str:
    """The physical plan's display with each operator's measured rows,
    bytes and elapsed seconds (the EXPLAIN ANALYZE body)."""
    resolve_device_counters(plan)
    lines = []
    for path, node in walk_paths(plan):
        counters = dict(node.metrics.summary())
        rows = counters.pop("output_rows", None)
        nbytes = counters.pop("output_bytes", None)
        elapsed = counters.pop("elapsed", None)
        parts = []
        if rows is not None:
            parts.append(f"rows={int(rows)}")
        if nbytes is not None:
            parts.append(f"bytes={int(nbytes)}")
        if elapsed is not None:
            parts.append(f"elapsed={float(elapsed):.6f}s")
        parts += [f"{k}={v}" for k, v in sorted(counters.items())]
        line = "  " * path.count(".") + node.describe()
        if parts:
            line += "  [" + ", ".join(parts) + "]"
        lines.append(line)
    return "\n".join(lines)
