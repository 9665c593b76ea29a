"""Observability (port of ``ballista_tpu/obs``): task and fetch spans
shipped home on the poll (``trace``), the latency histograms, their
deltas and the scheduler's merge of them (``hist``), per-operator metrics
(``profile``), the task attempt's cost vector and the scheduler's history
store (``history``), query-class fingerprints (``qclass``), and the
Prometheus exposition of the scheduler and executor (``prometheus``). ``trace`` is
re-exported, imported at its first access."""

from ballista_tpu_torch import _lazy

__getattr__ = _lazy(__name__, {}, submodules=("trace",))
