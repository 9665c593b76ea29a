"""Observability (port of ``ballista_tpu/obs``): task and fetch spans
shipped home on the poll (``trace``), the latency histograms, their
deltas and the scheduler's merge of them (``hist``), per-operator metrics
(``profile``), the task attempt's cost vector and the scheduler's history
store (``history``), and query-class fingerprints (``qclass``). The
Prometheus exposition is ROADMAP queue 1, item 9e."""
