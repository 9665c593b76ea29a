"""The executor's observability (port of ``ballista_tpu/obs``): task and
fetch spans shipped home on the poll (``trace``), the executor's latency
histograms and their deltas (``hist``), per-operator metrics
(``profile``) and the task attempt's cost vector (``history``). The
reference's Prometheus exposition, query classes and history store come
with the scheduler (ROADMAP queue 1, item 9d)."""
