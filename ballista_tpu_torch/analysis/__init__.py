"""Analysis copied from ``ballista_tpu/analysis``: the plan verifier
(``verifier``: ``verify_logical``, ``verify_physical``, ``verify_stages``,
wired into the scheduler's submission path, the context and the executor
behind ``ballista.tpu.verify_plans``), the declared task, stage and job
transition tables (``statemachine``), the runtime witnesses: lock order
(``witness.make_lock``), resources (``reswitness``), replay of committed
shuffle partitions (``replay``), result-cache staleness (``stalewitness``)
and scheduler durability across a restart (``durwitness``), and the static
gate, ``python -m ballista_tpu_torch.analysis`` (``__main__``): eleven
analyzers over the port's tree with one exit code and one suppression
ledger (``budget``):

- ``planlint`` (the verifier over the TPC-H corpus) and ``compile-vocab``
  (``compilecache/registry``'s device-program closure);
- ``serde-audit`` (``serde_audit``), ``proto-drift`` (``protodrift``) and
  ``config-registry`` (``configlint`` over ``config.ENV_REGISTRY``): the
  closure of the wire and of the configuration;
- ``racelint``, ``lifelint`` and ``detlint``: concurrency, lifecycle and
  determinism;
- ``eqlint``: every structural plan write inside ``rewrite.py``;
- ``stalelint`` over the cache registry ``cachereg`` and ``durlint`` over
  the state registry ``durreg``: staleness and durability.

The reference's ``jaxlint`` has no counterpart: the port's device-program
and host-sync lint ``devlint`` takes its slot.
"""

from ballista_tpu_torch.errors import PlanVerificationError  # noqa: F401
from ballista_tpu_torch.analysis.verifier import (  # noqa: F401
    VerifyReport,
    sql_span,
    verify_logical,
    verify_physical,
    verify_stages,
)
