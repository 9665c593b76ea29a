"""Analysis copied from ``ballista_tpu/analysis``: the plan verifier
(``verifier``: ``verify_logical``, ``verify_physical``, ``verify_stages``,
wired into the scheduler's submission path, the context and the executor
behind ``ballista.tpu.verify_plans``), the declared task, stage and job
transition tables (``statemachine``), and the runtime witnesses: lock
order (``witness.make_lock``), resources (``reswitness``), replay of
committed shuffle partitions (``replay``) and result-cache staleness
(``stalewitness``). The reference's static lints are not ported (ROADMAP
queue 1, item 10b).
"""

from ballista_tpu_torch.errors import PlanVerificationError  # noqa: F401
from ballista_tpu_torch.analysis.verifier import (  # noqa: F401
    VerifyReport,
    sql_span,
    verify_logical,
    verify_physical,
    verify_stages,
)
