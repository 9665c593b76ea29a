"""Runtime witnesses copied from ``ballista_tpu/analysis``: the lock-order
witness (``witness.make_lock``), the resource witness (``reswitness``) and
the replay witness of committed shuffle partitions (``replay``). The
reference's static lints and plan verifier are not ported (ROADMAP queue
1, item 10b)."""
