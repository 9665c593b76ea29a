"""Plan IR: logical plan nodes and the optimizer (a copy of the
reference's ``ballista_tpu.plan``)."""
