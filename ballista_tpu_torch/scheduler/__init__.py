"""The scheduler (port of ``ballista_tpu/scheduler``): the gRPC method
registry of the scheduler and executor services (``rpc``), the
``SchedulerServer`` with its stage state machine, event loop, push- and
pull-staged task handout, shuffle-location publishing and executor-loss
recovery (``server``), the task, stage and executor bookkeeping
(``stage_manager``, ``executor_manager``), the state backends and their
restart recovery (``state_backend``: memory and sqlite, ``etcd_backend``,
``persistent_state``), the result cache (``result_cache``), the REST API
(``rest``), the KEDA external scaler (``external_scaler``) and adaptive
query execution (``aqe``: the policy over the certified rewrites of
``ballista_tpu_torch/rewrite.py``). ``python -m
ballista_tpu_torch.scheduler`` runs it as a process; it plans and never
runs an operator, so it needs no card.
"""
