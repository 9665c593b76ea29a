"""The executor (port of ``ballista_tpu/executor``): the task runner with
its poll loop and push server (``executor.py``, ``executor_server.py``,
``python -m ballista_tpu_torch.executor``), the shuffle writer and reader
(``shuffle.py``, ``reader.py``), the Arrow Flight service that serves an
executor's shuffle output (``flight_service.py``), push shuffle
(``push.py``), per-operator metrics (``metrics.py``) and the TTL sweep of
old job, spill and push data (``cleanup.py``). Tasks run on the card
unless the executor is asked for the CPU.
"""


def visible_devices() -> int:
    """Device count this process advertises
    (ExecutorSpecification.n_devices): always 1. The port has no mesh
    operators (ROADMAP queue 1, item 10b), and a scheduler lowers stages
    to them as soon as an executor advertises two devices."""
    return 1


def effective_task_slots(task_slots: int) -> int:
    """The reference's rule: a device mesh is one resource, so an executor
    that advertises two or more devices runs one task at a time. Shared by
    the pull loop and the push server so both keep the same concurrency."""
    if visible_devices() >= 2 and task_slots > 1:
        return 1
    return task_slots
