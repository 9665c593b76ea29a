"""Executor process entrypoint: ``python -m ballista_tpu_torch.executor``
(port of ``python -m ballista_tpu.executor``).

ref ballista/rust/executor/src/main.rs:64-296 — parse the flag/env config
tier, start the Flight (data-plane) server, connect to the scheduler in
pull- or push-staged mode, and run the shuffle-data TTL cleanup loop until
interrupted.

Flags mirror the reference's executor config spec (executor_config_spec.toml);
every flag also reads a ``BALLISTA_EXECUTOR_<NAME>`` environment default, the
reference's configure_me behavior. ``--device`` (default ``cuda``) is the
port's own: tasks run on the card, and without one the process exits
before it binds a port unless started with ``--device cpu``. The port
serves memory tables only in process (it has no file scans yet, ROADMAP
queue 1, item 3), and ``--prewarm`` accepts only ``off``.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import tempfile
import threading

from ballista_tpu_torch.columnar.batch import resolve_device
from ballista_tpu_torch.config import TaskSchedulingPolicy
from ballista_tpu_torch.errors import ConfigError
from ballista_tpu_torch.executor.cleanup import start_cleanup_loop
from ballista_tpu_torch.executor.executor import (
    Executor,
    PollLoop,
    check_prewarm,
    new_executor_id,
)
from ballista_tpu_torch.executor.flight_service import start_flight_server

log = logging.getLogger("ballista_tpu_torch.executor")


def _env(name: str, default):
    return os.environ.get(f"BALLISTA_EXECUTOR_{name.upper()}", default)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.executor",
        description="ballista-tpu executor process (PyTorch/CUDA)",
    )
    p.add_argument("--bind-host", default=_env("bind_host", "0.0.0.0"))
    p.add_argument(
        "--external-host",
        default=_env("external_host", "localhost"),
        help="host advertised to the scheduler/clients for Flight fetches",
    )
    p.add_argument(
        "--bind-port", type=int, default=int(_env("bind_port", 50051)),
        help="Flight data-plane port",
    )
    p.add_argument(
        "--bind-grpc-port", type=int, default=int(_env("bind_grpc_port", 50053)),
        help="push-mode control port (LaunchTask); 50052 is the "
        "scheduler's conventional REST port, so default past it",
    )
    p.add_argument("--scheduler-host", default=_env("scheduler_host", "localhost"))
    p.add_argument(
        "--scheduler-port", type=int, default=int(_env("scheduler_port", 50050))
    )
    p.add_argument(
        "--work-dir", default=_env("work_dir", ""),
        help="shuffle spill directory (default: a fresh temp dir)",
    )
    p.add_argument(
        "--concurrent-tasks", type=int, default=int(_env("concurrent_tasks", 4))
    )
    p.add_argument(
        "--task-scheduling-policy",
        default=_env("task_scheduling_policy", "pull-staged"),
        choices=["pull-staged", "push-staged"],
    )
    p.add_argument(
        "--job-data-ttl-seconds",
        type=float,
        default=float(_env("job_data_ttl_seconds", 604800)),
    )
    p.add_argument(
        "--job-data-clean-up-interval-seconds",
        type=float,
        default=float(_env("job_data_clean_up_interval_seconds", 0)),
        help="0 disables the cleanup loop (ref main.rs:188-203)",
    )
    p.add_argument(
        "--prewarm",
        default=_env("prewarm", os.environ.get("BALLISTA_TPU_PREWARM", "off")),
        choices=["off", "on", "background"],
        help="AOT-compile the kernel vocabulary at start: only 'off' is "
        "supported by this engine (ROADMAP queue 1, item 10b)",
    )
    p.add_argument(
        "--metrics-port",
        type=int,
        default=int(_env("metrics_port", 0)),
        help="serve Prometheus text metrics on this port; 0 disables, the "
        "only value this engine supports yet (ROADMAP queue 1, item 9e)",
    )
    p.add_argument("--log-level", default=_env("log_level", "INFO"))
    p.add_argument(
        "--device", default=_env("device", "cuda"),
        help="where tasks run: cuda (default; the process exits without a "
        "card) or cpu",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    policy = TaskSchedulingPolicy.parse(args.task_scheduling_policy)
    check_prewarm(args.prewarm)
    if args.metrics_port:
        raise ConfigError(
            "--metrics-port is not supported by this engine yet: the "
            "Prometheus exposition is ROADMAP queue 1, item 9e"
        )
    # the device first: without a card (and without --device cpu) the
    # process raises here, before it makes a directory or binds a port
    device = resolve_device(args.device)
    # the handlers come before the ports: a SIGTERM during start-up stops
    # the executor cleanly once it has started
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="ballista-executor-")
    os.makedirs(work_dir, exist_ok=True)
    executor_id = new_executor_id()
    executor = Executor(executor_id=executor_id, work_dir=work_dir, device=device)

    svc, flight_port, _t = start_flight_server(
        args.bind_host, args.bind_port, work_dir
    )
    log.info(
        "executor %s: Flight on %s:%d, work_dir=%s, policy=%s, device=%s",
        executor_id, args.bind_host, flight_port, work_dir, policy.value,
        device,
    )

    scheduler_addr = f"{args.scheduler_host}:{args.scheduler_port}"
    if policy == TaskSchedulingPolicy.PUSH_STAGED:
        from ballista_tpu_torch.executor.executor_server import ExecutorServer

        server = ExecutorServer(
            executor,
            scheduler_addr,
            args.external_host,
            flight_port,
            task_slots=args.concurrent_tasks,
            prewarm=args.prewarm,
        )
        grpc_port = server.startup(args.bind_host, args.bind_grpc_port)
        log.info("push-mode ExecutorGrpc on %s:%d", args.bind_host, grpc_port)
        worker = server
    else:
        loop = PollLoop(
            executor,
            scheduler_addr,
            args.external_host,
            flight_port,
            task_slots=args.concurrent_tasks,
            prewarm=args.prewarm,
        )
        loop.start()
        worker = loop

    if args.job_data_clean_up_interval_seconds > 0:
        start_cleanup_loop(
            work_dir,
            args.job_data_ttl_seconds,
            args.job_data_clean_up_interval_seconds,
        )

    # wake up twice a second: a signal delivered to one of gRPC's threads
    # runs its Python handler only when the main thread next runs, and an
    # untimed wait would never return
    while not stop.wait(0.5):
        pass
    log.info("shutting down")
    worker.stop()
    svc.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
