"""Scheduler process entrypoint: ``python -m ballista_tpu_torch.scheduler``.

(port of ``python -m ballista_tpu.scheduler``).

ref ballista/rust/scheduler/src/main.rs:65-198 — parse the flag/env config
tier, pick the state backend (in-memory or sqlite, standing in for the
reference's sled/etcd pair), start the SchedulerGrpc service, and wait for
a signal.

Flags mirror the reference's scheduler config spec; every flag also reads a
``BALLISTA_SCHEDULER_<NAME>`` environment default (configure_me behavior).
The scheduler plans and never runs an operator, so it needs no card. A
non-zero ``--rest-port`` (the REST API) and ``--state-backend etcd`` are
refused with ``ConfigError`` before any port is bound: both are ROADMAP
queue 1, item 9e. The process wakes twice a second to see a stop signal.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

from ballista_tpu_torch.config import BallistaConfig, TaskSchedulingPolicy
from ballista_tpu_torch.errors import ConfigError

log = logging.getLogger("ballista_tpu_torch.scheduler")


def _env(name: str, default):
    return os.environ.get(f"BALLISTA_SCHEDULER_{name.upper()}", default)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.scheduler",
        description="ballista-tpu scheduler process (PyTorch/CUDA)",
    )
    p.add_argument("--bind-host", default=_env("bind_host", "0.0.0.0"))
    p.add_argument(
        "--bind-port", type=int, default=int(_env("bind_port", 50050))
    )
    p.add_argument(
        "--rest-port",
        type=int,
        default=int(_env("rest_port", 0)),
        help="REST /state + UI port; 0 disables "
        "(the reference multiplexes gRPC+REST on one port, main.rs:136-166)",
    )
    p.add_argument(
        "--scheduler-policy",
        default=_env("scheduler_policy", "pull-staged"),
        choices=["pull-staged", "push-staged"],
    )
    p.add_argument(
        "--namespace", default=_env("namespace", "ballista"),
        help="state-backend key prefix (ref main.rs:74-78)",
    )
    p.add_argument(
        "--state-backend",
        default=_env("state_backend", "memory"),
        choices=["memory", "sqlite", "etcd"],
        help="memory (ephemeral), sqlite (embedded/sled analogue), or "
        "etcd (HA/multi-scheduler, ref state/backend/etcd.rs:32-196)",
    )
    p.add_argument(
        "--state-path",
        default=_env("state_path", "ballista-scheduler-state.db"),
        help="sqlite file path when --state-backend=sqlite",
    )
    p.add_argument(
        "--etcd-urls",
        default=_env("etcd_urls", "localhost:2379"),
        help="etcd endpoints (host:port[,host:port...]) when "
        "--state-backend=etcd (ref scheduler main.rs --etcd-urls)",
    )
    p.add_argument(
        "--executor-timeout-seconds",
        type=float,
        default=float(_env("executor_timeout_seconds", 60)),
    )
    p.add_argument("--log-level", default=_env("log_level", "INFO"))
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    if args.rest_port:
        raise ConfigError(
            f"--rest-port {args.rest_port}: the REST API is not supported by "
            "this engine yet (ROADMAP queue 1, item 9e); use --rest-port 0"
        )
    if args.state_backend == "etcd":
        raise ConfigError(
            "--state-backend etcd is not supported by this engine yet "
            "(ROADMAP queue 1, item 9e); use memory or sqlite"
        )
    # handlers first: a SIGTERM that arrives while the server starts must
    # still stop it
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    from ballista_tpu_torch.scheduler.server import (
        SchedulerServer,
        start_scheduler_grpc,
    )
    from ballista_tpu_torch.scheduler.state_backend import (
        MemoryBackend,
        SqliteBackend,
    )

    if args.state_backend == "sqlite":
        backend = SqliteBackend(args.state_path)
    else:
        backend = MemoryBackend()
    server = SchedulerServer(
        provider=None,
        config=BallistaConfig(),
        state_backend=backend,
        namespace=args.namespace,
        policy=TaskSchedulingPolicy.parse(args.scheduler_policy),
        executor_timeout_s=args.executor_timeout_seconds,
    )
    grpc_server, port = start_scheduler_grpc(
        server, args.bind_host, args.bind_port
    )
    log.info(
        "scheduler: gRPC on %s:%d, policy=%s, backend=%s",
        args.bind_host, port, args.scheduler_policy, args.state_backend,
    )
    # wake up twice a second: a signal delivered to one of gRPC's threads
    # sets the flag only once the main thread runs Python again, and an
    # untimed wait would never return
    while not stop.wait(0.5):
        pass
    log.info("shutting down")
    grpc_server.stop(grace=1)
    server.shutdown()
    backend.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
