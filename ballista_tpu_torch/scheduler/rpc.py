"""Hand-written gRPC plumbing for the two services.

The build image has protoc but not the grpc_tools python plugin, so the
method registry that generated *_pb2_grpc.py files would contain is written
out here explicitly (same wire format, same service/method names as
proto/ballista_tpu.proto services — ref ballista.proto:917-940).
"""

from __future__ import annotations

import os

import grpc

from ballista_tpu_torch.proto import pb

SCHEDULER_SERVICE = "ballista_tpu.SchedulerGrpc"
EXECUTOR_SERVICE = "ballista_tpu.ExecutorGrpc"


def rpc_timeout_s() -> float:
    """Default per-call deadline for client stubs built here (and the
    etcd unary calls — scheduler/etcd_backend.py). Unbounded RPCs are
    how a hung peer wedges the control plane: every unary call gets
    this deadline unless the caller passes an explicit ``timeout=``.
    0 (or negative) disables the default, restoring unbounded calls."""
    raw = os.environ.get("BALLISTA_RPC_TIMEOUT_S", "") or "30"
    try:
        return float(raw)
    except ValueError:
        return 30.0

SCHEDULER_METHODS = {
    "PollWork": (pb.PollWorkParams, pb.PollWorkResult),
    "RegisterExecutor": (pb.RegisterExecutorParams, pb.RegisterExecutorResult),
    "HeartBeatFromExecutor": (pb.HeartBeatParams, pb.HeartBeatResult),
    "UpdateTaskStatus": (pb.UpdateTaskStatusParams, pb.UpdateTaskStatusResult),
    "GetFileMetadata": (pb.GetFileMetadataParams, pb.GetFileMetadataResult),
    "ExecuteQuery": (pb.ExecuteQueryParams, pb.ExecuteQueryResult),
    "GetJobStatus": (pb.GetJobStatusParams, pb.GetJobStatusResult),
    # eager shuffle (docs/shuffle.md): executors poll published map-output
    # locations of a still-running producer stage
    "GetShuffleLocations": (pb.FetchPartition, pb.ShuffleLocationsResult),
    # queryable history (docs/observability.md): clients fetch the
    # persistent query log / cost records / executor roster backing the
    # system.* SQL tables
    "GetHistory": (pb.GetHistoryParams, pb.GetHistoryResult),
}

EXECUTOR_METHODS = {
    "LaunchTask": (pb.LaunchTaskParams, pb.LaunchTaskResult),
    "StopExecutor": (pb.StopExecutorParams, pb.StopExecutorResult),
}


def add_service(server: grpc.Server, service: str, methods: dict, impl) -> None:
    handlers = {}
    for name, (req, resp) in methods.items():
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            getattr(impl, name),
            request_deserializer=req.FromString,
            response_serializer=lambda r: r.SerializeToString(),
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service, handlers),)
    )


def _with_deadline(call):
    """Apply the default deadline to a unary callable unless the caller
    chose one (timeout=None explicitly requests an unbounded call)."""

    def invoke(request, *args, **kwargs):
        if args or "timeout" in kwargs:
            return call(request, *args, **kwargs)
        default = rpc_timeout_s()
        if default > 0:
            kwargs["timeout"] = default
        return call(request, **kwargs)

    return invoke


class _Stub:
    def __init__(self, channel: grpc.Channel, service: str, methods: dict):
        for name, (req, resp) in methods.items():
            setattr(
                self,
                name,
                _with_deadline(channel.unary_unary(
                    f"/{service}/{name}",
                    request_serializer=lambda r: r.SerializeToString(),
                    response_deserializer=resp.FromString,
                )),
            )


def scheduler_stub(channel: grpc.Channel) -> _Stub:
    return _Stub(channel, SCHEDULER_SERVICE, SCHEDULER_METHODS)


def executor_stub(channel: grpc.Channel) -> _Stub:
    return _Stub(channel, EXECUTOR_SERVICE, EXECUTOR_METHODS)
