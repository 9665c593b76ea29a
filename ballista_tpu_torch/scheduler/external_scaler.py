"""KEDA external-scaler gRPC service.

ref ballista/rust/scheduler/src/scheduler_server/external_scaler.rs:31-66:
KEDA polls ``IsActive`` (scale 0<->1 on whether any task is running) and
``GetMetrics`` (saturate the HPA while work exists). Served under KEDA's
fixed service path ``externalscaler.ExternalScaler`` (keda.proto) so a
stock KEDA `ScaledObject` pointing at the scheduler works unchanged.

Port of ``ballista_tpu/scheduler/external_scaler.py``, unchanged: the
scale signal is host-side scheduler state.
"""

from __future__ import annotations

from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler.rpc import add_service

EXTERNAL_SCALER_SERVICE = "externalscaler.ExternalScaler"

EXTERNAL_SCALER_METHODS = {
    "IsActive": (pb.ScaledObjectRef, pb.IsActiveResponse),
    "GetMetricSpec": (pb.ScaledObjectRef, pb.GetMetricSpecResponse),
    "GetMetrics": (pb.GetMetricsRequest, pb.GetMetricsResponse),
}

# PR 12 (docs/observability.md): the scale signal is no longer the raw
# inflight count — GetMetrics reports SchedulerServer.desired_executors(),
# the composite pressure (inflight tasks over per-executor slots, scaled
# up when queue-wait p90 exceeds the declared target) also exposed as the
# ballista_desired_executors gauge. With targetSize=1 KEDA's replica math
# (metricValue / targetSize) then IS the desired executor count.
COMPOSITE_PRESSURE_METRIC_NAME = "desired_executors"
# Pre-PR-12 metric name: a GetMetrics request that explicitly asks for
# it (a ScaledObject pinning `metricName: inflight_tasks`) still gets
# the raw inflight count under that name — real back-compat, not an
# advertised default (GetMetricSpec only announces the composite).
INFLIGHT_TASKS_METRIC_NAME = "inflight_tasks"


class ExternalScalerServicer:
    """Implements KEDA's three-RPC contract over the scheduler state."""

    def __init__(self, server):
        self.s = server

    def IsActive(self, request: pb.ScaledObjectRef, context):
        # ref :34-41 checks has_running_tasks(); counting PENDING too is a
        # deliberate fix — scaled to zero, no task can ever be RUNNING, so
        # the reference's signal can never trigger the 0->1 scale-up
        return pb.IsActiveResponse(
            result=self.s.stage_manager.inflight_tasks() > 0
        )

    def GetMetricSpec(self, request: pb.ScaledObjectRef, context):
        # ref :43-53 — one metric; target 1 means metricValue is read
        # directly as the replica count
        return pb.GetMetricSpecResponse(
            metricSpecs=[
                pb.MetricSpec(
                    metricName=COMPOSITE_PRESSURE_METRIC_NAME, targetSize=1
                )
            ]
        )

    def GetMetrics(self, request: pb.GetMetricsRequest, context):
        # ref :55-66 reports a huge constant to saturate the HPA while
        # work exists; the composite pressure signal gives KEDA the
        # actual executor count the queue state asks for — including the
        # queue-wait term that raw inflight counting cannot see (jobs
        # stacking up behind few big tasks)
        if request.metricName == INFLIGHT_TASKS_METRIC_NAME:
            # back-compat: a ScaledObject still pinning the pre-PR-12
            # name keeps its raw-inflight / 1-task-per-replica semantics
            return pb.GetMetricsResponse(
                metricValues=[
                    pb.MetricValue(
                        metricName=INFLIGHT_TASKS_METRIC_NAME,
                        metricValue=self.s.stage_manager.inflight_tasks(),
                    )
                ]
            )
        return pb.GetMetricsResponse(
            metricValues=[
                pb.MetricValue(
                    metricName=COMPOSITE_PRESSURE_METRIC_NAME,
                    metricValue=self.s.desired_executors(),
                )
            ]
        )


def add_external_scaler(grpc_server, scheduler_server) -> None:
    """Attach the KEDA service to an already-running gRPC server (the
    reference multiplexes it on the scheduler's main port, main.rs:136-166)."""
    add_service(
        grpc_server,
        EXTERNAL_SCALER_SERVICE,
        EXTERNAL_SCALER_METHODS,
        ExternalScalerServicer(scheduler_server),
    )
