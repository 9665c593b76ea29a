"""The operator's surface of the port's cluster against the reference's, on
the CPU: the REST API (``scheduler/rest.py``), the Prometheus exposition
(``obs/prometheus.py``), the KEDA external scaler
(``scheduler/external_scaler.py``) and the etcd state backend
(``scheduler/etcd_backend.py``).

One port cluster (``BallistaContext.standalone(device="cpu")``, two
executors) and one reference cluster run q1 and q3 of TPC-H at SF=0.002
(one of each a module). Their REST payloads agree in every key, in each
job's status, stages, dependencies, stage plans and task counts; their
metric families agree by name and both pass both packages'
``validate_exposition``. The scaler answers the contract of
``tests/test_fleet_obs.py``'s scaler case step for step as the
reference's does. The etcd cases are ``tests/test_etcd_backend.py``'s,
run against this file's copy of its fake etcd (a dict behind the genuine
etcd service paths), plus a port backend and a reference backend sharing
one fake. Timings, ids and ports are not compared; everything else is
exact.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent import futures

import grpc
import pytest
import torch

from ballista_tpu_torch.proto import etcd_pb2 as epb
from ballista_tpu_torch.scheduler.etcd_backend import EtcdBackend, prefix_end
from ballista_tpu_torch.tpch import gen_all
from test_torch_stages import query_sql

SCALE = 0.002
QUERIES = ("q1", "q3")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the two clusters, each with its REST server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clusters():
    """{"port": ..., "ref": ...}: each a dict with the client, the
    scheduler, the REST base URL, and the job id of each query."""
    from ballista_tpu.client.context import BallistaContext as RefClient
    from ballista_tpu.scheduler.rest import start_rest_server as ref_start
    from ballista_tpu.scheduler.rest import stop_rest_server as ref_stop
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.scheduler.rest import start_rest_server, stop_rest_server

    data = gen_all(SCALE, 42)
    made = {
        "port": (BallistaContext.standalone(device="cpu", n_executors=2, concurrent_tasks=2),
                 start_rest_server, stop_rest_server),
        "ref": (RefClient.standalone(n_executors=2, concurrent_tasks=2), ref_start, ref_stop),
    }
    out = {}
    try:
        for side, (ctx, start, _stop) in made.items():
            for name, t in data.items():
                ctx.register_table(name, t)
            sched = ctx._standalone_cluster.scheduler
            jobs = {}
            for q in QUERIES:
                before = set(sched.jobs)
                ctx.sql(query_sql(q, data)).collect()
                (jobs[q],) = set(sched.jobs) - before
            httpd, port = start(sched, "127.0.0.1", 0)
            out[side] = dict(ctx=ctx, sched=sched, httpd=httpd, base=f"http://127.0.0.1:{port}", jobs=jobs)
        yield out
    finally:
        for side, (ctx, _start, stop) in made.items():
            if side in out:
                stop(out[side]["httpd"])
            ctx.close()


def get(base: str, path: str):
    return json.load(urllib.request.urlopen(base + path, timeout=30))


def keys_of(d) -> object:
    """The nested key structure of a JSON value (lists by their first
    element), without the values."""
    if isinstance(d, dict):
        return {k: keys_of(v) for k, v in d.items()}
    if isinstance(d, list):
        return [keys_of(d[0])] if d else []
    return type(d).__name__ if isinstance(d, (bool, str)) else "number"


# ---------------------------------------------------------------------------
# REST
# ---------------------------------------------------------------------------


def test_rest_state_matches_reference(clusters):
    """``/api/state``: the same keys at every level, two executors with
    the same slots and devices, and each query's job with the same status,
    stage count, retries and per-stage task counts."""
    got, want = (get(clusters[s]["base"], "/api/state") for s in ("port", "ref"))
    assert set(got) == set(want)
    assert (got["policy"], got["version"]) == (want["policy"], want["version"])
    assert set(got["executors"][0]) == set(want["executors"][0])
    for side in (got, want):
        for e in side["executors"]:
            e.pop("compile")  # the port ships nvcc seconds, the reference XLA counters
    assert keys_of(got["executors"]) == keys_of(want["executors"])
    assert sorted((e["n_devices"], e["total_task_slots"]) for e in got["executors"]) == sorted(
        (e["n_devices"], e["total_task_slots"]) for e in want["executors"]
    )
    assert keys_of(got["jobs"]) == keys_of(want["jobs"])
    by_id = {s: {j["job_id"]: j for j in d["jobs"]} for s, d in (("port", got), ("ref", want))}
    for q in QUERIES:
        g, w = (by_id[s][clusters[s]["jobs"][q]] for s in ("port", "ref"))
        for k in ("status", "n_stages", "error", "retries", "recomputes", "rewrites"):
            assert g[k] == w[k], (q, k)
        assert [(st["stage_id"], st["state"], st["n_tasks"], st["tasks"]) for st in g["stages"]] == [
            (st["stage_id"], st["state"], st["n_tasks"], st["tasks"]) for st in w["stages"]
        ], q


@pytest.mark.parametrize("q", QUERIES)
def test_rest_job_detail_matches_reference(clusters, q):
    """``/api/job/<id>`` and its ``/timeline``: the same keys, status,
    final stage, dependencies and stage plans (``display()``, the job id
    aside) and one timeline row per task."""
    got, want = (get(clusters[s]["base"], f"/api/job/{clusters[s]['jobs'][q]}") for s in ("port", "ref"))
    assert set(got) == set(want)
    for k in ("status", "error", "final_stage_id", "retries", "recomputes", "rewrites",
              "rewrite_rejects", "rewrite_log", "aqe", "query_class", "skew"):
        assert got[k] == want[k], k

    def stages(d, side):
        job = clusters[side]["jobs"][q]
        return [(s["stage_id"], s["depends_on"], s["plan"].replace(job, "<job>")) for s in d["stages"]]

    assert stages(got, "port") == stages(want, "ref")
    assert set(got["cost"]) == set(want["cost"]) and got["cost"]["wall_seconds"] > 0
    g_tl, w_tl = (get(clusters[s]["base"], f"/api/job/{clusters[s]['jobs'][q]}/timeline")
                  for s in ("port", "ref"))
    assert set(g_tl) == set(w_tl) and g_tl["query_class"] == w_tl["query_class"]
    assert keys_of(g_tl["tasks"]) == keys_of(w_tl["tasks"])
    assert sorted((t["stage_id"], t["partition"], t["state"]) for t in g_tl["tasks"]) == sorted(
        (t["stage_id"], t["partition"], t["state"]) for t in w_tl["tasks"]
    )


def test_rest_history_and_errors_match_reference(clusters):
    """``/api/history`` of each kind (rows, keys, statuses), a 400 for an
    unknown kind, 404s with JSON bodies for an unknown job and path, and
    the status page."""
    for kind in ("queries", "task_attempts", "executors"):
        got, want = (get(clusters[s]["base"], f"/api/history?kind={kind}") for s in ("port", "ref"))
        assert got["kind"] == want["kind"] == kind
        assert len(got["rows"]) == len(want["rows"]) > 0, kind
        assert keys_of(got["rows"]) == keys_of(want["rows"]), kind
        if kind == "queries":
            assert sorted(r["status"] for r in got["rows"]) == ["completed"] * len(QUERIES)
    for path, code in (("/api/history?kind=nope", 400), ("/api/job/nosuch", 404), ("/api/nope", 404)):
        bodies = []
        for s in ("port", "ref"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(clusters[s]["base"] + path, timeout=30)
            assert e.value.code == code, (s, path)
            bodies.append(json.loads(e.value.read()))
        assert bodies[0] == bodies[1], path
    page, ref_page = (urllib.request.urlopen(clusters[s]["base"] + "/", timeout=30).read() for s in ("port", "ref"))
    assert page == ref_page


# ---------------------------------------------------------------------------
# Prometheus
# ---------------------------------------------------------------------------


def families_of(text: str) -> set:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}


def test_scheduler_metrics_match_reference(clusters):
    """The scheduler's ``/api/metrics``: the same families, each scrape
    valid under both packages' validators, the jobs by status and the
    cost rollup present."""
    from ballista_tpu.obs.prometheus import validate_exposition as ref_validate
    from ballista_tpu_torch.obs.prometheus import CONTENT_TYPE, validate_exposition

    texts = {}
    for s in ("port", "ref"):
        resp = urllib.request.urlopen(clusters[s]["base"] + "/api/metrics", timeout=30)
        assert resp.headers["Content-Type"] == CONTENT_TYPE
        texts[s] = resp.read().decode()
    for text in texts.values():
        validate_exposition(text)
        ref_validate(text)
    assert families_of(texts["port"]) == families_of(texts["ref"])
    assert 'ballista_jobs{status="completed"} 2' in texts["port"]
    assert 'ballista_job_cost_total{class=' in texts["port"]
    assert "ballista_executors_alive 2" in texts["port"]


def test_executor_metrics_server_matches_reference():
    """``start_metrics_server(executor_families)``: a valid exposition at
    ``/api/metrics`` with the reference's executor families (the compile
    family holds the port's build and hint counters), 404 elsewhere, and
    a clean stop."""
    from ballista_tpu.obs import prometheus as ref_prom
    from ballista_tpu_torch.obs import prometheus as prom

    httpd, port = prom.start_metrics_server(prom.executor_families, "127.0.0.1", 0)
    try:
        text = urllib.request.urlopen(f"http://127.0.0.1:{port}/api/metrics", timeout=30).read().decode()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
        assert e.value.code == 404
    finally:
        prom.stop_metrics_server(httpd)
    assert not httpd._serve_thread.is_alive()
    prom.validate_exposition(text)
    ref_prom.validate_exposition(text)
    assert 'ballista_executor_compile{counter="compile_seconds"}' in text
    want = families_of(ref_prom.render(ref_prom.executor_families()))
    assert families_of(text) == want


@pytest.mark.parametrize(
    "text",
    [
        "# HELP a_b x\n# TYPE a_b gauge\na_b 1\n",
        '# TYPE h histogram\nh_bucket{le="+Inf",class="q"} 3\nh_sum 0.5\n',
        "a_b 1",  # no trailing newline
        "# TYPE a_b summary\n",
        "1abc 2\n",
        'a{b="c"} x\n',
        'a{b="c\\"d"} -1.5e-3\n',
    ],
)
def test_validate_exposition_agrees_with_reference(text):
    from ballista_tpu.obs.prometheus import validate_exposition as ref_validate
    from ballista_tpu_torch.obs.prometheus import validate_exposition

    verdicts = []
    for validate in (validate_exposition, ref_validate):
        try:
            validate(text)
            verdicts.append("ok")
        except AssertionError as e:
            verdicts.append(str(e))
    assert verdicts[0] == verdicts[1]


def test_render_matches_reference():
    """``render`` of gauge, counter and histogram samples, label escaping
    and name sanitizing: the reference's text byte for byte."""
    from ballista_tpu.obs.prometheus import render as ref_render
    from ballista_tpu_torch.obs.prometheus import render

    fams = [
        ("ballista_x", "gauge", "help", [({"b": "2"}, 1.5), ({"a": 'q"\\\n'}, 3)]),
        ("9bad-name", "counter", "c", [({}, 0)]),
        ("h", "histogram", "h", [("_bucket", {"le": "1"}, 1), ("_bucket", {"le": "+Inf"}, 2),
                                 ("_sum", {}, 0.25), ("_count", {}, 2)]),
    ]
    assert render(fams) == ref_render(fams)


# ---------------------------------------------------------------------------
# KEDA external scaler
# ---------------------------------------------------------------------------


def _scaler_steps(pkg: str) -> list:
    """The contract of ``tests/test_fleet_obs.py``'s scaler case, run on
    one package's scheduler and scaler; every answer is recorded."""
    if pkg == "port":
        from ballista_tpu_torch.proto import pb
        from ballista_tpu_torch.scheduler.external_scaler import ExternalScalerServicer
        from ballista_tpu_torch.scheduler.server import SchedulerServer
        from ballista_tpu_torch.scheduler_types import ExecutorData
    else:
        from ballista_tpu.proto import pb
        from ballista_tpu.scheduler.external_scaler import ExternalScalerServicer
        from ballista_tpu.scheduler.server import SchedulerServer
        from ballista_tpu.scheduler_types import ExecutorData

    server = SchedulerServer(provider=None, expiry_check_interval_s=3600)
    steps: list = []
    try:
        svc = ExternalScalerServicer(server)
        ref = pb.ScaledObjectRef(name="x", namespace="default")
        req = pb.GetMetricsRequest(scaledObjectRef=ref)

        def metric(r=req):
            v = svc.GetMetrics(r, None).metricValues[0]
            return (v.metricName, v.metricValue)

        steps += [svc.IsActive(ref, None).result, metric()]
        spec = svc.GetMetricSpec(ref, None).metricSpecs[0]
        steps.append((spec.metricName, spec.targetSize))
        server.stage_manager.add_running_stage("job1", 1, 8)
        steps += [svc.IsActive(ref, None).result, metric()]
        server.executor_manager.save_executor_data(ExecutorData("e1", 8, 8))
        steps.append(metric())
        steps.append(metric(pb.GetMetricsRequest(metricName="inflight_tasks")))
        target = server.config.scaler_queue_wait_target_s()
        now = time.time()
        for wait in (target * 3, target * 100):
            with server._lock:
                server._recent_queue_waits.clear()
                server._recent_queue_waits.extend([(now, wait)] * 20)
            steps.append(metric())
        stale = now - server.queue_wait_window_s - 1
        with server._lock:
            server._recent_queue_waits.clear()
            server._recent_queue_waits.extend([(stale, target * 100)] * 20)
        steps.append(metric())
    finally:
        server.shutdown()
    return steps


def test_external_scaler_contract_matches_reference():
    got = _scaler_steps("port")
    assert got == _scaler_steps("ref")
    assert got == [
        False, ("desired_executors", 0), ("desired_executors", 1), True, ("desired_executors", 2),
        ("desired_executors", 1), ("inflight_tasks", 8), ("desired_executors", 3),
        ("desired_executors", 4), ("desired_executors", 1),
    ]


def test_external_scaler_rides_the_scheduler_grpc_port(clusters):
    """KEDA's service path on the port scheduler's gRPC port: inactive and
    zero pressure once the two queries finished, as on the reference's."""
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.scheduler.external_scaler import (
        EXTERNAL_SCALER_METHODS,
        EXTERNAL_SCALER_SERVICE,
    )

    answers = []
    for s in ("port", "ref"):
        port = clusters[s]["ctx"]._standalone_cluster.scheduler_port
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            calls = {
                name: ch.unary_unary(
                    f"/{EXTERNAL_SCALER_SERVICE}/{name}",
                    request_serializer=lambda r: r.SerializeToString(),
                    response_deserializer=resp.FromString,
                )
                for name, (_req, resp) in EXTERNAL_SCALER_METHODS.items()
            }
            ref = pb.ScaledObjectRef(name="x")
            answers.append((
                calls["IsActive"](ref, timeout=10).result,
                calls["GetMetrics"](pb.GetMetricsRequest(scaledObjectRef=ref), timeout=10).metricValues[0].metricValue,
                calls["GetMetricSpec"](ref, timeout=10).metricSpecs[0].metricName,
            ))
    assert answers[0] == answers[1] == (False, 0, "desired_executors")


# ---------------------------------------------------------------------------
# etcd: a copy of tests/test_etcd_backend.py's fake, and its cases
# ---------------------------------------------------------------------------


class FakeEtcd:
    """KV + Watch + Lease + v3 Lock over a dict, mod-revision tracked."""

    def __init__(self) -> None:
        self._kv: dict[bytes, bytes] = {}
        self._rev = 0
        self._mu = threading.Lock()
        self._watches: list[tuple[bytes, bytes, object]] = []
        self._lease_ids = itertools.count(1)
        self._lock_cv = threading.Condition()
        self._lock_holder: bytes | None = None

    def _in_range(self, k: bytes, key: bytes, range_end: bytes) -> bool:
        if not range_end:
            return k == key
        if range_end == b"\x00":
            return k >= key
        return key <= k < range_end

    def Range(self, req, ctx):
        with self._mu:
            kvs = sorted((k, v) for k, v in self._kv.items() if self._in_range(k, req.key, req.range_end))
            resp = epb.RangeResponse(count=len(kvs))
            resp.header.revision = self._rev
            for k, v in kvs:
                resp.kvs.add(key=k, value=v, mod_revision=self._rev)
            return resp

    def _broadcast(self, ev) -> None:
        for key, range_end, q in list(self._watches):
            if self._in_range(ev.kv.key, key, range_end):
                q.append(ev)

    def Put(self, req, ctx):
        with self._mu:
            self._rev += 1
            self._kv[req.key] = req.value
            ev = epb.Event(type=epb.Event.PUT)
            ev.kv.key, ev.kv.value = req.key, req.value
            ev.kv.mod_revision = self._rev
            self._broadcast(ev)
            resp = epb.PutResponse()
            resp.header.revision = self._rev
            return resp

    def DeleteRange(self, req, ctx):
        with self._mu:
            gone = [k for k in self._kv if self._in_range(k, req.key, req.range_end)]
            self._rev += 1
            for k in gone:
                del self._kv[k]
                ev = epb.Event(type=epb.Event.DELETE)
                ev.kv.key = k
                ev.kv.mod_revision = self._rev
                self._broadcast(ev)
            resp = epb.DeleteRangeResponse(deleted=len(gone))
            resp.header.revision = self._rev
            return resp

    def Watch(self, request_iter, ctx):
        sub: list | None = None
        try:
            req = next(request_iter)
        except StopIteration:
            return
        if req.HasField("create_request"):
            cr = req.create_request
            sub = []
            with self._mu:
                self._watches.append((cr.key, cr.range_end, sub))
            yield epb.WatchResponse(watch_id=1, created=True)
            try:
                while ctx.is_active():
                    if sub:
                        resp = epb.WatchResponse(watch_id=1)
                        while sub:
                            resp.events.append(sub.pop(0))
                        yield resp
                    else:
                        time.sleep(0.01)
            finally:
                with self._mu:
                    self._watches = [w for w in self._watches if w[2] is not sub]

    def LeaseGrant(self, req, ctx):
        return epb.LeaseGrantResponse(ID=next(self._lease_ids), TTL=req.TTL)

    def LeaseRevoke(self, req, ctx):
        return epb.LeaseRevokeResponse()

    def Lock(self, req, ctx):
        key = req.name + b"/%d" % req.lease
        with self._lock_cv:
            while self._lock_holder is not None:
                self._lock_cv.wait()
            self._lock_holder = key
        return epb.LockResponse(key=key)

    def Unlock(self, req, ctx):
        with self._lock_cv:
            if self._lock_holder == req.key:
                self._lock_holder = None
                self._lock_cv.notify_all()
        return epb.UnlockResponse()


def serve_fake_etcd(fake: FakeEtcd):
    """Serve ``fake`` under the etcd service paths on a local port:
    (grpc server, "127.0.0.1:port")."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))

    def unary(fn, req_cls):
        return grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=req_cls.FromString,
            response_serializer=lambda r: r.SerializeToString())

    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler("etcdserverpb.KV", {
            "Range": unary(fake.Range, epb.RangeRequest),
            "Put": unary(fake.Put, epb.PutRequest),
            "DeleteRange": unary(fake.DeleteRange, epb.DeleteRangeRequest),
        }),
        grpc.method_handlers_generic_handler("etcdserverpb.Watch", {
            "Watch": grpc.stream_stream_rpc_method_handler(
                fake.Watch, request_deserializer=epb.WatchRequest.FromString,
                response_serializer=lambda r: r.SerializeToString()),
        }),
        grpc.method_handlers_generic_handler("etcdserverpb.Lease", {
            "LeaseGrant": unary(fake.LeaseGrant, epb.LeaseGrantRequest),
            "LeaseRevoke": unary(fake.LeaseRevoke, epb.LeaseRevokeRequest),
        }),
        grpc.method_handlers_generic_handler("v3lockpb.Lock", {
            "Lock": unary(fake.Lock, epb.LockRequest),
            "Unlock": unary(fake.Unlock, epb.UnlockRequest),
        }),
    ))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, f"127.0.0.1:{port}"


@pytest.fixture()
def etcd():
    server, url = serve_fake_etcd(FakeEtcd())
    yield url
    server.stop(grace=None)


def test_prefix_end_matches_reference():
    from ballista_tpu.scheduler.etcd_backend import prefix_end as ref_prefix_end

    for p in (b"/ballista/", b"a\xff", b"\xff\xff", b"", b"\x00", b"ab\xfe\xff"):
        assert prefix_end(p) == ref_prefix_end(p), p
    assert prefix_end(b"/ballista/") == b"/ballista0"
    assert prefix_end(b"\xff\xff") == b"\x00"


def test_etcd_kv_and_prefix(etcd):
    be = EtcdBackend(etcd)
    assert be.get("/ballista/jobs/j1") is None
    be.put("/ballista/jobs/j1", b"queued")
    be.put("/ballista/jobs/j2", b"running")
    be.put("/ballista/executors/e1", b"alive")
    assert be.get("/ballista/jobs/j1") == b"queued"
    assert be.get_from_prefix("/ballista/jobs/") == [
        ("/ballista/jobs/j1", b"queued"),
        ("/ballista/jobs/j2", b"running"),
    ]
    be.delete("/ballista/jobs/j1")
    assert be.get("/ballista/jobs/j1") is None
    be.close()


def test_etcd_watch_sees_other_clients(etcd):
    """A watch of the port's backend observes writes the reference's
    backend makes, and the other way round: one wire protocol."""
    from ballista_tpu.scheduler.etcd_backend import EtcdBackend as RefEtcdBackend

    for watcher, writer in ((EtcdBackend(etcd), RefEtcdBackend(etcd)), (RefEtcdBackend(etcd), EtcdBackend(etcd))):
        w = watcher.watch("/ballista/jobs/")
        writer.put("/ballista/jobs/j1", b"queued")
        writer.put("/ballista/other/x", b"ignored")
        writer.delete("/ballista/jobs/j1")
        e1 = w.get(timeout=2)
        assert (e1.kind, e1.key, e1.value) == ("put", "/ballista/jobs/j1", b"queued")
        e2 = w.get(timeout=2)
        assert (e2.kind, e2.value) == ("delete", None)
        assert w.get(timeout=0.05) is None
        w.stop()
        watcher.close()
        writer.close()


def test_etcd_global_lock_mutual_exclusion(etcd):
    a, b = EtcdBackend(etcd), EtcdBackend(etcd)
    order: list[str] = []
    entered = threading.Event()
    release = threading.Event()

    def holder():
        with a.lock():
            order.append("a-in")
            entered.set()
            release.wait(timeout=5)
            order.append("a-out")

    t = threading.Thread(target=holder)
    t.start()
    assert entered.wait(timeout=5)
    t2_done = threading.Event()

    def contender():
        with b.lock():
            order.append("b-in")
            t2_done.set()

    t2 = threading.Thread(target=contender)
    t2.start()
    time.sleep(0.2)
    assert "b-in" not in order  # blocked while a holds it
    release.set()
    assert t2_done.wait(timeout=5)
    t.join(timeout=5)
    t2.join(timeout=5)
    assert order == ["a-in", "a-out", "b-in"]
    a.close()
    b.close()


def test_persistent_state_over_etcd_matches_reference(etcd):
    """Scheduler restart recovery through etcd: executor metadata saved by
    the port's state is recovered by a fresh port state and by the
    reference's, from the same bytes the reference writes."""
    from ballista_tpu.scheduler.persistent_state import PersistentSchedulerState as RefState
    from ballista_tpu.scheduler.etcd_backend import EtcdBackend as RefEtcdBackend
    from ballista_tpu.scheduler_types import ExecutorMetadata as RefMeta
    from ballista_tpu.scheduler_types import ExecutorSpecification as RefSpec
    from ballista_tpu_torch.scheduler.persistent_state import PersistentSchedulerState
    from ballista_tpu_torch.scheduler_types import ExecutorMetadata, ExecutorSpecification

    be = EtcdBackend(etcd)
    PersistentSchedulerState(be, namespace="t").save_executor_metadata(ExecutorMetadata(
        id="e1", host="h", port=1, grpc_port=2, specification=ExecutorSpecification(task_slots=4)))
    ref_be = RefEtcdBackend(etcd)
    RefState(ref_be, namespace="r").save_executor_metadata(RefMeta(
        id="e1", host="h", port=1, grpc_port=2, specification=RefSpec(task_slots=4)))
    assert be.get_from_prefix("/ballista/t/") == [
        (k.replace("/r/", "/t/"), v) for k, v in ref_be.get_from_prefix("/ballista/r/")
    ]
    be.close()

    be2 = EtcdBackend(etcd)
    metas = PersistentSchedulerState(be2, namespace="t").load_executors()
    assert [(m.id, m.specification.task_slots) for m in metas] == [("e1", 4)]
    assert [(m.id, m.specification.task_slots) for m in RefState(ref_be, namespace="t").load_executors()] == [("e1", 4)]
    be2.close()
    ref_be.close()
