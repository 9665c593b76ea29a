"""The scrapeable metrics plane: Prometheus text exposition.

``GET /api/metrics`` on the scheduler REST server (scheduler/rest.py)
renders :func:`scheduler_families`; executor daemons can serve the same
format from a tiny stdlib HTTP server (:func:`start_metrics_server`,
wired behind ``--metrics-port`` in ``executor/__main__.py``) rendering
:func:`executor_families`. What was scattered — compile counters on
heartbeats, shuffle fetch-overlap counters in per-operator metrics,
retry/recompute totals in job records, queue depth inside the event
loop, live-resource counts in the reswitness — unifies into one
text/plain surface (Prometheus exposition format 0.0.4; a parser-level
tier-1 test pins validity).

Port of ``ballista_tpu/obs/prometheus.py``: the same families, names and
labels, with one difference. An executor's ``ballista_executor_compile``
counters are the port's (``executor.executor.compile_metrics``): its nvcc
build seconds and the counters of ``compilecache.metrics`` (prewarm
progress, the shared callable cache, the persisted hints).
"""

from __future__ import annotations

import logging
import re
import threading

log = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_name(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _esc(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def render(families: list[tuple]) -> str:
    """``families``: [(name, type, help, samples)]. A sample is either
    ``(labels-dict, value)`` (gauge/counter — sorted by label for output
    stability) or ``(suffix, labels-dict, value)`` (histogram
    ``_bucket``/``_sum``/``_count`` samples — emitted in the given order
    so cumulative ``le`` buckets stay ascending). Renders valid
    exposition text with one ``# HELP``/``# TYPE`` header per family."""
    out: list[str] = []
    for name, mtype, help_text, samples in families:
        name = sanitize_name(name)
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} {mtype}")
        plain = [s for s in samples if len(s) == 2]
        suffixed = [s for s in samples if len(s) == 3]
        for labels, value in sorted(
            plain, key=lambda s: sorted(s[0].items())
        ):
            out.append(f"{name}{_labels(labels)} {_fmt(value)}")
        for suffix, labels, value in suffixed:
            out.append(
                f"{name}{sanitize_name(suffix)}{_labels(labels)} "
                f"{_fmt(value)}"
            )
    return "\n".join(out) + "\n"


_EXP_HELP_RE = re.compile(r"^# HELP [a-zA-Z_:][a-zA-Z0-9_:]* .+$")
_EXP_TYPE_RE = re.compile(
    r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (gauge|counter|histogram)$"
)
_EXP_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*\})?"
    r" -?[0-9.e+-]+$"
)


def validate_exposition(text: str) -> None:
    """Assert ``text`` is well-formed exposition (every line a valid
    HELP/TYPE header or sample). Production-side consumers (the SLO
    harness scraping its own /api/metrics) share THIS validator; the
    tier-1 parser test keeps an independent copy on purpose — validating
    the renderer with the renderer's own module would be circular."""
    if not text.endswith("\n"):
        raise AssertionError("exposition must end with a newline")
    for line in text.splitlines():
        if line.startswith("# HELP"):
            ok = _EXP_HELP_RE.match(line)
        elif line.startswith("# TYPE"):
            ok = _EXP_TYPE_RE.match(line)
        else:
            ok = _EXP_SAMPLE_RE.match(line)
        if not ok:
            raise AssertionError(f"invalid exposition line: {line!r}")


def _labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(
        f'{_LABEL_OK.sub("_", k)}="{_esc(v)}"'
        for k, v in sorted(labels.items())
    )
    return "{" + body + "}"


def _fmt(v) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def scheduler_families(server) -> list[tuple]:
    """The scheduler's metric families, read through the same locked
    accessors the REST state payload uses."""
    import time

    em = server.executor_manager
    now = time.time()
    with server._lock:
        jobs = list(server.jobs.values())
        task_counters = dict(server.obs_task_counters)
    status_counts: dict[str, int] = {}
    retries = recomputes = rewrites = rewrite_rejects = 0
    for j in jobs:
        status_counts[j.status] = status_counts.get(j.status, 0) + 1
        retries += j.total_retries
        recomputes += j.total_recomputes
        rewrites += j.total_rewrites
        rewrite_rejects += j.total_rewrite_rejects
    free = total = alive = devices = 0
    compile_samples: list[tuple] = []
    alive_ids = em.get_alive_executors(server.executor_timeout_s)
    for meta in em.all_executors():
        data = em.get_executor_data(meta.id)
        if data is not None:
            free += data.available_task_slots
            total += data.total_task_slots
        if meta.id in alive_ids:
            alive += 1
            devices += meta.specification.n_devices or 1
        for k, v in (em.get_executor_metrics(meta.id) or {}).items():
            compile_samples.append(
                ({"executor": meta.id, "counter": sanitize_name(k)}, v)
            )
    families = [
        ("ballista_uptime_seconds", "gauge", "Scheduler uptime",
         [({}, now - server.start_time)]),
        ("ballista_executors_alive", "gauge", "Alive executors",
         [({}, alive)]),
        ("ballista_mesh_devices", "gauge", "Devices across alive executors",
         [({}, devices)]),
        ("ballista_task_slots", "gauge", "Task slots by state",
         [({"state": "free"}, free), ({"state": "total"}, total)]),
        ("ballista_jobs", "gauge", "Jobs by status",
         [({"status": s}, n) for s, n in sorted(status_counts.items())]),
        ("ballista_task_retries_total", "counter",
         "Bounded task retries across all jobs", [({}, retries)]),
        ("ballista_recomputes_total", "counter",
         "Lost-shuffle recompute rounds across all jobs", [({}, recomputes)]),
        # certified-rewrite visibility (docs/aqe.md): until now these
        # existed only as REST state fields — Prometheus gets the same
        # accepted/rejected totals, plus the per-op AQE family below
        ("ballista_plan_rewrites_total", "counter",
         "Certified plan rewrites ACCEPTED across all jobs "
         "(apply_certified_rewrite — AQE and manual)", [({}, rewrites)]),
        ("ballista_plan_rewrite_rejects_total", "counter",
         "Certified plan rewrites REJECTED by certificate validation "
         "across all jobs", [({}, rewrite_rejects)]),
        ("ballista_event_queue_depth", "gauge",
         "Scheduler event-loop queue depth (bounded queue + overflow)",
         [({}, server.event_loop.depth())]),
        ("ballista_inflight_tasks", "gauge",
         "Pending + running tasks (the KEDA scale signal)",
         [({}, server.stage_manager.inflight_tasks())]),
    ]
    if compile_samples:
        families.append(
            ("ballista_executor_compile", "gauge",
             "Latest compile-latency counter snapshot per executor "
             "(docs/compile_cache.md)", compile_samples)
        )
    if task_counters:
        families.append(
            ("ballista_task_counter_total", "counter",
             "Per-operator counters aggregated from shipped task metrics "
             "(shuffle fetched bytes/overlap, spill, write/repart time)",
             [({"counter": sanitize_name(k)}, v)
              for k, v in sorted(task_counters.items())])
        )
    # fleet-level distributional plane (docs/observability.md): straggler/
    # skew detection counters, the composite autoscale signal, span-drop
    # accounting, and every latency histogram (scheduler-observed + deltas
    # shipped home by executors)
    with server._lock:
        stragglers = dict(server.obs_straggler_total)
        skews = dict(server.obs_skew_total)
    families.append(
        ("ballista_stragglers_total", "counter",
         "Tasks flagged by the per-stage straggler monitor "
         "(duration > straggler_factor x stage median)",
         [({"class": c}, n) for c, n in sorted(stragglers.items())]
         or [({}, 0)])
    )
    # AQE policy decisions by op kind and outcome (docs/aqe.md):
    # applied = certified rewrite accepted, rejected = certificate
    # clause failed (the job ran on the pristine template), learned =
    # strategy recorded for the class's next submission
    with server._lock:
        aqe_totals = dict(server.obs_aqe_total)
    families.append(
        ("ballista_aqe_rewrites_total", "counter",
         "AQE policy decisions by rewrite op and outcome "
         "(applied|rejected|learned — docs/aqe.md)",
         [({"op": op, "outcome": outcome}, n)
          for (op, outcome), n in sorted(aqe_totals.items())]
         or [({}, 0)])
    )
    families.append(
        ("ballista_skew_partitions_total", "counter",
         "Partitions flagged by the skew monitor "
         "(rows > skew_ratio x stage median — the AQE split signal)",
         [({"class": c}, n) for c, n in sorted(skews.items())]
         or [({}, 0)])
    )
    with server._lock:
        overflow = server.obs_class_overflow
        n_classes = len(server._known_classes)
    families.append(
        ("ballista_query_classes", "gauge",
         "Distinct query-class labels in use (capped at "
         "max_query_classes; the tail aggregates under 'overflow')",
         [({}, n_classes)])
    )
    families.append(
        ("ballista_query_class_overflow_total", "counter",
         "Jobs classed 'overflow' because the query-class cardinality "
         "cap was reached (no-silent-caps accounting)",
         [({}, overflow)])
    )
    # cost accounting (docs/observability.md): per-query-class resource
    # rollup — the charging/fair-share substrate, scrapable
    with server._lock:
        class_cost = {
            c: dict(m) for c, m in server.obs_class_cost.items()
        }
    cost_samples = [
        ({"class": c, "resource": k}, v)
        for c in sorted(class_cost)
        for k, v in sorted(class_cost[c].items())
    ]
    families.append(
        ("ballista_job_cost_total", "counter",
         "Aggregated per-attempt resource cost by query class and "
         "resource dimension (wall/cpu/compile seconds, shuffle read/"
         "write, pushed, spill bytes) — failed and recomputed attempts "
         "included", cost_samples or [({}, 0)])
    )
    families.append(
        ("ballista_history_jobs", "gauge",
         "Jobs currently retained in the persistent query-history log "
         "(bounded by ballista.tpu.history_retention_jobs)",
         [({}, server.history.job_count())])
    )
    # serving fast path (docs/serving.md): result-cache effectiveness and
    # the orchestration-bypass count — the two fleet signals the
    # BENCH_SERVE artifact reports straight from this scrape
    cache = server.result_cache.stats()
    families.append(
        ("ballista_result_cache_events_total", "counter",
         "Result-cache lookups and maintenance by outcome (hit|miss|"
         "eviction|rejected_oversize — docs/serving.md)",
         [({"outcome": "hit"}, cache["hits"]),
          ({"outcome": "miss"}, cache["misses"]),
          ({"outcome": "eviction"}, cache["evictions"]),
          ({"outcome": "rejected_oversize"}, cache["rejected_oversize"])])
    )
    families.append(
        ("ballista_result_cache_entries", "gauge",
         "Committed results currently held by the plan-fingerprint "
         "result cache", [({}, cache["entries"])])
    )
    families.append(
        ("ballista_result_cache_bytes", "gauge",
         "Result-cache resident bytes vs its configured capacity",
         [({"kind": "used"}, cache["bytes"]),
          ({"kind": "capacity"}, cache["capacity_bytes"])])
    )
    with server._lock:
        bypass_total = server.obs_bypass_total
    families.append(
        ("ballista_bypass_jobs_total", "counter",
         "Jobs served through the single-stage orchestration bypass "
         "(no QueryStageScheduler state machine — docs/serving.md)",
         [({}, bypass_total)])
    )
    families.append(
        ("ballista_desired_executors", "gauge",
         "Composite autoscale pressure: executors the KEDA ExternalScaler "
         "currently asks for (pending tasks + queue-wait p90 vs target)",
         [({}, server.desired_executors())])
    )
    families.extend(_span_drop_families())
    families.extend(server.hists.families())
    families.extend(_reswitness_families())
    families.extend(_cache_witness_families())
    families.extend(_dur_witness_families())
    return families


def _span_drop_families() -> list[tuple]:
    from ballista_tpu_torch.obs import trace

    return [
        ("ballista_spans_dropped_total", "counter",
         "Spans evicted from the bounded trace stores (ring window, "
         "executor shipping outbox) — the no-silent-caps accounting",
         [({"buffer": k}, v) for k, v in sorted(trace.dropped().items())])
    ]


def executor_families() -> list[tuple]:
    """The executor-process metric families (build, prewarm, callable-cache
    and hint counters + the in-process trace ring size + live
    resources)."""
    from ballista_tpu_torch.executor.executor import compile_metrics
    from ballista_tpu_torch.obs import hist as obs_hist
    from ballista_tpu_torch.obs import trace

    counters = compile_metrics()
    families = [
        ("ballista_executor_compile", "gauge",
         "Kernel build seconds, prewarm, callable-cache and persisted-hint "
         "counters",
         [({"counter": sanitize_name(k)}, v)
          for k, v in sorted(counters.items())]),
        ("ballista_trace_ring_spans", "gauge",
         "Spans currently buffered in the in-process trace ring",
         [({}, trace.ring_size())]),
    ]
    families.extend(_span_drop_families())
    # process-local latency histograms (task-run, shuffle-fetch-wait);
    # the same observations also ship home as deltas on poll/heartbeat
    families.extend(obs_hist.REGISTRY.families())
    families.extend(_reswitness_families())
    families.extend(_cache_witness_families())
    return families


def _reswitness_families() -> list[tuple]:
    """Live resource counts when the runtime resource witness is on
    (BALLISTA_RESOURCE_WITNESS=1) — empty otherwise."""
    from ballista_tpu_torch.analysis import reswitness

    if not reswitness.enabled():
        return []
    counts: dict[str, int] = {}
    for rec in reswitness.live():
        counts[rec.get("kind", "?")] = counts.get(rec.get("kind", "?"), 0) + 1
    return [
        ("ballista_live_resources", "gauge",
         "Live witnessed resources by kind (analysis/reswitness.py)",
         [({"kind": k}, v) for k, v in sorted(counts.items())] or [({}, 0)])
    ]


def _cache_witness_families() -> list[tuple]:
    """Staleness-witness check outcomes when the cache witness is on
    (BALLISTA_CACHE_WITNESS=1) — empty otherwise. A scrape seeing any
    ``outcome="stale"`` sample has caught a coherence violation live."""
    from ballista_tpu_torch.analysis import stalewitness

    if not stalewitness.enabled():
        return []
    samples = [
        ({"cache": cache, "outcome": outcome}, n)
        for (cache, outcome), n in sorted(stalewitness.counters().items())
    ]
    return [
        ("ballista_cache_witness_checks_total", "counter",
         "Cache staleness witness checks by cache and outcome "
         "(analysis/stalewitness.py)",
         samples or [({}, 0)])
    ]


def _dur_witness_families() -> list[tuple]:
    """Durability-witness check outcomes when the durability witness is
    on (BALLISTA_DUR_WITNESS=1) — empty otherwise. A scrape seeing any
    ``outcome="divergent"`` sample has caught recovered state diverging
    from its declared durability class live."""
    from ballista_tpu_torch.analysis import durwitness

    if not durwitness.enabled():
        return []
    samples = [
        ({"field": field, "outcome": outcome}, n)
        for (field, outcome), n in sorted(durwitness.counters().items())
    ]
    return [
        ("ballista_dur_witness_checks_total", "counter",
         "Durability witness restart checks by declared state field and "
         "outcome (analysis/durwitness.py)",
         samples or [({}, 0)])
    ]


# ---------------------------------------------------------------------------
# tiny standalone metrics endpoint (executor daemons)
# ---------------------------------------------------------------------------


def start_metrics_server(render_fn, host: str = "0.0.0.0", port: int = 0):
    """Serve ``GET /api/metrics`` (and ``/metrics``) rendering
    ``render_fn() -> families``. Returns (httpd, bound_port); stop with
    :func:`stop_metrics_server` — the same shutdown+join+server_close
    discipline as the scheduler REST server (lifelint: the listening
    socket must close)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            path = self.path.split("?", 1)[0].rstrip("/")
            if path not in ("/api/metrics", "/metrics"):
                self.send_error(404)
                return
            try:
                body = render(render_fn()).encode()
            except Exception:  # noqa: BLE001 — a scrape must not crash
                log.exception("metrics render failed")
                self.send_error(500)
                return
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            log.debug("metrics: " + fmt, *args)

    httpd = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(
        target=httpd.serve_forever, daemon=True, name="executor-metrics"
    )
    httpd._serve_thread = t
    t.start()
    return httpd, httpd.server_address[1]


def stop_metrics_server(httpd) -> None:
    httpd.shutdown()
    t = getattr(httpd, "_serve_thread", None)
    if t is not None:
        t.join(timeout=5)
    httpd.server_close()
