"""Scheduler REST API + status UI.

ref ballista/rust/scheduler/src/api/{mod,handlers}.rs — ``GET /api/state``
returns the executor roster + uptime as JSON (handlers.rs:34-57); the
scheduler also serves a human status page (the reference ships a yew/WASM
UI under ballista/ui; here a single self-contained HTML page renders the
same state from ``/api/state``).

Implemented over the stdlib ThreadingHTTPServer — the REST tier is a thin
read-only view of :class:`SchedulerServer`, not a data path.

Port of ``ballista_tpu/scheduler/rest.py``, the same payloads and paths.
An executor's ``compile`` counters are the ones the port's executors ship
(``executor.executor.compile_metrics``): their nvcc build seconds, prewarm
progress (``prewarmed_signatures``, ``prewarm_seconds``,
``prewarm_failures``), the shared callable cache (``jit_cache_hits``,
``jit_cache_misses``) and the hint counters.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

log = logging.getLogger(__name__)

BALLISTA_VERSION = "0.6.0-tpu"

_UI_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ballista-tpu scheduler</title>
<style>
 :root { --ink:#1a1a2e; --mut:#6b7280; --line:#e5e7eb; --bg:#f8f9fb;
         --ok:#15803d; --run:#1d4ed8; --bad:#b91c1c; --pend:#92400e; }
 body { font-family: system-ui, sans-serif; margin: 0; color: var(--ink);
        background: var(--bg); }
 header { background: #111827; color: #f9fafb; padding: .8rem 1.5rem;
          display: flex; align-items: baseline; gap: 1rem; }
 header h1 { font-size: 1.1rem; margin: 0; }
 header .muted { color: #9ca3af; font-size: .8rem; }
 main { padding: 1rem 1.5rem 3rem; max-width: 72rem; margin: 0 auto; }
 .tiles { display: grid; grid-template-columns: repeat(auto-fit, minmax(9rem,1fr));
          gap: .8rem; margin: 1rem 0 1.5rem; }
 .tile { background: #fff; border: 1px solid var(--line); border-radius: .5rem;
         padding: .7rem .9rem; }
 .tile .v { font-size: 1.45rem; font-weight: 600; }
 .tile .l { color: var(--mut); font-size: .75rem; text-transform: uppercase;
            letter-spacing: .05em; }
 h2 { font-size: .95rem; margin: 1.4rem 0 .5rem; }
 table { border-collapse: collapse; width: 100%; background: #fff;
         border: 1px solid var(--line); border-radius: .5rem; overflow: hidden; }
 th, td { text-align: left; padding: .4rem .8rem;
          border-bottom: 1px solid var(--line); font-size: .85rem; }
 th { background: #f3f4f6; font-weight: 600; }
 tr:last-child td { border-bottom: none; }
 .muted { color: var(--mut); font-size: .85rem; }
 .pill { display: inline-block; border-radius: 999px; padding: .05rem .55rem;
         font-size: .72rem; font-weight: 600; }
 .pill.completed { background: #dcfce7; color: var(--ok); }
 .pill.running   { background: #dbeafe; color: var(--run); }
 .pill.failed    { background: #fee2e2; color: var(--bad); }
 .pill.queued, .pill.pending { background: #fef3c7; color: var(--pend); }
 .bar { background: var(--line); border-radius: 999px; height: .5rem;
        min-width: 7rem; overflow: hidden; }
 .bar > div { background: var(--run); height: 100%; }
 .bar.done > div { background: var(--ok); }
 details.job { margin: 0; }
 .stageplan { font-family: ui-monospace, monospace; font-size: .75rem;
              white-space: pre; overflow-x: auto; background: #f9fafb;
              border: 1px solid var(--line); border-radius: .35rem;
              padding: .5rem .7rem; margin: .3rem 0 .7rem; }
 .dag { font-size: .8rem; color: var(--mut); margin: .2rem 0 .4rem; }
 td.exp { cursor: pointer; color: var(--run); user-select: none; }
</style></head>
<body>
<header><h1>ballista-tpu scheduler</h1><div class="muted" id="meta"></div></header>
<main>
<div class="tiles">
 <div class="tile"><div class="v" id="t-exec">–</div><div class="l">executors alive</div></div>
 <div class="tile"><div class="v" id="t-slots">–</div><div class="l">slots free / total</div></div>
 <div class="tile"><div class="v" id="t-dev">–</div><div class="l">mesh devices</div></div>
 <div class="tile"><div class="v" id="t-running">–</div><div class="l">jobs running</div></div>
 <div class="tile"><div class="v" id="t-done">–</div><div class="l">jobs completed</div></div>
 <div class="tile"><div class="v" id="t-failed">–</div><div class="l">jobs failed</div></div>
</div>
<h2>Executors</h2>
<table id="executors"><thead><tr>
 <th>id</th><th>host</th><th>flight port</th><th>devices</th>
 <th>slots (free/total)</th><th>last seen</th>
</tr></thead><tbody></tbody></table>
<h2>Jobs</h2>
<table id="jobs"><thead><tr>
 <th></th><th>job id</th><th>status</th><th>stages</th><th>progress</th>
 <th>stage detail</th><th>error</th>
</tr></thead><tbody></tbody></table>
</main>
<script>
// textContent only — job errors echo user SQL fragments, never as HTML
function td(parent, text, cls) {
  const el = document.createElement('td');
  if (cls) el.className = cls;
  el.textContent = text;
  parent.appendChild(el);
  return el;
}
function pill(state) {
  const s = document.createElement('span');
  s.className = 'pill ' + state;
  s.textContent = state;
  return s;
}
const open = new Set();
async function expand(jobId, tr, ncols) {
  if (open.has(jobId)) { open.delete(jobId); tr.nextSibling?.remove(); return; }
  open.add(jobId);
  const r = await fetch('api/job/' + encodeURIComponent(jobId));
  if (!r.ok) return;
  const d = await r.json();
  const drow = document.createElement('tr');
  const cell = document.createElement('td');
  cell.colSpan = ncols;
  for (const st of d.stages) {
    const h = document.createElement('div');
    h.className = 'dag';
    h.textContent = `stage ${st.stage_id}` +
      (st.depends_on.length ? ` ⇐ depends on [${st.depends_on.join(', ')}]` : ' (leaf)') +
      (st.stage_id === d.final_stage_id ? '  · final' : '');
    cell.appendChild(h);
    const pre = document.createElement('div');
    pre.className = 'stageplan';
    pre.textContent = st.plan;
    cell.appendChild(pre);
  }
  drow.appendChild(cell);
  tr.after(drow);
}
async function refresh() {
  const r = await fetch('api/state'); const s = await r.json();
  document.getElementById('meta').textContent =
    `v${s.version} · up ${Math.round(s.uptime_seconds)}s · policy ${s.policy}`;
  let free = 0, total = 0, dev = 0;
  const ex = document.querySelector('#executors tbody'); ex.innerHTML = '';
  for (const e of s.executors) {
    free += e.available_task_slots ?? 0; total += e.total_task_slots ?? 0;
    dev += e.n_devices ?? 1;
    const tr = document.createElement('tr');
    td(tr, e.id); td(tr, e.host); td(tr, e.port);
    td(tr, e.n_devices ?? 1);
    td(tr, `${e.available_task_slots ?? '-'} / ${e.total_task_slots ?? '-'}`);
    td(tr, e.last_seen_seconds_ago == null ? 'never'
        : e.last_seen_seconds_ago.toFixed(1) + 's ago');
    ex.appendChild(tr);
  }
  document.getElementById('t-exec').textContent = s.executors.length;
  document.getElementById('t-slots').textContent = `${free} / ${total}`;
  document.getElementById('t-dev').textContent = dev;
  const counts = {running: 0, completed: 0, failed: 0};
  const jb = document.querySelector('#jobs tbody'); jb.innerHTML = '';
  for (const j of s.jobs) {
    counts[j.status] = (counts[j.status] ?? 0) + 1;
    const stages = j.stages || [];
    let done = 0, total = 0;
    const detail = stages.map(st => {
      done += st.tasks.completed; total += st.n_tasks;
      return `s${st.stage_id}:${st.state}` +
        (st.state === 'running'
          ? ` (${st.tasks.completed}/${st.n_tasks})` : '');
    }).join('  ');
    const tr = document.createElement('tr');
    const e = td(tr, open.has(j.job_id) ? '▾' : '▸', 'exp');
    e.onclick = () => expand(j.job_id, tr, 7).then(refreshCaret);
    function refreshCaret() { e.textContent = open.has(j.job_id) ? '▾' : '▸'; }
    td(tr, j.job_id);
    td(tr, '').appendChild(pill(j.status));
    td(tr, j.n_stages);
    // finished jobs have their stage bookkeeping torn down — no counts
    const pc = td(tr, '');
    if (j.status === 'completed' || (total > 0)) {
      const bar = document.createElement('div');
      bar.className = 'bar' + (j.status === 'completed' ? ' done' : '');
      const fill = document.createElement('div');
      fill.style.width = (j.status === 'completed' ? 100
        : total ? Math.round(100 * done / total) : 0) + '%';
      bar.appendChild(fill); pc.appendChild(bar);
    } else pc.textContent = '-';
    td(tr, detail);
    td(tr, j.error || '');
    jb.appendChild(tr);
    if (open.has(j.job_id)) { open.delete(j.job_id); expand(j.job_id, tr, 7); }
  }
  document.getElementById('t-running').textContent = counts.running ?? 0;
  document.getElementById('t-done').textContent = counts.completed ?? 0;
  document.getElementById('t-failed').textContent = counts.failed ?? 0;
}
refresh(); setInterval(refresh, 2000);
</script>
</body></html>
"""


def scheduler_state(server) -> dict:
    """The /api/state payload (ref handlers.rs:34-57, extended with slot
    and job detail the UI renders)."""
    now = time.time()
    executors = []
    for em in server.executor_manager.all_executors():
        data = server.executor_manager.get_executor_data(em.id)
        seen = server.executor_manager.last_seen(em.id)
        executors.append(
            {
                "id": em.id,
                "host": em.host,
                "port": em.port,
                "grpc_port": em.grpc_port,
                "n_devices": em.specification.n_devices or 1,
                "total_task_slots": data.total_task_slots if data else None,
                "available_task_slots": (
                    data.available_task_slots if data else None
                ),
                "last_seen_seconds_ago": (
                    round(now - seen, 3) if seen is not None else None
                ),
                # REST-hardening alias (docs/observability.md): the
                # monitoring-friendly name dashboards expect
                "last_heartbeat_age_s": (
                    round(now - seen, 3) if seen is not None else None
                ),
                # latest cold-start counters (nvcc build seconds, prewarm
                # progress, the shared callable cache, hints) the executor
                # shipped on its heartbeat/poll
                "compile": server.executor_manager.get_executor_metrics(
                    em.id
                ),
            }
        )
    with server._lock:
        job_snapshot = list(server.jobs.values())
    jobs = [
        {
            "job_id": j.job_id,
            "status": j.status,
            "n_stages": len(j.stages),
            "error": j.error,
            # fault-tolerance visibility: bounded task retries + lost-
            # shuffle recompute rounds (both 0 on a clean run; chaos tests
            # assert on these)
            "retries": j.total_retries,
            "recomputes": j.total_recomputes,
            "rewrites": j.total_rewrites,
            # per-stage DAG state + task counts (the reference UI's job
            # detail view; ref ballista/ui job/stage tables)
            "stages": server.stage_manager.job_stage_summary(j.job_id),
        }
        for j in job_snapshot
    ]
    return {
        "executors": executors,
        "jobs": jobs,
        "started": int(server.start_time * 1000),
        "uptime_seconds": now - server.start_time,
        # monitoring-friendly alias (docs/observability.md)
        "uptime_s": round(now - server.start_time, 3),
        "policy": server.policy.value,
        "version": BALLISTA_VERSION,
    }


def job_detail(server, job_id: str) -> dict | None:
    """Per-job stage DAG detail for the UI's expandable rows: stage
    dependency edges + the physical plan display of every stage (the
    reference UI's query-detail view, ballista/ui stage tables)."""
    with server._lock:
        job = server.jobs.get(job_id)
        if job is None:
            return None
        stages = []
        for sid in sorted(job.stages):
            deps = sorted(
                child
                for child, parents in job.dependencies.items()
                if sid in parents
            )
            stages.append(
                {
                    "stage_id": sid,
                    "depends_on": deps,
                    "plan": job.stages[sid].plan.display(),
                }
            )
        out = {
            "job_id": job_id,
            "status": job.status,
            "error": job.error,
            "final_stage_id": job.final_stage_id,
            "stages": stages,
            "retries": job.total_retries,
            "recomputes": job.total_recomputes,
            # certified-rewrite visibility (docs/analysis.md): accepted
            # template swaps + certificate rejections
            "rewrites": job.total_rewrites,
            "rewrite_rejects": job.total_rewrite_rejects,
            # per-rewrite decision log (docs/aqe.md): op, touched stage
            # ids, outcome, and the failing certificate clause on a
            # reject — the "why did this stage change shape" answer
            "rewrite_log": [dict(r) for r in job.rewrite_log],
            # AQE policy decisions layered over the rewrites: source
            # (reactive/learned) + before/after stats per decision
            "aqe": [dict(d) for d in job.aqe_decisions],
            "trace_id": job.trace_id,
            # fleet observability (docs/observability.md): the label
            # every latency series for this job aggregates under, plus
            # the skew monitor's flagged partitions (the AQE split input)
            "query_class": job.query_class,
            "skew": [
                {"stage_id": s, "partition": p}
                for s, p in sorted(job.skew_flags)
            ],
            # aggregated resource cost (docs/observability.md): every
            # attempt's shipped cost vector summed — the same numbers
            # the history record persists
            "cost": job.cost.to_dict() if job.cost is not None else {},
        }
    # stats/trace aggregation takes the server lock itself — outside the
    # block above (the lock is reentrant, but the narrower the section
    # the better)
    stats = server.job_stats(job_id)
    if stats is not None:
        # per-stage / per-(stage,partition) rows+bytes+attempts plus the
        # shipped per-operator metrics (docs/observability.md) — live
        # while running, from the completion snapshot afterwards
        out.update(stats)
    trace = server.job_trace(job_id)
    if trace:
        out["spans"] = trace
    return out


def job_timeline(server, job_id: str) -> dict | None:
    """``GET /api/job/<id>/timeline``: the per-task Gantt view
    (docs/observability.md) — one row per (stage, partition) with the
    current attempt's wall-clock window, executor, attempt count, and
    the straggler/skew flags. Reconstructed from the stage bookkeeping
    while the job runs and from the completion snapshot afterwards;
    running tasks additionally get a LIVE straggler projection (now -
    start already beyond the flag threshold) so a wedged task shows up
    before it finishes. None for unknown jobs."""
    with server._lock:
        job = server.jobs.get(job_id)
        if job is None:
            return None
        skew = set(job.skew_flags)
        # stages whose template an accepted certified rewrite swapped
        # (docs/aqe.md): the Gantt view marks their rows so a mid-job
        # partition-count change is explained, not mysterious
        rewritten = set(job.rewritten_stages)
        # push-shuffle data-plane counters per (stage, partition) from
        # the shipped per-operator metrics (docs/shuffle.md): how many
        # bytes each task committed in memory, spilled under window
        # pressure, or made consumers fall back to the pull plane
        push_by_task: dict = {}
        for (sid, part), records in job.op_metrics.items():
            agg = {"pushed_bytes": 0, "push_spill_bytes": 0,
                   "push_fallbacks": 0}
            for r in records:
                for k in agg:
                    v = r.get("counters", {}).get(k)
                    if isinstance(v, (int, float)):
                        agg[k] += int(v)
            push_by_task[(sid, part)] = agg
    stages = job.stage_stats
    if stages is None:
        stages = server.stage_manager.job_stage_detail(job_id)
    from ballista_tpu_torch.scheduler.stage_manager import straggler_stats

    cfg = server._session_config(job.session_id)
    factor = cfg.straggler_factor()
    min_s = cfg.straggler_min_s()
    now = time.time()
    tasks = []
    for st in stages:
        durations = [
            t["ended_s"] - t["started_s"]
            for t in st["tasks"]
            if t["state"] == "completed" and t["started_s"] and t["ended_s"]
        ]
        # the SAME threshold the committing monitor uses — the live
        # projection must agree with the counter about the same task
        stats = straggler_stats(durations, factor, min_s)
        threshold = stats[0] if stats is not None else None
        for t in st["tasks"]:
            start, end = t["started_s"], t["ended_s"]
            dur = (end - start) if (start and end) else (
                (now - start) if start else 0.0
            )
            straggler = bool(t.get("straggler"))
            if (
                not straggler
                and threshold is not None
                and t["state"] == "running"
                and start
                and now - start > threshold
            ):
                straggler = True  # live projection, not yet committed
            push = push_by_task.get(
                (st["stage_id"], t["partition"]),
                {"pushed_bytes": 0, "push_spill_bytes": 0,
                 "push_fallbacks": 0},
            )
            tasks.append(
                {
                    "stage_id": st["stage_id"],
                    "partition": t["partition"],
                    "state": t["state"],
                    "executor_id": t["executor_id"],
                    "attempts": t["attempts"],
                    "start_s": start,
                    "end_s": end,
                    "duration_s": round(max(0.0, dur), 6),
                    "straggler": straggler,
                    "skewed": (st["stage_id"], t["partition"]) in skew,
                    # this stage's template was swapped by an accepted
                    # certified rewrite (AQE or manual) — docs/aqe.md
                    "rewritten": st["stage_id"] in rewritten,
                    # push data-plane visibility (docs/shuffle.md)
                    "pushed_bytes": push["pushed_bytes"],
                    "push_spill_bytes": push["push_spill_bytes"],
                    "push_fallbacks": push["push_fallbacks"],
                }
            )
    return {
        "job_id": job_id,
        "status": job.status,
        "query_class": job.query_class,
        "submitted_s": round(job.submitted_s, 6),
        "first_assign_s": round(job.first_assign_s, 6),
        "tasks": tasks,
    }


def start_rest_server(server, host: str = "0.0.0.0", port: int = 0):
    """Serve /api/state, /api/job/<id> + the status page. Returns
    (httpd, bound_port)."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, status: int, body: bytes, ctype: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            if path in ("/api/state", "/state"):
                body = json.dumps(scheduler_state(server)).encode()
                ctype = "application/json"
            elif path in ("/api/history", "/history"):
                # the persistent query log (docs/observability.md):
                # ?kind=queries|task_attempts|executors, ?limit=N
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                kind = (q.get("kind") or ["queries"])[0]
                try:
                    limit = int((q.get("limit") or ["0"])[0])
                except ValueError:
                    limit = 0
                try:
                    rows = server.history_payload(kind, limit)
                except ValueError:
                    self._reply(
                        400,
                        json.dumps(
                            {"error": "unknown kind", "kind": kind}
                        ).encode(),
                        "application/json",
                    )
                    return
                body = json.dumps({"kind": kind, "rows": rows}).encode()
                ctype = "application/json"
            elif path in ("/api/metrics", "/metrics"):
                # the scrapeable metrics plane (docs/observability.md):
                # Prometheus text exposition of scheduler + shipped
                # executor counters. Guarded like the executor-side
                # endpoint: a scrape racing executor expiry must get a
                # 500, not an aborted connection.
                from ballista_tpu_torch.obs import prometheus as prom

                try:
                    body = prom.render(
                        prom.scheduler_families(server)
                    ).encode()
                except Exception:  # noqa: BLE001
                    log.exception("metrics render failed")
                    self._reply(
                        500,
                        json.dumps({"error": "metrics render failed"}).encode(),
                        "application/json",
                    )
                    return
                ctype = prom.CONTENT_TYPE
            elif path.startswith("/api/job/"):
                from urllib.parse import unquote

                tail = unquote(path[len("/api/job/"):])
                if tail.endswith("/timeline"):
                    # per-task Gantt view (docs/observability.md)
                    job_id = tail[: -len("/timeline")]
                    detail = job_timeline(server, job_id)
                else:
                    job_id = tail
                    detail = job_detail(server, job_id)
                if detail is None:
                    # REST hardening: a proper 404 with a JSON body (the
                    # stdlib send_error serves an HTML error page, which
                    # API clients then fail to parse on top of the 404)
                    self._reply(
                        404,
                        json.dumps(
                            {"error": "unknown job", "job_id": job_id}
                        ).encode(),
                        "application/json",
                    )
                    return
                body = json.dumps(detail).encode()
                ctype = "application/json"
            elif path == "/":
                body = _UI_PAGE.encode()
                ctype = "text/html; charset=utf-8"
            else:
                self._reply(
                    404,
                    json.dumps({"error": "not found", "path": path}).encode(),
                    "application/json",
                )
                return
            self._reply(200, body, ctype)

        def log_message(self, fmt, *args):
            log.debug("rest: " + fmt, *args)

    httpd = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True, name="rest")
    # the serve thread rides on the httpd so stop_rest_server can join it
    # (a bare .shutdown() stopped serve_forever but left the LISTENING
    # SOCKET open and the thread unjoined — lifelint leaked-resource)
    httpd._serve_thread = t
    t.start()
    return httpd, httpd.server_address[1]


def stop_rest_server(httpd) -> None:
    """Full REST teardown: stop serve_forever, join the serve thread, and
    CLOSE the listening socket (``shutdown()`` alone leaks it until
    process exit — repeated start/stop cycles would pile up bound fds)."""
    httpd.shutdown()
    t = getattr(httpd, "_serve_thread", None)
    if t is not None:
        t.join(timeout=5)
    httpd.server_close()
