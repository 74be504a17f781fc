"""fleet_* metrics + the controller's HTTP plane (docs/FLEET.md): a copy
of ``horovod_tpu/fleet/metrics.py`` for the port.

The fleet controller is a supervisor process — it never calls
``hvd.init()`` — so its registry is a small Python mirror of the native
one (``native/metrics.h``): monotonic counters, gauges, and fixed-bucket
histograms, rendered with the SAME Prometheus renderer the worker
endpoints use (``horovod_tpu_torch/_metrics.py``), so one scrape config covers
workers and controller alike (families are ``hvdtpu_fleet_*``).

The HTTP endpoint serves:

* ``/metrics`` — Prometheus text exposition of the fleet registry,
* ``/fleet``   — the cross-job JSON view ``hvd-top --fleet`` polls
  (jobs with their states/sizes/lineage, hosts by state, counters).

Thread model: counters/gauges are plain numbers mutated under one lock
(the controller tick is the only writer; scrapes are read-only
snapshots) — no atomics needed at controller request rates.
"""

import json
import threading

# One histogram ladder serves both drain and restore latencies: sub-
# second (an idle commit loop notices the request immediately) up to
# minutes (restore waits for capacity to return).
_LATENCY_BOUNDS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                   120.0, 300.0, 600.0)

COUNTERS = (
    "fleet_admissions_total",         # jobs granted their initial gang
    "fleet_admission_retries_total",  # gang attempts that could not fit
    "fleet_drains_requested_total",   # drain requests the controller sent
    "fleet_preemptions_total",        # whole-job drains completed
    "fleet_shrinks_total",            # partial (subset-victim) drains
    "fleet_grows_total",              # slots leased back to a shrunk job
    "fleet_restores_total",           # preempted jobs re-admitted
    "fleet_job_completions_total",
    "fleet_job_failures_total",       # permanent (restart budget spent)
    "fleet_job_restarts_total",       # controller-level re-admissions
    "fleet_kills_injected_total",     # chaos schedule SIGKILLs
    "fleet_preempts_injected_total",  # chaos schedule forced preemptions
    "fleet_oversubscription_refusals_total",
    "fleet_occupancy_violations_total",  # should stay 0 forever
)

GAUGES = (
    "fleet_jobs_pending", "fleet_jobs_running", "fleet_jobs_draining",
    "fleet_jobs_preempted", "fleet_jobs_done", "fleet_jobs_failed",
    "fleet_hosts_free", "fleet_hosts_leased", "fleet_hosts_blacklisted",
    "fleet_slots_free", "fleet_slots_leased",
)

HISTOGRAMS = ("fleet_drain_seconds", "fleet_restore_seconds")


class _Histogram:
    """Fixed-bucket histogram, snapshot-compatible with the native
    registry's JSON shape (bounds / counts / sum / count)."""

    def __init__(self, bounds=_LATENCY_BOUNDS):
        self.bounds = list(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v):
        i = 0
        while i < len(self.bounds) and v > self.bounds[i]:
            i += 1
        self.counts[i] += 1
        self.sum += v
        self.count += 1

    def snapshot(self):
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


class FleetMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {name: 0 for name in COUNTERS}
        self._gauges = {name: 0 for name in GAUGES}
        self._histograms = {name: _Histogram() for name in HISTOGRAMS}

    def inc(self, name, n=1):
        with self._lock:
            self._counters[name] += n

    def get(self, name):
        with self._lock:
            return self._counters.get(name, self._gauges.get(name, 0))

    def set_gauge(self, name, v):
        with self._lock:
            self._gauges[name] = v

    def observe(self, name, v):
        with self._lock:
            self._histograms[name].observe(v)

    def snapshot(self):
        """Native-registry-shaped dict, accepted verbatim by
        ``_metrics.render_prometheus``."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {n: h.snapshot()
                               for n, h in self._histograms.items()},
            }


def render_prometheus(metrics):
    from horovod_tpu_torch._metrics import render_prometheus as _render
    return _render(metrics.snapshot())


def _make_handler(metrics, view_fn):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?")[0].rstrip("/") or "/"
            try:
                if path in ("/", "/metrics"):
                    self._reply(200, render_prometheus(metrics),
                                "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/fleet":
                    self._reply(200, json.dumps(view_fn()),
                                "application/json")
                else:
                    self._reply(404, "not found\n", "text/plain")
            except Exception as e:  # a scrape must never kill the fleet
                self._reply(500, "error: %s\n" % e, "text/plain")

        def _reply(self, code, body, ctype):
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):
            pass  # scrapes must not spam controller stderr

    return Handler


def start_server(port, metrics, view_fn):
    """Starts the controller's HTTP endpoint; returns (server, port).
    ``port`` 0 binds an ephemeral port (tests)."""
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("0.0.0.0", port),
                                _make_handler(metrics, view_fn))
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever,
                              name="hvd-fleet-http", daemon=True)
    thread.start()
    return httpd, httpd.server_address[1]
