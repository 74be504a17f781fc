"""The replica's stdlib-only HTTP/JSON front door (docs/SERVE.md).
A copy of ``horovod_tpu/serve/server.py`` whose documents add one field,
``device``: where the replica's forward runs (``"cuda:0"``, ``"cpu"``).
Readers of the reference render an absent field as '-' and ignore
unknown ones, so either side's clients and supervisors read the other's
replicas.

Same ThreadingHTTPServer discipline as the metrics plane
(``_metrics.py``): daemon handler threads, ``log_message`` suppressed,
and NOTHING a request does may kill the replica — every handler error
becomes a cause-named JSON error response. The handler threads only
park on ticket events; the forward pass runs in the replica's main
thread (the batch loop), so the server keeps answering health checks
and admitting requests while a batch is on the device.

Routes:

* ``POST /infer``  — ``{"id": ..., "x": [...]}`` -> ``{"y": [...],
  "model_step": N, "weights_crc": "...", "replica": W, "batch": B}``;
  errors are ``{"error": msg, "cause": slug}`` with 503 for
  re-queueable causes (draining/overload — the client retries a
  surviving replica) and 400/500 for request-terminal ones.
* ``GET /healthz`` — liveness, drain posture and the device.
* ``GET /serve``   — the per-replica stats document (the supervisor
  aggregates these; ``hvd-top --serve`` renders the aggregate).
* ``GET /metrics`` — Prometheus text exposition of the serve registry.
"""

import json
import re
import threading
import time

from . import jsonfloats

from .batcher import QueueFull
from .metrics import render_prometheus

# Re-queueable causes answer 503: "try another replica, promptly".
_RETRYABLE = {"draining", "overload"}


class ReplicaContext:
    """What the front door needs to see of the replica: the batcher,
    the metrics registry, and the (lock-guarded) serving-weights
    identity. ``replica.py`` owns the mutation side."""

    def __init__(self, batcher, metrics, worker_id=0,
                 request_deadline=10.0, device=None):
        self.batcher = batcher
        self.metrics = metrics
        self.worker_id = int(worker_id)
        self.device = None if device is None else str(device)
        self.request_deadline = float(request_deadline)
        self._lock = threading.Lock()
        self._step = -1
        self._crc = None
        self._draining = False
        self.started = time.monotonic()
        # set by the replica: the last swap's stages and the batch
        # loop's longest gap around it (``Replica.swap_profile``)
        self.swap_profile_fn = None

    # -- weights identity (set by replica.py under its flip lock) ------
    def set_weights(self, step, crc):
        with self._lock:
            self._step, self._crc = int(step), crc

    def weights(self):
        with self._lock:
            return self._step, self._crc

    def begin_drain(self):
        with self._lock:
            self._draining = True

    @property
    def draining(self):
        with self._lock:
            return self._draining

    def view(self):
        """The /serve per-replica document. Every field rides the same
        mixed-version tolerance contract as the summary wire: readers
        render '-' for anything absent, so fields only ever get ADDED
        here."""
        snap = self.metrics.snapshot()
        p50, p99 = self.metrics.latency_quantiles()
        step, crc = self.weights()
        c = snap["counters"]
        return {
            "state": "draining" if self.draining else "serving",
            "replica": self.worker_id,
            "device": self.device,
            "uptime_seconds": time.monotonic() - self.started,
            "model_step": step,
            "weights_crc": crc,
            "queue_depth": snap["gauges"]["serve_queue_depth"],
            "inflight": snap["gauges"]["serve_inflight"],
            "requests_total": c["serve_requests_total"],
            "responses_total": c["serve_responses_total"],
            "batches_total": c["serve_batches_total"],
            "rejects_total": c["serve_rejects_total"],
            "errors_total": c["serve_errors_total"],
            "cancelled_total": c["serve_cancelled_total"],
            "frame_corrupt_total": c["serve_frame_corrupt_total"],
            "swaps_total": c["serve_swaps_total"],
            "swap_rejects_total": c["serve_swap_rejects_total"],
            "swap_aborts_total": c["serve_swap_aborts_total"],
            "p50_ms": None if p50 is None else round(p50 * 1e3, 3),
            "p99_ms": None if p99 is None else round(p99 * 1e3, 3),
            "swap_profile": (self.swap_profile_fn()
                             if self.swap_profile_fn else None),
        }


# The body every client of the port and of the reference sends
# (json.dumps({"id": rid, "x": [...]})): its numbers are read outside the
# interpreter's lock; any other body goes through json.loads.
_REQUEST = re.compile(rb'\{"id": "([^"\\\x00-\x1f]*)", "x": \[([^\[\]]*)\]\}\Z')


def _fast_request(body):
    """(id, x as float64) of a body in the clients' own form, else
    None."""
    m = _REQUEST.match(body)
    if m is None:
        return None
    try:
        rid = m.group(1).decode("utf-8")
    except UnicodeDecodeError:
        return None
    x = jsonfloats.loads(m.group(2))
    return None if x is None else (rid, x)


def _make_handler(ctx):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):
            path = self.path.split("?")[0].rstrip("/") or "/"
            try:
                if path == "/healthz":
                    self._json(200, {"ok": True,
                                     "draining": ctx.draining,
                                     "replica": ctx.worker_id,
                                     "device": ctx.device})
                elif path == "/serve":
                    self._json(200, ctx.view())
                elif path in ("/", "/metrics"):
                    self._reply(200, render_prometheus(ctx.metrics),
                                "text/plain; version=0.0.4; "
                                "charset=utf-8")
                else:
                    self._json(404, {"error": "not found",
                                     "cause": "not-found"})
            except Exception as e:  # a scrape must never kill serving
                self._best_effort_error(e)

        def do_POST(self):
            path = self.path.split("?")[0].rstrip("/")
            if path != "/infer":
                self._json(404, {"error": "not found",
                                 "cause": "not-found"})
                return
            try:
                self._infer()
            except Exception as e:
                self._best_effort_error(e)

        def _infer(self):
            if ctx.draining:
                # Prompt, cause-named, re-queueable: the client takes
                # this to a surviving replica (never silently dropped).
                ctx.metrics.inc("serve_rejects_total")
                self._json(503, {"error": "replica draining",
                                 "cause": "draining"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                fast = _fast_request(body)
                if fast is None:
                    doc = json.loads(body.decode("utf-8"))
                    x = doc["x"]
                    rid = str(doc.get("id", ""))
                else:
                    rid, x = fast
            except (ValueError, KeyError, UnicodeDecodeError) as e:
                self._json(400, {"error": "bad request: %s" % e,
                                 "cause": "bad-request"})
                return
            try:
                ticket = ctx.batcher.submit(rid, x)
            except QueueFull as e:
                self._json(503, {"error": str(e), "cause": "overload"})
                return
            except (TypeError, ValueError) as e:
                self._json(400, {"error": "bad input tensor: %s" % e,
                                 "cause": "bad-request"})
                return
            if not ticket.event.wait(ctx.request_deadline):
                # Mark the ticket abandoned so the batch loop drops it
                # instead of computing an answer nobody is waiting for
                # (expired requests must not keep amplifying overload).
                ticket.cancel()
                ctx.metrics.inc("serve_errors_total")
                self._json(504, {"error": "request deadline (%.1fs) "
                                          "expired in the batch queue"
                                          % ctx.request_deadline,
                                 "cause": "deadline"})
                return
            if ticket.error is not None:
                code = 503 if ticket.cause in _RETRYABLE else 500
                self._json(code, {"error": ticket.error,
                                  "cause": ticket.cause})
                return
            # The batch loop stamped the EXACT weights identity the
            # forward used; ctx.weights() is only the startup fallback.
            step, crc = ctx.weights()
            if ticket.weights_crc is not None:
                step, crc = ticket.model_step, ticket.weights_crc
            # json.dumps of the same document, the row's numbers written
            # outside the interpreter's lock (jsonfloats)
            self._reply(200, '{"id": %s, "y": %s, "model_step": %s, '
                        '"weights_crc": %s, "replica": %s}' % (
                            json.dumps(rid), jsonfloats.dumps(ticket.response),
                            json.dumps(step), json.dumps(crc),
                            json.dumps(ctx.worker_id)),
                        "application/json")

        def _best_effort_error(self, e):
            try:
                self._json(500, {"error": "internal: %s" % e,
                                 "cause": "internal"})
            except Exception:
                pass  # client already gone; the replica serves on

        def _json(self, code, doc):
            self._reply(code, json.dumps(doc), "application/json")

        def _reply(self, code, body, ctype):
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):
            pass  # request logs ride the metrics plane, not stderr

    return Handler


def start_front_door(port, ctx):
    """Binds the replica's HTTP server; returns (httpd, actual_port).
    Port 0 binds ephemeral (tests)."""
    from http.server import ThreadingHTTPServer

    class FrontDoor(ThreadingHTTPServer):
        # Each request is a new connection. socketserver's listen backlog
        # of 5 overflows in a burst of them, and a dropped SYN is sent
        # again only after a second.
        request_queue_size = 1024

    httpd = FrontDoor(("0.0.0.0", port), _make_handler(ctx))
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever,
                              name="hvd-serve-http", daemon=True)
    thread.start()
    return httpd, httpd.server_address[1]
