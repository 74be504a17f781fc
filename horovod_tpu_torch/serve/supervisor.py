"""The serve-pool supervisor: ``python -m horovod_tpu_torch.serve``
(docs/SERVE.md), the port's ``hvd-serve``. A copy of
``horovod_tpu/serve/supervisor.py`` over the port's elastic driver; it
imports no torch (only the replicas do).

Reuses the ELASTIC DRIVER as the replica process manager — a serve
pool is "an elastic job whose workers never rendezvous": the driver
spawns ``python -m horovod_tpu_torch.serve.replica`` per slot, respawns
SIGKILLed replicas (with the host-blacklist cooldown), and runs the
same graceful-drain protocol (drain record in the rendezvous KV,
``EXIT_DRAINED`` keeps a host off the blacklist). Replica count is
steered entirely through :meth:`ElasticDriver.resize` — the driver
auto-grows toward the ceiling whenever discovery shows capacity, so
autoscaling is "move the ceiling" and nothing else.

The supervisor adds the pool-level view: an aggregated ``/serve``
status endpoint (what ``hvd-top --serve`` renders), a queue-pressure
autoscaler, and endpoint discovery (each replica listens on
``port_base + worker_id`` on the host the driver placed it on, read
from the driver's worker records — multi-host ``-H`` inventories
resolve to reachable endpoints).
"""

import argparse
import json
import os
import sys
import threading
import time
import urllib.request

from horovod_tpu_torch.elastic.discovery import FixedHosts
from horovod_tpu_torch.elastic.driver import ElasticDriver
from horovod_tpu_torch.run import util


def _fetch_json(url, timeout=1.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


class ServeSupervisor:
    def __init__(self, command, hosts, min_replicas=1, max_replicas=1,
                 np_initial=None, port_base=9500, env=None,
                 start_timeout=2.0, drain_grace=None,
                 scale_up_queue=4.0, scale_down_idle=10.0,
                 autoscale_interval=0.5, verbose=False):
        self.port_base = int(port_base)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_queue = float(scale_up_queue)
        self.scale_down_idle = float(scale_down_idle)
        self.autoscale_interval = float(autoscale_interval)
        self.verbose = verbose
        self.started = time.monotonic()
        self.scale_events = []   # [{"t", "from", "to", "reason"}]
        self._idle_since = None
        self._stop = threading.Event()
        np0 = int(np_initial if np_initial is not None
                  else self.min_replicas)
        # start_timeout is SHORT by design: serve replicas never
        # rendezvous, so a size>1 generation only "resolves" by
        # stalling — a long timeout would freeze the growth gate. It is
        # no boot deadline: a replica importing torch and making its
        # CUDA context takes longer, and nothing waits on it here.
        self.driver = ElasticDriver(
            command, FixedHosts(hosts),
            min_np=1, max_np=np0, np_initial=np0,
            start_timeout=start_timeout, verbose=verbose, env=env,
            drain_grace=drain_grace, placement="spread")

    def _log(self, msg):
        if self.verbose:
            sys.stderr.write("[hvd-serve] %s\n" % msg)
            sys.stderr.flush()

    # -- pool introspection -------------------------------------------
    def _replica_addrs(self):
        """[(worker id, "host:port")] from the driver's worker records
        — the HOST each replica actually landed on (-H accepts
        multi-host inventories), with local spellings normalized to
        the loopback the replica's listener is certainly reachable
        on."""
        addrs = []
        for wid, host in sorted(self.driver.worker_hosts().items()):
            if util.is_local_host(host):
                host = "127.0.0.1"
            addrs.append((wid, "%s:%d" % (host, self.port_base + wid)))
        return addrs

    def endpoints(self):
        return [addr for _, addr in self._replica_addrs()]

    def replica_views(self, timeout=1.0):
        """Per-replica /serve documents for every reachable replica."""
        views = []
        for _, addr in self._replica_addrs():
            try:
                views.append(_fetch_json("http://%s/serve" % addr,
                                         timeout=timeout))
            except Exception:
                continue  # booting or dying; the pool view skips it
        return views

    def view(self):
        """The aggregated /serve document (the ``hvd-top --serve``
        wire). Counters SUM across replicas; latency quantiles take the
        pool-pessimal (max) replica; every field is add-only under the
        mixed-version tolerance contract."""
        views = self.replica_views()
        agg = {
            "kind": "serve-pool",
            "uptime_seconds": time.monotonic() - self.started,
            "replicas": len(self.driver.live_workers()),
            "replicas_reporting": len(views),
            "replicas_min": self.min_replicas,
            "replicas_max": self.max_replicas,
            "scale_events": len(self.scale_events),
            "endpoints": self.endpoints(),
        }
        for field in ("requests_total", "responses_total",
                      "batches_total", "rejects_total", "errors_total",
                      "cancelled_total",
                      "frame_corrupt_total", "swaps_total",
                      "swap_rejects_total", "swap_aborts_total",
                      "queue_depth", "inflight"):
            agg[field] = sum(int(v.get(field) or 0) for v in views)
        for field in ("p50_ms", "p99_ms"):
            vals = [v[field] for v in views
                    if v.get(field) is not None]
            agg[field] = max(vals) if vals else None
        steps = [v.get("model_step") for v in views
                 if v.get("model_step") is not None]
        agg["model_step"] = max(steps) if steps else None
        agg["model_steps"] = sorted(set(steps))
        agg["draining"] = sum(1 for v in views
                              if v.get("state") == "draining")
        agg["per_replica"] = views
        return agg

    # -- autoscaling --------------------------------------------------
    def _record_scale(self, old, new, reason):
        self.scale_events.append({
            "t": round(time.monotonic() - self.started, 3),
            "from": old, "to": new, "reason": reason})
        self._log("autoscale %d -> %d (%s)" % (old, new, reason))

    def autoscale_once(self):
        """One autoscaler tick: queue pressure raises the replica
        ceiling one step; a sustained-idle pool lowers it by draining
        the highest replica (the driver does not regrow past the
        lowered ceiling). Returns the ceiling delta (-1/0/+1)."""
        views = self.replica_views(timeout=0.5)
        live = len(self.driver.live_workers())
        if not views or live == 0:
            return 0
        depth = sum(int(v.get("queue_depth") or 0) for v in views)
        pressure = depth / max(1, len(views))
        if pressure >= self.scale_up_queue and live < self.max_replicas:
            self._idle_since = None
            self.driver.resize(live + 1)
            self._record_scale(live, live + 1,
                               "queue pressure %.1f/replica" % pressure)
            return 1
        if depth == 0 and live > self.min_replicas:
            now = time.monotonic()
            if self._idle_since is None:
                self._idle_since = now
            elif now - self._idle_since >= self.scale_down_idle:
                self._idle_since = None
                victim = max(self.driver.live_workers())
                self.driver.resize(live - 1)
                self.driver.request_drain([victim])
                self._record_scale(live, live - 1,
                                   "idle %.0fs" % self.scale_down_idle)
                return -1
        else:
            self._idle_since = None
        return 0

    def _autoscale_loop(self):
        while not self._stop.wait(self.autoscale_interval):
            try:
                self.autoscale_once()
            except Exception as e:
                self._log("autoscale tick failed (pool serves on): %s"
                          % e)

    # -- status front door --------------------------------------------
    def start_status_server(self, port):
        """Aggregated /serve + /healthz on ``port`` (0 = ephemeral).
        Same ThreadingHTTPServer discipline as the replicas'."""
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)
        sup = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):
                path = self.path.split("?")[0].rstrip("/") or "/"
                try:
                    if path in ("/", "/serve"):
                        doc = sup.view()
                    elif path == "/healthz":
                        doc = {"ok": True,
                               "replicas": len(
                                   sup.driver.live_workers())}
                    else:
                        self._json(404, {"error": "not found"})
                        return
                    self._json(200, doc)
                except Exception as e:
                    try:
                        self._json(500, {"error": str(e)})
                    except Exception:
                        pass

            def _json(self, code, doc):
                data = json.dumps(doc).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, fmt, *args):
                pass

        httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        httpd.daemon_threads = True
        threading.Thread(target=httpd.serve_forever,
                         name="hvd-serve-status", daemon=True).start()
        return httpd, httpd.server_address[1]

    # -- lifecycle ----------------------------------------------------
    def run(self, status_port=None, autoscale=True):
        """Blocks serving the pool; returns the driver's exit code.
        SIGTERM/SIGINT drain the whole pool gracefully."""
        if status_port is not None:
            _, actual = self.start_status_server(status_port)
            self._log("status endpoint on :%d" % actual)
        if autoscale:
            threading.Thread(target=self._autoscale_loop,
                             name="hvd-serve-autoscale",
                             daemon=True).start()
        try:
            rc = self.driver.run(install_signal_handlers=True)
        finally:
            self._stop.set()
        return rc

    def shutdown(self, grace=None):
        self._stop.set()
        self.driver.request_drain("all", grace=grace)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve",
        description="Serve a model from a durable checkpoint lineage "
                    "on a pool of replicas (docs/SERVE.md).")
    ap.add_argument("-np", "--np", type=int, default=1,
                    help="initial replica count")
    ap.add_argument("--min-np", type=int, default=None)
    ap.add_argument("--max-np", type=int, default=None,
                    help="autoscale ceiling (default: -np)")
    ap.add_argument("-H", "--hosts", default=None,
                    help="host:slots[,host:slots...] "
                         "(default: localhost:<max-np>)")
    ap.add_argument("--model", default="affine")
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.environ.get(
        "HVD_TPU_CKPT_DIR"))
    ap.add_argument("--port-base", type=int, default=9500)
    ap.add_argument("--status-port", type=int, default=9499,
                    help="aggregated /serve endpoint (hvd-top --serve)")
    ap.add_argument("--no-autoscale", action="store_true")
    ap.add_argument("--scale-up-queue", type=float, default=4.0,
                    help="mean queue depth per replica that adds one")
    ap.add_argument("--scale-down-idle", type=float, default=10.0,
                    help="seconds of empty queues before dropping one")
    ap.add_argument("--drain-grace", type=float, default=None)
    ap.add_argument("--exit-after", type=float, default=0,
                    help="forwarded to replicas (test/bench knob)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    max_np = args.max_np if args.max_np is not None else args.np
    min_np = args.min_np if args.min_np is not None else min(
        args.np, max_np)
    hosts = args.hosts or ("localhost:%d" % max_np)
    env = dict(os.environ)
    env["HVD_TPU_SERVE_MODEL"] = args.model
    env["HVD_TPU_SERVE_DIM"] = str(args.dim)
    env["HVD_TPU_SERVE_PORT"] = str(args.port_base)
    if args.ckpt_dir:
        env["HVD_TPU_CKPT_DIR"] = args.ckpt_dir
    if args.exit_after:
        env["HVD_TPU_SERVE_EXIT_AFTER"] = str(args.exit_after)
    command = [sys.executable, "-m", "horovod_tpu_torch.serve.replica"]
    sup = ServeSupervisor(
        command, hosts, min_replicas=min_np, max_replicas=max_np,
        np_initial=args.np, port_base=args.port_base, env=env,
        drain_grace=args.drain_grace,
        scale_up_queue=args.scale_up_queue,
        scale_down_idle=args.scale_down_idle, verbose=args.verbose)
    return sup.run(status_port=args.status_port,
                   autoscale=not args.no_autoscale)


if __name__ == "__main__":
    sys.exit(main())
