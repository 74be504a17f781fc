"""serve_* metrics: the replica-side mirror registry (docs/SERVE.md,
docs/METRICS.md). A copy of ``horovod_tpu/serve/metrics.py``.

A serve replica never calls ``init()`` (no collectives on the
request path — that is the whole point), so like the fleet controller
it keeps a small Python mirror of the native registry: monotonic
counters, gauges, and fixed-bucket histograms rendered by the SAME
Prometheus renderer as the reference's worker endpoints
(``horovod_tpu_torch/_metrics.py``, a copy of its pure functions). One
scrape config covers training workers, the fleet controller, and every
serve replica.

Thread model: the batch loop, the HTTP handler threads, and the swap
watcher all write — everything mutates under one lock (request rates
on a replica are nowhere near lock-contention territory).
"""

import threading

# Request latency ladder: HTTP admission to response split, seconds.
# Sub-millisecond (a warm forward on a tiny model) up to the 10s
# request deadline — anything beyond the top bucket is a hang the
# client-side deadline converts into a named error.
_REQUEST_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Queue-depth ladder: sampled at every batch assembly. The top of the
# ladder is the default admission bound — a sample up there means the
# replica is about to start rejecting (serve_rejects_total).
_DEPTH_BOUNDS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                 256.0)

# Batch-fill ladder mirrors the pad-to-bucket shapes (batcher.py).
_BATCH_BOUNDS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)

COUNTERS = (
    "serve_requests_total",        # admitted into the queue
    "serve_responses_total",       # answered 200
    "serve_batches_total",         # forward passes executed
    "serve_rejects_total",         # refused at admission (full/draining)
    "serve_errors_total",          # answered with a cause-named error
    "serve_cancelled_total",       # deadline-expired tickets dropped
                                   # before spending a forward row
    "serve_frame_corrupt_total",   # batch-frame CRC mismatches detected
    "serve_swaps_total",           # weight swaps flipped in
    "serve_swap_rejects_total",    # newer-but-invalid manifests refused
    "serve_swap_aborts_total",     # swaps abandoned (drain won the race)
    "serve_drains_total",          # drain requests honored
)

GAUGES = (
    "serve_queue_depth",     # admitted-not-yet-batched requests
    "serve_inflight",        # requests inside a running forward
    "serve_draining",        # 1 while the replica is draining
    "serve_model_step",      # lineage step of the serving weights
)

HISTOGRAMS = {
    "serve_request_seconds": _REQUEST_BOUNDS,
    "serve_queue_depth_sampled": _DEPTH_BOUNDS,
    "serve_batch_fill": _BATCH_BOUNDS,
}


class _Histogram:
    """Fixed-bucket histogram, snapshot-compatible with the native
    registry's JSON shape (bounds / counts / sum / count)."""

    def __init__(self, bounds):
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


def histogram_quantile(snap, q):
    """Quantile estimate from a bucket snapshot (upper bound of the
    bucket the q-th observation falls in — the conservative read a
    latency SLO wants). None when the histogram is empty."""
    count = snap.get("count", 0)
    if not count:
        return None
    target = q * count
    bounds = snap.get("bounds", [])
    seen = 0
    for i, c in enumerate(snap.get("counts", [])):
        seen += c
        if seen >= target and c:
            if i < len(bounds):
                return float(bounds[i])
            # Overflow bucket: only the mean is honest up there.
            return snap.get("sum", 0.0) / count
    return float(bounds[-1]) if bounds else None


class ServeMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {name: 0 for name in COUNTERS}
        self._gauges = {name: 0 for name in GAUGES}
        self._histograms = {name: _Histogram(bounds)
                            for name, bounds in HISTOGRAMS.items()}

    def inc(self, name, n=1):
        with self._lock:
            self._counters[name] += n

    def get(self, name):
        with self._lock:
            return self._counters.get(name, self._gauges.get(name, 0))

    def set_gauge(self, name, v):
        with self._lock:
            self._gauges[name] = v

    def add_gauge(self, name, n):
        with self._lock:
            self._gauges[name] += n

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

    def latency_quantiles(self):
        """(p50, p99) of serve_request_seconds, in seconds (None when
        no request has completed yet)."""
        with self._lock:
            snap = self._histograms["serve_request_seconds"].snapshot()
        return (histogram_quantile(snap, 0.50),
                histogram_quantile(snap, 0.99))


def render_prometheus(metrics):
    from horovod_tpu_torch._metrics import render_prometheus as _render
    return _render(metrics.snapshot())
