"""Seeded open-loop load generator for the serve plane. A copy of
``horovod_tpu/serve/loadgen.py``; it imports no torch (its answers are
checked against the numpy ``model.forward``).

OPEN loop: arrivals fire on a fixed schedule derived from the target
rate and the seed, whether or not earlier requests have finished — so
queueing delay shows up in the measured latency instead of silently
throttling the offered load (the closed-loop trap). Each worker thread
owns a :class:`~horovod_tpu_torch.serve.client.ServeClient` and a disjoint
slice of the schedule; results land in one summary with p50/p99 from
the actual sorted samples (no histogram estimate on the bench path).

Every request's input is derived from the seed, so the expected answer
is recomputable: pass ``leaves_by_crc`` mapping a weights fingerprint
to its leaves and every response is checked against the numpy forward
for the weight set it CLAIMS (by fingerprint) to have used — the
rolling-swap e2e and ``bench.py --serve`` both lean on this to turn
"zero dropped, right answers, right weights" into an assert.
"""

import threading
import time

import numpy as np

from . import model as _model
from .client import ServeClient, ServeError


class LoadResult:
    def __init__(self):
        self.lock = threading.Lock()
        self.latencies = []       # seconds, successes only
        self.ok = 0
        self.errors = []          # (rid, cause, message)
        self.mismatches = []      # (rid, why)
        self.by_crc = {}          # weights_crc -> response count

    def record_ok(self, latency, crc):
        with self.lock:
            self.ok += 1
            self.latencies.append(latency)
            self.by_crc[crc] = self.by_crc.get(crc, 0) + 1

    def record_error(self, rid, cause, message):
        with self.lock:
            self.errors.append((rid, cause, str(message)))

    def record_mismatch(self, rid, why):
        with self.lock:
            self.mismatches.append((rid, why))

    def quantile(self, q):
        with self.lock:
            if not self.latencies:
                return None
            samples = sorted(self.latencies)
        idx = min(len(samples) - 1, int(q * len(samples)))
        return samples[idx]

    def summary(self, wall):
        p50, p99 = self.quantile(0.50), self.quantile(0.99)
        with self.lock:
            return {
                "ok": self.ok,
                "errors": len(self.errors),
                "mismatches": len(self.mismatches),
                "rps_achieved": self.ok / wall if wall > 0 else 0.0,
                "p50_ms": None if p50 is None else round(p50 * 1e3, 3),
                "p99_ms": None if p99 is None else round(p99 * 1e3, 3),
                "by_crc": dict(self.by_crc),
            }


def request_input(seed, rid, dim):
    """The seeded, recomputable input vector for request ``rid``."""
    rng = np.random.RandomState((int(seed) * 1000003 + int(rid))
                                % (2 ** 31 - 1))
    return rng.standard_normal(dim).astype(np.float32)


def check_response(doc, x, model_name, leaves_by_crc, atol=1e-3):
    """Verifies a response against the numpy forward for the weight set
    its fingerprint names. Returns None when consistent, else a short
    reason. Unknown fingerprints only fail when the caller claims to
    know every live weight set (leaves_by_crc non-empty)."""
    crc = doc.get("weights_crc")
    if leaves_by_crc:
        if crc not in leaves_by_crc:
            return "unknown weights fingerprint %r" % (crc,)
        expect = _model.forward(model_name, leaves_by_crc[crc], x)
        got = np.asarray(doc["y"], np.float32)
        if got.shape != expect.shape:
            return "shape %s != expected %s" % (got.shape, expect.shape)
        if not np.allclose(got, expect, atol=atol):
            return ("answer does not match the %s weights it claims "
                    "(max err %.3g)" % (crc, float(np.max(np.abs(
                        got - expect)))))
    return None


def run_load(endpoints, rate, duration, dim, seed=0, model_name="affine",
             leaves_by_crc=None, workers=4, total_deadline=10.0,
             rid_base=0):
    """Drives ``rate`` req/s for ``duration`` seconds open-loop against
    ``endpoints``; returns (LoadResult, wall_seconds). Request ids are
    ``rid_base + k`` so back-to-back phases (bench traffic steps) keep
    ids — and therefore seeded inputs — disjoint."""
    n = max(1, int(rate * duration))
    interval = duration / n
    start = time.monotonic() + 0.05
    result = LoadResult()
    leaves_by_crc = leaves_by_crc or {}

    def worker(offset):
        client = ServeClient(endpoints, total_deadline=total_deadline)
        for k in range(offset, n, workers):
            rid = rid_base + k
            wake = start + k * interval
            delay = wake - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            x = request_input(seed, rid, dim)
            t0 = time.monotonic()
            try:
                doc = client.infer(x, rid=str(rid))
            except ServeError as e:
                result.record_error(rid, e.cause, e)
                continue
            latency = time.monotonic() - t0
            why = check_response(doc, x, model_name, leaves_by_crc)
            if why is not None:
                result.record_mismatch(rid, why)
            else:
                result.record_ok(latency, doc.get("weights_crc"))

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(workers)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return result, time.monotonic() - t0
