"""One serve replica: ``python -m horovod_tpu_torch.serve.replica``
(docs/SERVE.md), the counterpart of ``horovod_tpu/serve/replica.py``.

Spawned by the elastic driver (``python -m horovod_tpu_torch.serve``)
exactly like a training worker: ``HVD_TPU_WORKER_ID`` names it,
``HVD_TPU_RENDEZVOUS_ADDR`` reaches the driver's KV (drain records),
``HVD_TPU_CKPT_DIR`` points at the durable lineage. Its HTTP port is
``port_base + worker_id`` — deterministic, so the supervisor and clients
compute endpoints instead of needing a registry.

Its forward runs on the GPU. A replica never calls ``init()``; its
device is ``cuda:(slot mod torch.cuda.device_count())``, the slot being
the local slot the driver gave it on its host (``HVD_TPU_LOCAL_SLOT``,
else its worker id). A respawned replica takes the lowest free slot, the
killed one's, and so its GPU, never a survivor's.
``--device`` (or ``HVD_TPU_SERVE_DEVICE``) names another device,
``cpu`` for the CPU tests. Without a GPU and without ``--device cpu``
the replica raises ``CudaUnavailableError`` and exits non-zero. Its
products run in float32: the replica turns TF32 off in its process.

Thread model (docs/DESIGN.md diagram):

* HTTP handler threads admit requests into the bounded queue and park
  on ticket events;
* the MAIN thread runs the batch loop: take a size/deadline-bounded
  batch, run the forward on the device, split responses — and, between
  batches, poll the drain record (rate-limited local KV read, NO
  collective: replicas are independent by design);
* the swap watcher thread shadow-loads newer valid lineage manifests,
  uploads them to the device, and flips the forward under
  ``_flip_lock``, between batches.

Drain (preemption, shutdown, SIGTERM): stop admitting — every new
request gets a prompt, cause-named 503 the client re-queues elsewhere —
finish the queue, exit ``EXIT_DRAINED``. In-flight work is never
silently dropped.
"""

import argparse
import collections
import os
import signal
import sys
import threading
import time

import numpy as np

from horovod_tpu_torch.elastic import durable
from horovod_tpu_torch.elastic.run import drain_requested
from horovod_tpu_torch.elastic.state import EXIT_DRAINED
from horovod_tpu_torch.trace import emit as trace_emit

from . import model as _model
from .batcher import MicroBatcher, bucket_for
from .chaos import ServeChaos
from .metrics import ServeMetrics
from .server import ReplicaContext, start_front_door
from .swap import SwapWatcher


def make_parser():
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve.replica",
        description="One serve replica (normally spawned by "
                    "python -m horovod_tpu_torch.serve).")
    ap.add_argument("--model", default=os.environ.get(
        "HVD_TPU_SERVE_MODEL", "affine"))
    ap.add_argument("--dim", type=int, default=int(os.environ.get(
        "HVD_TPU_SERVE_DIM", "8")))
    ap.add_argument("--port-base", type=int, default=int(os.environ.get(
        "HVD_TPU_SERVE_PORT", "9500")))
    ap.add_argument("--ckpt-dir", default=os.environ.get(
        "HVD_TPU_CKPT_DIR"))
    ap.add_argument("--device", default=os.environ.get(
        "HVD_TPU_SERVE_DEVICE"),
        help="where the forward runs (default: the GPU "
             "cuda:(local slot mod GPU count); cpu for tests)")
    ap.add_argument("--max-batch", type=int, default=int(os.environ.get(
        "HVD_TPU_SERVE_MAX_BATCH", "16")))
    ap.add_argument("--max-delay-ms", type=float,
                    default=float(os.environ.get(
                        "HVD_TPU_SERVE_MAX_DELAY_MS", "5")))
    ap.add_argument("--queue-max", type=int, default=int(os.environ.get(
        "HVD_TPU_SERVE_QUEUE_MAX", "256")))
    ap.add_argument("--request-deadline", type=float,
                    default=float(os.environ.get(
                        "HVD_TPU_SERVE_REQUEST_DEADLINE", "10")))
    ap.add_argument("--swap-interval", type=float,
                    default=float(os.environ.get(
                        "HVD_TPU_SERVE_SWAP_INTERVAL", "0.5")))
    ap.add_argument("--swap-stagger", type=float,
                    default=float(os.environ.get(
                        "HVD_TPU_SERVE_SWAP_STAGGER", "0.25")))
    ap.add_argument("--exit-after", type=float, default=float(
        os.environ.get("HVD_TPU_SERVE_EXIT_AFTER", "0")),
        help="test/bench knob: exit 0 after N seconds of serving "
             "(0 = serve forever)")
    ap.add_argument("--verbose", action="store_true", default=bool(
        os.environ.get("HVD_TPU_SERVE_VERBOSE")))
    return ap


class Replica:
    def __init__(self, args):
        self.args = args
        self.wid = int(os.environ.get("HVD_TPU_WORKER_ID", "0"))
        self.slot = int(os.environ.get("HVD_TPU_LOCAL_SLOT", self.wid))
        self.device = _model.resolve_device(args.device, self.slot)
        self.metrics = ServeMetrics()
        self.chaos = ServeChaos.from_env()
        self.batcher = MicroBatcher(
            max_batch=args.max_batch,
            max_delay=args.max_delay_ms / 1e3,
            queue_max=args.queue_max,
            metrics=self.metrics, chaos=self.chaos)
        self.ctx = ReplicaContext(self.batcher, self.metrics,
                                  worker_id=self.wid,
                                  request_deadline=args.request_deadline,
                                  device=self.device)
        self._flip_lock = threading.Lock()
        self._drain_seen = False
        self._last_drain_poll = 0.0
        self.template = _model.init_leaves(args.model, args.dim)
        self.step = -1
        self.leaves = None
        self.crc = None
        self.forward = None
        self.httpd = None
        self.port = None
        self.watcher = None
        # monotonic start times of the recent batches: the longest gap
        # between two of them around a swap is what the swap stalled
        # the batch loop
        self._batch_starts = collections.deque(maxlen=4096)
        self.ctx.swap_profile_fn = self.swap_profile
        self._trace = trace_emit.shard_for("serve_r%d" % self.wid,
                                           rank=self.wid)

    def _log(self, msg):
        sys.stderr.write("[serve %d] %s\n" % (self.wid, msg))
        sys.stderr.flush()

    # -- weights ------------------------------------------------------
    def _flip(self, step, leaves, crc):
        """Installs a weight set (initial load and every swap). One
        reference swap under the lock, after the new leaves are on the
        device; in-flight batches finish on the forward they
        snapshotted. The new forward runs once on zeros in every bucket
        first, so that the requests after a boot, a respawn or a swap do
        not pay for loading the device's libraries and kernels. Returns
        the seconds of each stage (upload, warm-up, flip)."""
        t0 = time.monotonic()
        fwd = _model.make_forward(self.args.model, leaves,
                                  device=self.device)
        t1 = time.monotonic()
        mb = self.args.max_batch
        for bucket in sorted({bucket_for(n, mb) for n in range(1, mb + 1)}):
            fwd(np.zeros((bucket, self.args.dim), np.float32))
        t2 = time.monotonic()
        with self._flip_lock:
            self.step, self.leaves, self.crc = step, leaves, crc
            self.forward = fwd
        self.ctx.set_weights(step, crc)
        self.metrics.set_gauge("serve_model_step", step)
        return {"upload_s": t1 - t0, "warmup_s": t2 - t1,
                "flip_s": time.monotonic() - t2}

    def swap_profile(self, tail=1.0):
        """The last swap's stages in seconds and ``max_gap_ms``: the
        longest gap between two batch starts from the swap's start to
        ``tail`` seconds after its flip (to now, if that is sooner).
        None before the first swap."""
        prof = self.watcher.last_profile if self.watcher else None
        if prof is None:
            return None
        lo, hi = prof["t0"], min(prof["t1"] + tail, time.monotonic())
        starts = list(self._batch_starts)
        before = [t for t in starts if t < lo]
        marks = before[-1:] + [t for t in starts if lo <= t <= hi] + [hi]
        gap = max((b - a for a, b in zip(marks, marks[1:])), default=0.0)
        out = {k: v for k, v in prof.items() if k not in ("t0", "t1")}
        out["max_gap_ms"] = gap * 1e3
        return out

    def _snapshot_forward(self):
        with self._flip_lock:
            return self.forward, (self.step, self.crc)

    def _load_initial(self):
        ckpt_dir = self.args.ckpt_dir
        if ckpt_dir and os.path.isdir(ckpt_dir):
            manifest, path = durable.latest_valid_manifest(ckpt_dir,
                                                           deep=True)
            if manifest is not None:
                try:
                    raw = durable.load_leaves(manifest, path,
                                              verify=True)
                    leaves = _model.extract_leaves(raw, self.template)
                    if leaves is not None:
                        step = int(manifest.get("step", 0))
                        self._flip(step, leaves,
                                   _model.fingerprint(leaves))
                        self._log("serving lineage step %d (weights %s)"
                                  % (step, self.crc))
                        return
                except (OSError, ValueError) as e:
                    self._log("lineage load failed (%s); serving "
                              "initial weights" % e)
        leaves = _model.init_leaves(self.args.model, self.args.dim)
        self._flip(0, leaves, _model.fingerprint(leaves))
        self._log("no usable lineage; serving initial weights (%s)"
                  % self.crc)

    # -- drain --------------------------------------------------------
    def _begin_drain(self, why):
        if self._drain_seen:
            return
        self._drain_seen = True
        self.ctx.begin_drain()
        self.batcher.close()
        self.metrics.inc("serve_drains_total")
        self.metrics.set_gauge("serve_draining", 1)
        self._log("draining (%s): admission closed, finishing %d "
                  "queued request(s)" % (why, self.batcher.depth()))

    def _poll_drain(self):
        now = time.monotonic()
        if now - self._last_drain_poll < 0.2:
            return
        self._last_drain_poll = now
        if drain_requested():
            self._begin_drain("drain record published")

    # -- main loop ----------------------------------------------------
    def serve(self):
        self._load_initial()
        self.httpd, self.port = start_front_door(
            self.args.port_base + self.wid, self.ctx)
        self._log("front door on :%d (model %s dim %d on %s, max_batch "
                  "%d, max_delay %.1fms)"
                  % (self.port, self.args.model, self.args.dim,
                     self.device, self.args.max_batch,
                     self.args.max_delay_ms))
        if self.args.ckpt_dir:
            self.watcher = SwapWatcher(
                self.args.ckpt_dir, self.template,
                current_step_fn=lambda: self.step,
                flip_fn=self._flip, metrics=self.metrics,
                draining_fn=lambda: self._drain_seen,
                interval=self.args.swap_interval,
                stagger=self.args.swap_stagger * self.slot,
                verbose=self.args.verbose)
            self.watcher.start()

        signal.signal(signal.SIGTERM,
                      lambda s, f: self._begin_drain("SIGTERM"))
        deadline = (time.monotonic() + self.args.exit_after
                    if self.args.exit_after > 0 else None)
        while True:
            self._poll_drain()
            tickets = self.batcher.next_batch(timeout=0.05)
            if tickets:
                self._batch_starts.append(time.monotonic())
                fwd, stamp = self._snapshot_forward()
                # Per-request span (docs/TRACING.md): one "serve.batch"
                # span per forward into this replica's own trace shard,
                # so hvd-trace merges serve latency next to the training
                # plane's spans. No-op unless HVD_TPU_TRACE_DIR is set.
                span_start = trace_emit.now_ns()
                self.batcher.run_batch(fwd, tickets, stamp=stamp)
                self._trace.span("serve.batch", span_start,
                                 trace_emit.now_ns(),
                                 nbytes=len(tickets), cycle=self.step)
                continue
            if self._drain_seen:
                # Queue flushed (next_batch returned empty after
                # close()): the drain contract is met.
                break
            if deadline is not None and time.monotonic() > deadline:
                self._log("exit-after deadline reached; serving done")
                return 0
        if self.watcher is not None:
            self.watcher.stop()
        self._log("drained cleanly; exiting EXIT_DRAINED")
        return EXIT_DRAINED


def main(argv=None):
    args = make_parser().parse_args(argv)
    import torch
    # float32 products (no TF32), as the numpy forward the answers are
    # checked with
    torch.set_float32_matmul_precision("highest")
    return Replica(args).serve()


if __name__ == "__main__":
    sys.exit(main())
