"""Continuous micro-batching: admission queue -> size/deadline-bounded
batches -> responses split back to their requests (docs/SERVE.md). The
counterpart of ``horovod_tpu/serve/batcher.py``, with the row CRC of the
port's ``elastic.durable.crc32c``.

The policy, in one paragraph: a request is admitted into a BOUNDED
queue (full queue = immediate cause-named reject — backpressure must
reach the client, not grow an invisible latency tail). The batch loop
takes up to ``max_batch`` requests, but never waits longer than
``max_delay`` after the oldest admitted request — latency is bounded by
policy, not by traffic. The assembled frame is padded up to the next
power-of-two bucket (the forward sees one shape per bucket, seven in
all, instead of one per distinct batch size), the forward runs, and each
row of the output lands in its request's ticket.

Integrity: every ticket carries the CRC32C of its input row taken at
ADMISSION; assembly re-verifies each row after the (chaos-injectable)
frame copy. A corrupt row fails exactly that request with a prompt,
cause-named error — the framework invariant "a correct answer or a
named failure, never silent corruption" applied to the serving plane.
"""

import threading
import time

import numpy as np

from horovod_tpu_torch.elastic import durable

BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class QueueFull(Exception):
    """Admission refused: the queue is at its bound."""


def bucket_for(n, max_batch):
    """Smallest power-of-two bucket >= n (capped at max_batch)."""
    for b in BUCKETS:
        if b >= n:
            return min(b, max_batch)
    return max_batch


class Ticket:
    """One admitted request: the handler thread parks on ``event``
    until the batch loop fills ``response`` or ``error``."""

    __slots__ = ("rid", "x", "crc", "admitted", "event", "response",
                 "error", "cause", "model_step", "weights_crc",
                 "cancelled")

    def __init__(self, rid, x):
        self.rid = rid
        self.x = np.ascontiguousarray(x, dtype=np.float32)
        if self.x.ndim != 1:
            # Reject at ADMISSION: a non-flat row would only blow up
            # later inside the batch loop's frame assembly, where an
            # exception kills the whole replica, not one request.
            raise ValueError(
                "request x must be a flat vector, got shape %r"
                % (tuple(self.x.shape),))
        self.crc = durable.crc32c(self.x.tobytes())
        self.admitted = time.monotonic()
        self.event = threading.Event()
        self.response = None
        self.error = None
        self.cause = None
        self.model_step = None
        self.weights_crc = None
        self.cancelled = False

    def fail(self, cause, message):
        self.cause = cause
        self.error = message
        self.event.set()

    def cancel(self):
        """Marks the ticket abandoned (its handler already answered —
        deadline expiry). The batch loop drops cancelled tickets
        instead of spending a forward-pass row on them."""
        self.cancelled = True

    def finish(self, row, stamp=None):
        # The weights identity is stamped BEFORE the event fires: the
        # handler thread must never see an answer whose fingerprint a
        # concurrent swap already moved on from.
        if stamp is not None:
            self.model_step, self.weights_crc = stamp
        self.response = row
        self.event.set()


class MicroBatcher:
    def __init__(self, max_batch=16, max_delay=0.005, queue_max=256,
                 metrics=None, chaos=None):
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay)
        self.queue_max = int(queue_max)
        self.metrics = metrics
        self.chaos = chaos
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue = []
        self._closed = False

    # -- admission (HTTP handler threads) ------------------------------
    def submit(self, rid, x):
        """Admits one request; returns its Ticket. Raises QueueFull at
        the bound — the caller turns that into a prompt 503 so the
        client re-queues elsewhere instead of silently waiting."""
        ticket = Ticket(rid, x)
        with self._cond:
            if self._closed:
                raise QueueFull("replica draining")
            if len(self._queue) >= self.queue_max:
                if self.metrics is not None:
                    self.metrics.inc("serve_rejects_total")
                raise QueueFull(
                    "admission queue full (%d)" % self.queue_max)
            self._queue.append(ticket)
            if self.metrics is not None:
                self.metrics.inc("serve_requests_total")
                self.metrics.set_gauge("serve_queue_depth",
                                       len(self._queue))
            self._cond.notify()
        return ticket

    def depth(self):
        with self._lock:
            return len(self._queue)

    def close(self):
        """Stops admission (drain); queued tickets still get answered
        by the remaining batch-loop iterations."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- batch assembly (the replica's main loop) ----------------------
    def next_batch(self, timeout=0.1):
        """Blocks until a batch is ready: up to ``max_batch`` tickets,
        released early once ``max_delay`` has passed since the OLDEST
        ticket was admitted. Returns [] on timeout with an empty queue
        (the caller's chance to poll drain / shutdown)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._queue:
                remain = deadline - time.monotonic()
                if remain <= 0 or self._closed:
                    if not self._queue:
                        return []
                    break
                self._cond.wait(remain)
            # Got at least one: wait out the batching window unless the
            # batch fills (or admission closed — drain flushes eagerly).
            release = self._queue[0].admitted + self.max_delay
            while (len(self._queue) < self.max_batch
                   and not self._closed):
                remain = release - time.monotonic()
                if remain <= 0:
                    break
                self._cond.wait(remain)
            # Purge deadline-abandoned tickets first: their handlers
            # already answered 504, so a forward row for them would
            # only amplify the overload that expired them.
            if any(t.cancelled for t in self._queue):
                kept = [t for t in self._queue if not t.cancelled]
                if self.metrics is not None:
                    self.metrics.inc("serve_cancelled_total",
                                     len(self._queue) - len(kept))
                self._queue = kept
            batch = self._queue[:self.max_batch]
            del self._queue[:len(batch)]
            if self.metrics is not None:
                self.metrics.observe("serve_queue_depth_sampled",
                                     len(self._queue))
                self.metrics.set_gauge("serve_queue_depth",
                                       len(self._queue))
            return batch

    def run_batch(self, forward_fn, tickets, stamp=None):
        """Assembles the padded frame, verifies per-row CRCs, runs the
        forward once, splits rows back to tickets (each stamped with
        ``stamp`` — the (step, weights_crc) identity of the weights the
        forward actually used). Never raises: every ticket ends
        answered, cause-named-failed, or dropped as cancelled (its
        handler already answered a deadline 504)."""
        live = [t for t in tickets if not t.cancelled]
        if self.metrics is not None and len(live) < len(tickets):
            self.metrics.inc("serve_cancelled_total",
                             len(tickets) - len(live))
        if not live:
            return
        dim = live[0].x.shape[-1] if live[0].x.ndim else 0
        bucket = bucket_for(len(live), self.max_batch)
        frame = np.zeros((bucket, dim), np.float32)
        ok = []
        for i, t in enumerate(live):
            if t.x.shape != (dim,):
                t.fail("shape",
                       "request shape %r does not match batch row "
                       "shape (%d,)" % (tuple(t.x.shape), dim))
                continue
            try:
                frame[i] = t.x
            except ValueError as e:
                t.fail("shape",
                       "request row does not fit the batch frame: %s"
                       % e)
                continue
            ok.append((i, t))
        if self.chaos is not None:
            self.chaos.maybe_corrupt_frame(frame, rows=len(live))
        # Integrity gate: the frame row must still be the bytes the
        # request was admitted with (catches the chaos bitflip and any
        # real copy bug between admission and the forward).
        verified = []
        for i, t in ok:
            row_crc = durable.crc32c(
                np.ascontiguousarray(frame[i]).tobytes())
            if row_crc != t.crc:
                if self.metrics is not None:
                    self.metrics.inc("serve_frame_corrupt_total")
                    self.metrics.inc("serve_errors_total")
                t.fail(
                    "frame-corrupt",
                    "batch frame corrupt (row crc %08x != admitted "
                    "%08x); request not computed" % (row_crc, t.crc))
            else:
                verified.append((i, t))
        if not verified:
            return
        if self.metrics is not None:
            self.metrics.add_gauge("serve_inflight", len(verified))
        try:
            out = forward_fn(frame)
        except Exception as e:
            for _, t in verified:
                if self.metrics is not None:
                    self.metrics.inc("serve_errors_total")
                t.fail("forward", "forward pass failed: %s" % e)
            return
        finally:
            if self.metrics is not None:
                self.metrics.add_gauge("serve_inflight", -len(verified))
        now = time.monotonic()
        for i, t in verified:
            t.finish(np.asarray(out[i]), stamp=stamp)
            if self.metrics is not None:
                self.metrics.inc("serve_responses_total")
                self.metrics.observe("serve_request_seconds",
                                     now - t.admitted)
        if self.metrics is not None:
            self.metrics.inc("serve_batches_total")
            self.metrics.observe("serve_batch_fill", len(live))
