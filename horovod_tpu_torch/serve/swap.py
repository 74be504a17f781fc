"""Rolling weight swap: the durable-lineage watcher (docs/SERVE.md).
A copy of ``horovod_tpu/serve/swap.py`` over the port's
``elastic/durable.py``, whose lineage format is the reference's.

A background thread polls the checkpoint directory for a manifest NEWER
than the serving step. Candidates are walked newest-first and validated
DEEPLY (manifest parse + every shard's byte size and CRC32C) before a
single byte reaches the serving path: a torn manifest or a flipped bit
counts one ``serve_swap_rejects_total`` (once per offending directory,
not once per poll) and the scan falls through to the next-older
candidate — the replica keeps serving its current weights, never a
half-loaded set.

A valid candidate is loaded into a SHADOW buffer (fresh leaves + a
fresh forward whose leaves are already uploaded to the device) off the
request path, then flipped in by one reference swap between batches —
in-flight batches finish on the old forward, so a swap drops zero
requests by construction. Replicas stagger their flips (``stagger *
worker_id`` seconds) so a fleet of replicas rolls one at a time and a
poisoned-but-valid checkpoint never takes the whole pool down in the
same instant.

A drain beats a swap: once the replica is draining, a pending shadow is
abandoned (``serve_swap_aborts_total``) — the remaining queue finishes
on the weights it was admitted under, and the next incarnation of the
replica loads the new lineage at startup anyway.
"""

import threading

from horovod_tpu_torch.elastic import durable

from . import model as _model


def publish_leaves(directory, step, leaves, generation=0):
    """Synchronously writes one complete single-shard checkpoint of
    ``leaves`` at ``step`` — the writer side the swap tests and
    ``chip_smoke.py``'s serve phase use to grow a lineage without running
    a training job. Numpy leaves are written as the reference
    writes them, so its ``load_leaves`` reads the lineage."""
    ck = durable.DurableCheckpointer(directory, every_n_commits=1,
                                     rank=0, world_size=1)
    ck._generation = lambda: generation
    if not ck.maybe_enqueue(dict(leaves), step):
        raise RuntimeError("checkpoint at step %d was not due (lineage "
                           "already past it?)" % step)
    if not ck.flush(timeout=60):
        raise RuntimeError("checkpoint publish at step %d timed out"
                           % step)
    return durable.last_durable_step(directory)[0]


class SwapWatcher(threading.Thread):
    """Watches ``ckpt_dir``; calls ``flip_fn(step, leaves, crc)`` with
    a validated newer weight set. ``current_step_fn`` reports the
    serving step; ``draining_fn`` gates the flip (and the load)."""

    def __init__(self, ckpt_dir, template, current_step_fn, flip_fn,
                 metrics=None, draining_fn=None, interval=0.5,
                 stagger=0.0, verbose=False):
        super().__init__(name="hvd-serve-swap", daemon=True)
        self.ckpt_dir = ckpt_dir
        self.template = template
        self.current_step_fn = current_step_fn
        self.flip_fn = flip_fn
        self.metrics = metrics
        self.draining_fn = draining_fn or (lambda: False)
        self.interval = float(interval)
        self.stagger = float(stagger)
        self._stop = threading.Event()
        self._rejected = set()  # ckpt dirs already counted invalid
        self._verbose = verbose
        self.swaps = 0
        self.rejects = 0
        self.aborts = 0

    def stop(self):
        self._stop.set()

    def _log(self, msg):
        if self._verbose:
            import sys
            sys.stderr.write("[serve-swap] %s\n" % msg)
            sys.stderr.flush()

    def poll_once(self):
        """One watcher step (directly callable from tests): scan, deep-
        validate, shadow-load, flip. Returns the step flipped to, or
        None."""
        if self.draining_fn():
            return None
        current = self.current_step_fn()
        candidate = None
        for step, gen, path in durable.list_checkpoints(self.ckpt_dir):
            if step <= current:
                break  # newest-first: everything below is old news
            manifest = durable.validate_manifest(path, deep=True)
            if manifest is None:
                if path not in self._rejected:
                    self._rejected.add(path)
                    self.rejects += 1
                    if self.metrics is not None:
                        self.metrics.inc("serve_swap_rejects_total")
                    self._log("rejecting torn/CRC-invalid checkpoint %s "
                              "(step %d); serving current weights"
                              % (path, step))
                continue  # fall back to the next-older candidate
            candidate = (step, path, manifest)
            break
        if candidate is None:
            return None
        step, path, manifest = candidate
        try:
            raw = durable.load_leaves(manifest, path, verify=True)
        except (OSError, ValueError) as e:
            # The shard changed between validate and load (a racing
            # retention pass, or a fault injector): same contract as an
            # invalid manifest.
            if path not in self._rejected:
                self._rejected.add(path)
                self.rejects += 1
                if self.metrics is not None:
                    self.metrics.inc("serve_swap_rejects_total")
                self._log("rejecting checkpoint %s at load time: %s"
                          % (path, e))
            return None
        leaves = _model.extract_leaves(raw, self.template)
        if leaves is None:
            if path not in self._rejected:
                self._rejected.add(path)
                self.rejects += 1
                if self.metrics is not None:
                    self.metrics.inc("serve_swap_rejects_total")
                self._log("checkpoint %s (step %d) has no usable model "
                          "leaves; serving current weights"
                          % (path, step))
            return None
        # Shadow is ready. Staggered flip: replicas roll one at a time.
        if self.stagger > 0 and self._stop.wait(self.stagger):
            return None
        if self.draining_fn():
            # Drain won the race: the queue finishes on the weights it
            # was admitted under; the shadow is dropped on the floor.
            self.aborts += 1
            if self.metrics is not None:
                self.metrics.inc("serve_swap_aborts_total")
            self._log("abandoning loaded swap to step %d: replica is "
                      "draining" % step)
            return None
        crc = _model.fingerprint(leaves)
        self.flip_fn(step, leaves, crc)
        self.swaps += 1
        if self.metrics is not None:
            self.metrics.inc("serve_swaps_total")
            self.metrics.set_gauge("serve_model_step", step)
        self._log("swapped to step %d (weights %s)" % (step, crc))
        return step

    def run(self):
        while not self._stop.wait(self.interval):
            try:
                self.poll_once()
            except Exception as e:  # the watcher must never kill serving
                self._log("watcher error (serving continues): %s" % e)
