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
requests by construction. Replicas stagger their swaps (``stagger *
slot`` seconds) so a fleet of replicas rolls one at a time and a
poisoned-but-valid checkpoint never takes the whole pool down in the
same instant.

Deliberate differences from the reference (ROADMAP queue C), for the
replicas' host time, which the swap shares with the HTTP threads and the
batch loop under one GIL: each shard is read and its CRC32C computed
ONCE a candidate (``durable.load_leaves(verify=True)`` is the deep
validation; the reference validates deeply, then reads and checks every
shard again to load it), so a shard that fails at load falls back to the
next-older candidate as a torn manifest does; a directory whose manifest
parsed but whose shards failed is not read again (one without a
parseable manifest is looked at again at every poll: its writer renames
the manifest into place last); the stagger is waited once a candidate's
manifest parses, before the load and not between the load and the flip,
so that the replicas of a pool do not load at once; and it is a
replica's local slot, not its worker id, that the stagger multiplies.
The swap's stages are timed (``last_profile``).

A drain beats a swap: once the replica is draining, a pending shadow is
abandoned (``serve_swap_aborts_total``) — the remaining queue finishes
on the weights it was admitted under, and the next incarnation of the
replica loads the new lineage at startup anyway.
"""

import threading
import time

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
        self._bad = set()  # ckpt dirs whose published shards failed
        self._verbose = verbose
        self.swaps = 0
        self.rejects = 0
        self.aborts = 0
        # the stages of the last swap, in seconds, with its monotonic
        # start and end (``t0``, ``t1``): what a replica's swap costs it
        self.last_profile = None

    def stop(self):
        self._stop.set()

    def _log(self, msg):
        if self._verbose:
            import sys
            sys.stderr.write("[serve-swap] %s\n" % msg)
            sys.stderr.flush()

    def _reject(self, path, why):
        """Counts a rejected checkpoint directory once."""
        if path in self._rejected:
            return
        self._rejected.add(path)
        self.rejects += 1
        if self.metrics is not None:
            self.metrics.inc("serve_swap_rejects_total")
        self._log("rejecting checkpoint %s: %s; serving current weights"
                  % (path, why))

    def _load_newest(self, candidates, prof):
        """(step, leaves) of the newest of ``candidates`` ([(step, path,
        manifest)], newest first) whose shards validate and hold the
        model's leaves, reading each shard of a candidate once; None when
        there is none. A candidate that fails here is not read again."""
        t = time.monotonic()
        for step, path, manifest in candidates:
            try:
                raw = durable.load_leaves(manifest, path, verify=True)
            except (OSError, ValueError, KeyError, TypeError) as e:
                self._bad.add(path)
                self._reject(path, "shard invalid (step %d): %s"
                             % (step, e))
                continue  # fall back to the next-older candidate
            prof["validate_load_s"] = time.monotonic() - t
            t = time.monotonic()
            leaves = _model.extract_leaves(raw, self.template)
            prof["extract_s"] = time.monotonic() - t
            if leaves is None:
                self._bad.add(path)
                self._reject(path, "no usable model leaves (step %d)"
                             % step)
                return None
            return step, leaves
        return None

    def poll_once(self):
        """One watcher step (directly callable from tests): scan, stagger,
        deep-validate and shadow-load, flip. Returns the step flipped to,
        or None."""
        if self.draining_fn():
            return None
        current = self.current_step_fn()
        t0 = time.monotonic()
        candidates = []
        for step, gen, path in durable.list_checkpoints(self.ckpt_dir):
            if step <= current:
                break  # newest-first: everything below is old news
            if path in self._bad:
                continue
            manifest = durable.read_manifest(path)
            if manifest is None:
                # torn, or not yet renamed into place by its writer: its
                # manifest is read again at the next poll
                self._reject(path, "torn or unparseable manifest (step "
                             "%d)" % step)
                continue
            candidates.append((step, path, manifest))
        if not candidates:
            return None
        # Staggered swaps: replicas load and flip one at a time.
        t = time.monotonic()
        if self.stagger > 0 and self._stop.wait(self.stagger):
            return None
        prof = {"scan_s": t - t0, "stagger_s": time.monotonic() - t}
        loaded = self._load_newest(candidates, prof)
        if loaded is None:
            return None
        step, leaves = loaded
        if self.draining_fn():
            # Drain won the race: the queue finishes on the weights it
            # was admitted under; the shadow is dropped on the floor.
            self.aborts += 1
            if self.metrics is not None:
                self.metrics.inc("serve_swap_aborts_total")
            self._log("abandoning loaded swap to step %d: replica is "
                      "draining" % step)
            return None
        t = time.monotonic()
        crc = _model.fingerprint(leaves)
        prof["fingerprint_s"] = time.monotonic() - t
        stages = self.flip_fn(step, leaves, crc)
        if isinstance(stages, dict):
            prof.update(stages)
        self.last_profile = dict(prof, step=step, t0=t0,
                                 t1=time.monotonic())
        self.swaps += 1
        if self.metrics is not None:
            self.metrics.inc("serve_swaps_total")
            self.metrics.set_gauge("serve_model_step", step)
        self._log("swapped to step %d (weights %s)" % (step, crc))
        return step

    def run(self):
        seen = set()
        while not self._stop.wait(self.interval):
            try:
                self.poll_once()
            except Exception as e:  # the watcher must never kill serving
                # on stderr with its traceback, once for each message
                # (the reference logs it only when verbose)
                if str(e) not in seen:
                    seen.add(str(e))
                    import sys
                    import traceback
                    sys.stderr.write("[serve-swap] watcher error (serving "
                                     "continues): %s" %
                                     traceback.format_exc())
                    sys.stderr.flush()
