"""Seeded chaos for the serving plane (docs/CHAOS.md, docs/SERVE.md).
A copy of ``horovod_tpu/serve/chaos.py``.

``HVD_TPU_SERVE_CHAOS_SPEC`` grammar, mirroring the fleet schedule's
(semicolon-separated clauses, deterministic under ``seed=``)::

    seed=7;corrupt_batch=3            # flip a byte in the 3rd batch frame
    seed=7;corrupt_batch=3,5          # ...and the 5th
    seed=23;kill_after=2.0            # supervisor-side: SIGKILL a random
                                      # replica 2s into the run

``corrupt_batch`` acts INSIDE the replica, between frame assembly and
the per-row CRC verification — the injected bitflip must surface as a
cause-named per-request failure (`frame-corrupt`), never as a corrupt
answer. ``kill_after`` is consumed by the supervisor/test harness (the
replica cannot SIGKILL itself mid-request from outside the request
path); the elastic driver's respawn + the client's re-queue then have
to deliver the invariant end to end.
"""

import os
import random


class ServeChaos:
    def __init__(self, seed=0, corrupt_batches=(), kill_after=None):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.corrupt_batches = set(int(b) for b in corrupt_batches)
        self.kill_after = kill_after
        self._batches_seen = 0
        self.corrupted = 0

    @classmethod
    def from_env(cls, env=None):
        spec = (env or os.environ).get("HVD_TPU_SERVE_CHAOS_SPEC", "")
        if not spec.strip():
            return None
        return cls.parse(spec)

    @classmethod
    def parse(cls, spec):
        seed, corrupt, kill_after = 0, (), None
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            key, _, value = clause.partition("=")
            key = key.strip()
            value = value.strip()
            if key == "seed":
                seed = int(value)
            elif key == "corrupt_batch":
                corrupt = [int(v) for v in value.split(",") if v]
            elif key == "kill_after":
                kill_after = float(value)
            else:
                raise ValueError(
                    "unknown serve chaos clause %r (grammar: seed=N;"
                    "corrupt_batch=N[,M];kill_after=SECONDS)" % key)
        return cls(seed=seed, corrupt_batches=corrupt,
                   kill_after=kill_after)

    def maybe_corrupt_frame(self, frame, rows=None):
        """Called by the batcher on every assembled frame (1-indexed
        count); flips one byte of a scheduled frame in place. ``rows``
        bounds the flip to the occupied rows — flipping pad bytes would
        be chaos nobody can observe."""
        self._batches_seen += 1
        if self._batches_seen not in self.corrupt_batches:
            return False
        occupied = frame[:rows] if rows else frame
        flat = occupied.reshape(-1).view("uint8")
        pos = self.rng.randrange(len(flat))
        flat[pos] ^= 0xFF
        self.corrupted += 1
        return True
