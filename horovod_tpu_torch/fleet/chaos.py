"""Seeded fleet chaos schedule (docs/FLEET.md): a copy of
``horovod_tpu/fleet/chaos.py`` for the port, the same grammar and the
same seeded picks.

Extends the ``HVD_TPU_FAULT_SPEC`` grammar family (native/fault.cc,
``HVD_TPU_CKPT_FAULT_SPEC``) from frames and storage ops up to WHOLE
JOBS: a deterministic, seeded schedule of job arrivals, random worker
SIGKILLs, and forced priority preemptions, applied by the fleet
controller's tick loop. **Test-only — never set it on a real fleet.**

Grammar (``HVD_TPU_FLEET_CHAOS_SPEC``)::

    spec   := clause (';' clause)*
    clause := 'seed=N' | event
    event  := field (',' field)*
    field  := job=NAME|*          target job ('*' = seeded-random pick
                                  among currently-running jobs)
            | at=T                seconds after controller start (default 0)
            | action=arrive|kill|preempt
            | count=K             repeat K times (default 1)
            | every=S             seconds between repeats (default 1)

Actions:

* ``arrive``  — override the target job's arrival time to ``at`` (the
  jobfile's own ``arrival`` is the un-chaosed schedule).
* ``kill``    — SIGKILL one seeded-random live worker of the target job:
  the crash path (blacklist backoff, elastic shrink, or full
  ``--restart-from-ckpt`` recovery), NOT the drain path.
* ``preempt`` — force a graceful-drain preemption of the target job as
  if a higher-priority arrival needed its hosts; the controller
  restores it when capacity returns.

Example — job b arrives at t=3, a random worker of job a is SIGKILLed
at t=5 and again at t=7, and job c is force-preempted at t=8::

    HVD_TPU_FLEET_CHAOS_SPEC='seed=11;job=b,at=3,action=arrive;job=a,at=5,action=kill,count=2,every=2;job=c,at=8,action=preempt'

Determinism: same spec + same seed -> same schedule and same random
picks (victim workers, '*' jobs), independent of wall-clock jitter in
the controller loop (events fire on the controller's relative clock).
"""

import os
import random

ACTIONS = ("arrive", "kill", "preempt")


class FleetChaosError(ValueError):
    pass


class _Event:
    __slots__ = ("job", "at", "action", "count", "every", "fired")

    def __init__(self, job, at, action, count, every):
        self.job = job
        self.at = at
        self.action = action
        self.count = count
        self.every = every
        self.fired = 0

    def __repr__(self):
        return ("chaos(%s job=%s at=%.3g count=%d every=%.3g)"
                % (self.action, self.job, self.at, self.count,
                   self.every))


class FleetChaos:
    """Parsed schedule + the seeded PRNG the controller draws victim
    picks from. ``due(now_rel)`` returns the events to apply this tick
    (each at most ``count`` times, ``every`` seconds apart)."""

    def __init__(self, spec, seed=0):
        self.seed = seed
        self.events = []
        self._parse(spec)
        self.rng = random.Random(self.seed)

    @classmethod
    def from_env(cls):
        spec = os.environ.get("HVD_TPU_FLEET_CHAOS_SPEC", "")
        return cls(spec) if spec.strip() else None

    def _parse(self, spec):
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                try:
                    self.seed = int(clause[5:])
                except ValueError:
                    raise FleetChaosError(
                        "bad seed clause %r" % clause) from None
                continue
            fields = {}
            for field in clause.split(","):
                field = field.strip()
                if "=" not in field:
                    raise FleetChaosError(
                        "bad field %r in clause %r (expected key=value)"
                        % (field, clause))
                key, _, val = field.partition("=")
                fields[key.strip()] = val.strip()
            unknown = set(fields) - {"job", "at", "action", "count",
                                     "every"}
            if unknown:
                raise FleetChaosError(
                    "unknown field(s) %s in clause %r"
                    % (sorted(unknown), clause))
            action = fields.get("action")
            if action not in ACTIONS:
                raise FleetChaosError(
                    "clause %r needs action=%s (got %r)"
                    % (clause, "|".join(ACTIONS), action))
            job = fields.get("job", "*")
            if action == "arrive" and job == "*":
                raise FleetChaosError(
                    "arrive events need an explicit job= (clause %r)"
                    % clause)
            try:
                at = float(fields.get("at", "0"))
                count = int(fields.get("count", "1"))
                every = float(fields.get("every", "1"))
            except ValueError as e:
                raise FleetChaosError(
                    "bad numeric field in clause %r (%s)"
                    % (clause, e)) from None
            if count < 1 or at < 0 or every <= 0:
                raise FleetChaosError(
                    "clause %r needs at>=0, count>=1, every>0" % clause)
            self.events.append(_Event(job, at, action, count, every))

    def arrival_override(self, job_name):
        """The chaos-scheduled arrival time for `job_name`, or None."""
        for ev in self.events:
            if ev.action == "arrive" and ev.job == job_name:
                return ev.at
        return None

    def due(self, now_rel):
        """Kill/preempt events due at `now_rel` seconds since start —
        each event fires at ``at``, ``at + every``, ... up to ``count``
        total firings. Arrive events never fire here (they are
        consumed up front as arrival overrides)."""
        out = []
        for ev in self.events:
            if ev.action == "arrive":
                continue
            while (ev.fired < ev.count
                   and now_rel >= ev.at + ev.fired * ev.every):
                ev.fired += 1
                out.append(ev)
        return out

    def pick(self, candidates):
        """Seeded-deterministic pick among `candidates` (sorted first,
        so set iteration order can't leak into the schedule)."""
        candidates = sorted(candidates)
        return self.rng.choice(candidates) if candidates else None
