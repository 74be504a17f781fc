"""The fleet controller: one pool of GPUs, many jobs, preemption-native
(docs/FLEET.md): a copy of ``horovod_tpu/fleet/controller.py`` for the
port, over the port's elastic driver. It imports no torch: the jobs'
workers own the devices.

One :class:`FleetController` owns the host inventory (through a
:class:`~horovod_tpu_torch.fleet.placement.PlacementPool`) and supervises N
concurrent elastic jobs, each driven by its own
:class:`~horovod_tpu_torch.elastic.driver.ElasticDriver` in a worker thread.
A job's driver sees ONLY the slots leased to it (a
:class:`_LeaseDiscovery` is its host-discovery source), so the existing
elastic machinery — shrink on failure, blacklist backoff, durable
checkpoints, ``--restart-from-ckpt`` recovery — composes unchanged into
multi-tenancy, and the pool's ledger is the single place that can
refuse oversubscription.

Scheduling, in priority order (higher number wins), each tick:

* **Gang admission** — a waiting job is admitted only when at least
  ``min_np`` slots can be leased at once (nothing is leased on a failed
  attempt); a job that cannot fit retries with capped exponential
  backoff.
* **Preemption by graceful drain** — when a waiting job outranks
  running work and free slots do not cover its ``min_np``, the
  controller reclaims slots from the lowest-priority victims: first by
  SHRINKING a victim toward its ``min_np`` (drain of its youngest
  workers), then by whole-job preemption (drain of everything). Either
  way the victims durable-commit the in-flight step and exit
  ``EXIT_DRAINED``; their hosts re-enter the pool immediately (voluntary
  exit never trips the failure blacklist).
* **Restore** — a preempted job re-queues for admission (its fresh
  driver auto-resumes from the durable lineage); a shrunk job is grown
  back (slots leased back, ceiling raised) once no higher-priority work
  is waiting.

The controller never calls ``hvd.init()``; fleet_* metrics live in the
Python mirror registry (``fleet/metrics.py``) served at ``/metrics`` +
``/fleet`` for ``hvd-top --fleet``.
"""

import os
import shlex
import signal
import sys
import threading
import time

from horovod_tpu_torch.elastic import driver as _edriver
from horovod_tpu_torch.elastic.discovery import HostDiscovery
from horovod_tpu_torch.elastic.state import EXIT_DRAINED

from .metrics import FleetMetrics, start_server
from .placement import PlacementPool

# Job lifecycle. pending -> running -> done | failed, with the
# preemption loop running -> draining -> preempted -> running (restore).
PENDING = "pending"
RUNNING = "running"
DRAINING = "draining"
PREEMPTED = "preempted"
DONE = "done"
FAILED = "failed"
TERMINAL = (DONE, FAILED)


class JobSpec:
    """One tenant job. `command` is the worker argv (a string is
    shlex-split); `np` the desired world size, `min_np` the gang
    floor; bigger `priority` wins. `ckpt_dir` enables durable commits +
    preemption restore (the controller requires it — a preemptable job
    without a durable lineage would restart from step 0).

    `kind` is ``"train"`` (default) or ``"serve"`` — a serve job's
    workers are hvd-serve replicas (docs/SERVE.md): no rendezvous (so
    `start_timeout` defaults SHORT — the driver's growth gate only
    unsticks by stalling), and `placement` defaults to ``"spread"``
    (failure-domain diversity) where training defaults to ``"pack"``
    (locality). Both defaults are per-kind only; either field can be
    set explicitly."""

    def __init__(self, name, command, np, min_np=1, max_np=None,
                 priority=0, arrival=0.0, ckpt_dir=None, env=None,
                 max_restarts=2, start_timeout=None, kind="train",
                 placement=None):
        if isinstance(command, str):
            command = shlex.split(command)
        if min_np < 1 or np < min_np:
            raise ValueError(
                "job %r needs 1 <= min_np <= np (got %d..%d)"
                % (name, min_np, np))
        if kind not in ("train", "serve"):
            raise ValueError("job %r: unknown kind %r (train|serve)"
                             % (name, kind))
        if placement is None:
            placement = "spread" if kind == "serve" else "pack"
        if placement not in ("pack", "spread"):
            raise ValueError(
                "job %r: unknown placement %r (pack|spread)"
                % (name, placement))
        if start_timeout is None:
            start_timeout = 2 if kind == "serve" else 60
        self.name = str(name)
        self.command = list(command)
        self.np = int(np)
        self.min_np = int(min_np)
        self.max_np = int(max_np) if max_np else int(np)
        self.priority = int(priority)
        self.arrival = float(arrival)
        self.ckpt_dir = ckpt_dir
        self.env = dict(env or {})
        self.max_restarts = int(max_restarts)
        self.start_timeout = start_timeout
        self.kind = kind
        self.placement = placement

    @classmethod
    def from_dict(cls, d):
        known = ("name", "command", "np", "min_np", "max_np", "priority",
                 "arrival", "ckpt_dir", "env", "max_restarts",
                 "start_timeout", "kind", "placement")
        unknown = set(d) - set(known)
        if unknown:
            raise ValueError("unknown job field(s): %s" % sorted(unknown))
        return cls(**d)


class FleetJob:
    """Controller-side runtime of one JobSpec."""

    def __init__(self, spec):
        self.spec = spec
        self.state = PENDING
        self.driver = None
        self.thread = None
        self.rc = None
        self.next_try = 0.0
        self.backoff = float(os.environ.get(
            "HVD_TPU_FLEET_ADMIT_BACKOFF", "0.5"))
        self.restarts = 0
        self.admitted_at = None
        self.preempted_at = None
        self.drain_started = None
        self.shrink_target = None  # live-worker target of a partial drain
        self.drains = 0
        self.preemptions = 0
        self.restores = 0

    @property
    def name(self):
        return self.spec.name

    def live_per_host(self):
        if self.driver is None:
            return {}
        return self.driver.live_per_host()

    def live(self):
        return sum(self.live_per_host().values())


class _LeaseDiscovery(HostDiscovery):
    """A job's view of the pool: exactly its leased slots. The driver's
    own HostManager layers failure blacklisting on top, so a crashing
    host backs off within the job without leaving the fleet."""

    def __init__(self, pool, job_name):
        self._pool = pool
        self._job = job_name

    def find_available_hosts_and_slots(self):
        return self._pool.lease_of(self._job)


class FleetController:
    def __init__(self, discovery, jobs=(), port=None, drain_grace=None,
                 tick=0.2, chaos=None, verbose=False):
        cooldown = float(os.environ.get("HVD_TPU_ELASTIC_COOLDOWN", "10"))
        self.pool = PlacementPool(discovery, cooldown=cooldown)
        self.metrics = FleetMetrics()
        self.jobs = {}
        self.drain_grace = drain_grace or float(os.environ.get(
            "HVD_TPU_FLEET_DRAIN_GRACE", "30"))
        self._tick = tick
        self._chaos = chaos
        self._verbose = verbose
        self._start = None
        self._server = None
        self.port = None
        if port is not None:
            self._server, self.port = start_server(
                port, self.metrics, self.view)
        for spec in jobs:
            self.submit(spec)

    def _log(self, msg):
        sys.stderr.write("[fleet] %s\n" % msg)
        sys.stderr.flush()

    # -- job intake --------------------------------------------------------
    def submit(self, spec):
        if isinstance(spec, dict):
            spec = JobSpec.from_dict(spec)
        if spec.name in self.jobs:
            raise ValueError("duplicate job name %r" % spec.name)
        if self._chaos is not None:
            override = self._chaos.arrival_override(spec.name)
            if override is not None:
                spec.arrival = override
        job = FleetJob(spec)
        self.jobs[spec.name] = job
        return job

    # -- per-job driver lifecycle ------------------------------------------
    def _job_env(self, job):
        env = dict(os.environ)
        env.update(job.spec.env)
        if job.spec.ckpt_dir:
            env["HVD_TPU_CKPT_DIR"] = os.path.abspath(job.spec.ckpt_dir)
        return env

    def _start_driver(self, job, granted):
        np_now = sum(granted.values())
        driver = _edriver.ElasticDriver(
            job.spec.command, _LeaseDiscovery(self.pool, job.name),
            min_np=job.spec.min_np, max_np=job.spec.max_np,
            np_initial=np_now, start_timeout=job.spec.start_timeout,
            verbose=self._verbose, env=self._job_env(job),
            ckpt_dir=(os.path.abspath(job.spec.ckpt_dir)
                      if job.spec.ckpt_dir else None),
            restart_from_ckpt=bool(job.spec.ckpt_dir),
            drain_grace=self.drain_grace,
            placement=job.spec.placement,
            # One tenant's crashing host is everyone's problem: mirror
            # the job-local failure/health evidence into the pool so
            # the fleet-wide blacklist (fleet_hosts_blacklisted) is
            # actually fed, not just each job's private one.
            health_sink=self.pool)
        job.driver = driver

        def _run():
            try:
                job.rc = driver.run(install_signal_handlers=False)
            except Exception as e:
                self._log("job %s driver crashed: %s" % (job.name, e))
                job.rc = 1

        job.thread = threading.Thread(
            target=_run, name="hvd-fleet-%s" % job.name, daemon=True)
        job.thread.start()

    def _try_admit(self, job, now):
        """Gang admission (or restore): lease >= min_np or nothing."""
        granted = self.pool.lease(job.name, job.spec.np,
                                  min_slots=job.spec.min_np,
                                  placement=job.spec.placement)
        if not granted:
            self.metrics.inc("fleet_admission_retries_total")
            job.next_try = now + job.backoff
            job.backoff = min(job.backoff * 2, float(os.environ.get(
                "HVD_TPU_FLEET_ADMIT_BACKOFF_MAX", "10")))
            return False
        restore = job.state == PREEMPTED
        self._start_driver(job, granted)
        job.state = RUNNING
        job.admitted_at = now
        job.backoff = float(os.environ.get(
            "HVD_TPU_FLEET_ADMIT_BACKOFF", "0.5"))
        if restore:
            job.restores += 1
            self.metrics.inc("fleet_restores_total")
            self.metrics.observe("fleet_restore_seconds",
                                 now - (job.preempted_at or now))
            self._log("job %s restored on %s (preempted %.1fs)"
                      % (job.name, granted,
                         now - (job.preempted_at or now)))
        else:
            self.metrics.inc("fleet_admissions_total")
            if job.restarts:
                self.metrics.inc("fleet_job_restarts_total")
            self._log("job %s admitted on %s (priority %d)"
                      % (job.name, granted, job.spec.priority))
        return True

    def _capacity_event(self, now):
        """Slots just returned to the pool: every waiting job retries
        NOW, in priority order — without this, a backoff-delayed
        high-priority job would watch a retry-ready low-priority one
        (often the very job just preempted for it) take the freed
        slots back: priority inversion via the retry timer."""
        for job in self.jobs.values():
            if job.state in (PENDING, PREEMPTED):
                job.next_try = now

    def _reap_job(self, job, now):
        """Handles a driver thread that finished."""
        job.thread.join()
        job.thread = None
        rc = job.rc
        was_draining = job.state == DRAINING
        self.pool.release(job.name)
        job.driver = None
        # A death/full-drain mid-shrink must not leak the shrink into
        # the job's NEXT incarnation: a stale shrink_target would make
        # _finish_shrinks release slots freshly leased to the restarted
        # driver (and observe a garbage drain latency).
        job.shrink_target = None
        drain_started, job.drain_started = job.drain_started, None
        self._capacity_event(now)
        if rc == 0:
            job.state = DONE
            self.metrics.inc("fleet_job_completions_total")
            self._log("job %s completed" % job.name)
        elif rc == EXIT_DRAINED and was_draining:
            job.state = PREEMPTED
            job.preempted_at = now
            job.preemptions += 1
            self.metrics.inc("fleet_preemptions_total")
            drain_took = (now - drain_started
                          if drain_started is not None else 0.0)
            if drain_started is not None:
                self.metrics.observe("fleet_drain_seconds", drain_took)
            job.next_try = now
            self._log("job %s preempted (drained in %.1fs); hosts "
                      "reclaimed" % (job.name, drain_took))
        elif job.restarts < job.spec.max_restarts:
            job.restarts += 1
            job.state = PENDING
            job.next_try = now + job.backoff
            self._log("job %s died (rc=%s); controller restart %d/%d "
                      "from the durable lineage"
                      % (job.name, rc, job.restarts,
                         job.spec.max_restarts))
        else:
            job.state = FAILED
            self.metrics.inc("fleet_job_failures_total")
            self._log("job %s FAILED (rc=%s, restart budget spent)"
                      % (job.name, rc))

    # -- preemption planning -----------------------------------------------
    def _waiting(self, now):
        return [j for j in self.jobs.values()
                if j.state in (PENDING, PREEMPTED)
                and now - self._start >= j.spec.arrival]

    def _preempt_for(self, pending_job):
        """Reclaims slots for `pending_job` from strictly-lower-priority
        running jobs: shrink victims toward their min_np first, full
        preemption only when shrinking cannot cover the gang. Returns
        True when any drain was requested (admission then waits for the
        reclaimed slots to actually free)."""
        needed = pending_job.spec.min_np - self.pool.free_slots()
        if needed <= 0:
            return False
        victims = sorted(
            (j for j in self.jobs.values()
             if j.state == RUNNING
             and j.spec.priority < pending_job.spec.priority
             and j.driver is not None and not j.driver.draining()),
            key=lambda j: (j.spec.priority, -(j.admitted_at or 0)))
        if not victims:
            return False
        reclaimable = sum(
            self.pool.leased_slots_of(j.name) for j in victims)
        if self.pool.free_slots() + reclaimable < pending_job.spec.min_np:
            return False  # even preempting everything would not fit
        acted = False
        for victim in victims:
            if needed <= 0:
                break
            leased = self.pool.leased_slots_of(victim.name)
            shrinkable = leased - victim.spec.min_np
            if shrinkable >= needed:
                self._shrink(victim, leased - needed, pending_job)
                needed = 0
            else:
                self._preempt(victim, pending_job)
                needed -= leased
            acted = True
        return acted

    def _shrink(self, victim, target, for_job):
        """Partial drain: victim keeps running at `target` workers."""
        wids = victim.driver.live_workers()
        if len(wids) <= target:
            return
        drain_wids = wids[target:]  # youngest workers; rank 0 survives
        victim.driver.resize(target)
        victim.driver.request_drain(drain_wids, grace=self.drain_grace)
        victim.shrink_target = target
        victim.drain_started = time.monotonic()
        victim.drains += 1
        self.metrics.inc("fleet_drains_requested_total")
        self._log("shrinking job %s to %d worker(s) (drain of %s) to "
                  "fit job %s (priority %d > %d)"
                  % (victim.name, target, drain_wids, for_job.name,
                     for_job.spec.priority, victim.spec.priority))

    def _preempt(self, victim, for_job):
        """Whole-job drain: victim durable-commits and hands back every
        host; restored when capacity returns."""
        victim.driver.request_drain("all", grace=self.drain_grace)
        victim.state = DRAINING
        victim.drain_started = time.monotonic()
        victim.drains += 1
        self.metrics.inc("fleet_drains_requested_total")
        self._log("preempting job %s (priority %d) for job %s "
                  "(priority %d)"
                  % (victim.name, victim.spec.priority, for_job.name,
                     for_job.spec.priority))

    def _finish_shrinks(self, now):
        """Releases the slots a completed partial drain freed (leased
        minus live, bounded so a concurrent crash cannot strangle the
        victim's respawn headroom)."""
        for job in self.jobs.values():
            if job.shrink_target is None or job.driver is None:
                continue
            if job.driver.draining():
                continue
            live = job.driver.live_per_host()
            target = max(job.shrink_target, job.spec.min_np)
            excess = self.pool.leased_slots_of(job.name) - max(
                sum(live.values()), target)
            for host, leased in sorted(
                    self.pool.lease_of(job.name).items()):
                if excess <= 0:
                    break
                releasable = min(excess, leased - live.get(host, 0))
                if releasable > 0:
                    self.pool.release(job.name, host, releasable)
                    excess -= releasable
            job.shrink_target = None
            if job.drain_started is not None:
                self.metrics.observe("fleet_drain_seconds",
                                     now - job.drain_started)
                job.drain_started = None
            self.metrics.inc("fleet_shrinks_total")
            self._capacity_event(now)
            self._log("job %s shrink complete; slots reclaimed"
                      % job.name)

    def _grow_running(self, now):
        """Leases free slots back to running jobs below their max_np —
        the grow half of restore — but never while higher-or-equal
        priority work is waiting for those slots."""
        waiting = self._waiting(now)
        for job in sorted(self.jobs.values(),
                          key=lambda j: -j.spec.priority):
            if job.state != RUNNING or job.driver is None:
                continue
            if job.shrink_target is not None or job.driver.draining():
                continue
            if any(w.spec.priority >= job.spec.priority for w in waiting):
                continue
            leased = self.pool.leased_slots_of(job.name)
            room = job.spec.max_np - leased
            free = self.pool.free_slots()
            if room <= 0 or free <= 0:
                continue
            extra = self.pool.lease(job.name, min(room, free),
                                    min_slots=1,
                                    placement=job.spec.placement)
            if extra:
                grown = sum(extra.values())
                job.driver.resize(leased + grown)
                self.metrics.inc("fleet_grows_total", grown)
                self._log("job %s grown by %d slot(s) (%s)"
                          % (job.name, grown, extra))

    # -- chaos -------------------------------------------------------------
    def _defer_chaos(self, ev):
        """Re-arms an event whose target is not currently running
        (mid-restart, still pending, being drained): the schedule says
        the job EATS this fault, so it fires at the next tick the
        target is back — only a terminal target consumes it unfired."""
        target = self.jobs.get(ev.job)
        if ev.job != "*" and target is not None and \
                target.state in TERMINAL:
            self._log("chaos: dropping %s for job %s (already %s)"
                      % (ev.action, ev.job, target.state))
            return
        if ev.job == "*" and all(j.state in TERMINAL
                                 for j in self.jobs.values()):
            return
        ev.fired -= 1

    def _apply_chaos(self, now):
        if self._chaos is None:
            return
        for ev in self._chaos.due(now - self._start):
            running = [j for j in self.jobs.values()
                       if j.state == RUNNING and j.driver is not None]
            if ev.action == "kill":
                pool = ([j for j in running if j.name == ev.job]
                        if ev.job != "*" else running)
                name = self._chaos.pick([j.name for j in pool])
                if name is None:
                    self._defer_chaos(ev)
                    continue
                job = self.jobs[name]
                wid = self._chaos.pick(job.driver.live_workers())
                pid = (job.driver.worker_pid(wid)
                       if wid is not None else None)
                if pid is None:
                    # RUNNING but momentarily workerless (mid-respawn)
                    # or the pick raced the worker's exit: same
                    # contract as a non-running target — the event
                    # re-arms rather than being silently eaten, so the
                    # seeded schedule stays deterministic.
                    self._defer_chaos(ev)
                    continue
                self._log("chaos: SIGKILL job %s worker %d (pid %d)"
                          % (job.name, wid, pid))
                try:
                    os.killpg(os.getpgid(pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                self.metrics.inc("fleet_kills_injected_total")
            elif ev.action == "preempt":
                pool = ([j for j in running if j.name == ev.job]
                        if ev.job != "*" else running)
                name = self._chaos.pick([j.name for j in pool])
                if name is None:
                    self._defer_chaos(ev)
                    continue
                job = self.jobs[name]
                self._log("chaos: forced preemption of job %s"
                          % job.name)
                self._preempt(job, job)
                self.metrics.inc("fleet_preempts_injected_total")

    # -- gauges / views ----------------------------------------------------
    def _update_gauges(self):
        by_state = {s: 0 for s in (PENDING, RUNNING, DRAINING,
                                   PREEMPTED, DONE, FAILED)}
        for job in self.jobs.values():
            by_state[job.state] += 1
        for state, n in by_state.items():
            self.metrics.set_gauge("fleet_jobs_%s" % state, n)
        hosts = self.pool.host_states()
        for state in ("free", "leased", "blacklisted"):
            self.metrics.set_gauge(
                "fleet_hosts_%s" % state,
                sum(1 for h in hosts.values() if h["state"] == state))
        self.metrics.set_gauge("fleet_slots_free", self.pool.free_slots())
        self.metrics.set_gauge(
            "fleet_slots_leased",
            sum(h["leased"] for h in hosts.values()))

    def _check_occupancy(self):
        live_by_job = {name: job.live_per_host()
                       for name, job in self.jobs.items()
                       if job.driver is not None}
        violated = self.pool.check_occupancy(live_by_job)
        if violated:
            self.metrics.inc("fleet_occupancy_violations_total")
            self._log("OCCUPANCY VIOLATION on host(s) %s — this is a "
                      "fleet bug" % violated)
        return violated

    def view(self):
        """The /fleet JSON document (hvd-top --fleet renders it)."""
        now = time.monotonic()
        jobs = {}
        for name, job in sorted(self.jobs.items()):
            last_durable = None
            if job.spec.ckpt_dir and os.path.isdir(job.spec.ckpt_dir):
                try:
                    from horovod_tpu_torch.elastic.durable import \
                        last_durable_step
                    step, _ = last_durable_step(job.spec.ckpt_dir)
                    last_durable = step
                except Exception:
                    last_durable = None
            jobs[name] = {
                "state": job.state,
                "kind": job.spec.kind,
                "placement": job.spec.placement,
                "priority": job.spec.priority,
                "np": job.spec.np,
                "min_np": job.spec.min_np,
                "live": job.live(),
                "leased": self.pool.leased_slots_of(name),
                "drains": job.drains,
                "preemptions": job.preemptions,
                "restores": job.restores,
                "restarts": job.restarts,
                "rc": job.rc,
                "last_durable_step": last_durable,
                "age_seconds": (now - job.admitted_at
                                if job.admitted_at else None),
            }
        return {
            "t": (now - self._start) if self._start else 0.0,
            "jobs": jobs,
            "hosts": self.pool.host_states(),
            "free_slots": self.pool.free_slots(),
            "counters": self.metrics.snapshot()["counters"],
        }

    # -- main loop ---------------------------------------------------------
    def _tick_once(self, now):
        self.pool.refresh()
        self._apply_chaos(now)
        # Reap finished driver threads.
        for job in self.jobs.values():
            if job.thread is not None and not job.thread.is_alive():
                self._reap_job(job, now)
        self._finish_shrinks(now)
        # Admission in priority order; a job that cannot fit may earn
        # its slots by preemption, in which case admission waits for
        # the drains to land (no lease is held meanwhile).
        draining = any(j.state == DRAINING or (
            j.driver is not None and j.driver.draining())
            for j in self.jobs.values())
        for job in sorted(self._waiting(now),
                          key=lambda j: (-j.spec.priority,
                                         j.spec.arrival, j.name)):
            if now < job.next_try:
                continue
            if self._try_admit(job, now):
                continue
            if not draining and self._preempt_for(job):
                draining = True
        self._grow_running(now)
        self._sync_pool_counters()
        self._update_gauges()
        self._check_occupancy()

    def _sync_pool_counters(self):
        refusals = self.pool.oversubscription_refusals
        have = self.metrics.get("fleet_oversubscription_refusals_total")
        if refusals > have:
            self.metrics.inc("fleet_oversubscription_refusals_total",
                             refusals - have)

    def run(self, timeout=None):
        """Supervises until every job is terminal. Returns 0 when all
        completed, 1 when any failed (or the timeout expired)."""
        self._start = time.monotonic()
        deadline = (self._start + timeout) if timeout else None
        try:
            while True:
                now = time.monotonic()
                self._tick_once(now)
                states = [j.state for j in self.jobs.values()]
                if states and all(s in TERMINAL for s in states):
                    break
                if deadline and now > deadline:
                    self._log("fleet timeout after %.0fs; tearing down"
                              % timeout)
                    self.shutdown()
                    return 1
                time.sleep(self._tick)
        except KeyboardInterrupt:
            self._log("interrupted; tearing down")
            self.shutdown()
            return 1
        self._update_gauges()
        failed = [j.name for j in self.jobs.values()
                  if j.state == FAILED]
        if failed:
            self._log("fleet finished with FAILED job(s): %s"
                      % ", ".join(sorted(failed)))
            return 1
        self._log("fleet finished: all %d job(s) completed"
                  % len(self.jobs))
        return 0

    def shutdown(self):
        for job in self.jobs.values():
            if job.driver is not None:
                job.driver.terminate()
        for job in self.jobs.values():
            if job.thread is not None:
                job.thread.join(timeout=30)
                job.thread = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
