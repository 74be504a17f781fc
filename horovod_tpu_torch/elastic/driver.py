"""Elastic driver: the launcher-side supervisor loop.

A copy of ``horovod_tpu/elastic/driver.py`` for the port (Horovod's
``horovod/run/elastic/driver.py``: ElasticDriver, worker monitoring, host
blacklisting, rank reassignment, respawn) over the port's rendezvous KV
and middleman-wrapped process tree. It imports no torch.

Replaces the static launcher's kill-all-on-first-exit behavior: a failed
worker shrinks the job (its host goes on the backoff blacklist, the
generation number is bumped, and survivors re-rendezvous at the reduced
size), a recovered host grows it back (a replacement worker is spawned
and absorbed at the next generation) — all without restarting the
surviving worker processes.

Membership is published to the driver-owned rendezvous server at scope
``elastic`` / key ``state``::

    {"generation": g, "size": n,
     "assignment": {"<worker_id>": rank, ...},
     "status": "running" | "shutdown"}

Worker ids are stable per spawned process; ranks are reassigned every
generation in worker-id order, so the longest-lived worker is always the
new rank 0 (the state-sync root).

Each worker also holds a local slot on its host for its whole life
(``"slots": {"<worker_id>": slot}`` in the state above, and
``HVD_TPU_LOCAL_SLOT`` in its env): the lowest slot no live worker on
the host holds when it is spawned. A worker's local rank, and so its
GPU, is its slot in every generation (``run/util.py``'s
``topology_of``), so a replacement takes a freed slot and never a
survivor's, and two ranks on one host never share a GPU. The reference
reassigns local ranks by worker id each generation.
"""

import collections
import itertools
import json
import os
import signal
import sys
import threading
import time

from horovod_tpu_torch.run import rendezvous, util

from .discovery import HostManager, plan_spawns
from .state import EXIT_DRAINED, KEY_DRAIN, KEY_STATE, SCOPE_ELASTIC

_Slot = collections.namedtuple("_Slot", ["hostname", "rank"])


class _Worker:
    def __init__(self, worker_id, hostname, proc, slot):
        self.worker_id = worker_id
        self.hostname = hostname
        self.proc = proc
        self.slot = slot  # local slot on its host, kept for its life
        self.started = time.monotonic()
        self.healthy = False  # outlived the health window at least once


class ElasticDriver:
    """Supervises elastic workers; returns the job's exit code from
    :meth:`run`."""

    def __init__(self, command, discovery, min_np, max_np,
                 np_initial=None, ssh_port=None, start_timeout=60,
                 verbose=False, env=None, ckpt_dir=None,
                 restart_from_ckpt=False, drain_grace=None,
                 health_sink=None, placement="pack"):
        if min_np < 1 or max_np < min_np:
            raise ValueError("need 1 <= min_np <= max_np (got %d..%d)"
                             % (min_np, max_np))
        self._command = list(command)
        self._placement = placement
        self._min_np = min_np
        self._max_np = max_np
        self._np_initial = np_initial
        self._ssh_port = ssh_port
        self._start_timeout = start_timeout
        self._verbose = verbose
        self._base_env = dict(env if env is not None else os.environ)
        self._ckpt_dir = ckpt_dir or self._base_env.get("HVD_TPU_CKPT_DIR")
        self._restart_from_ckpt = restart_from_ckpt and self._ckpt_dir
        self._restarts = 0
        self._max_restarts = int(os.environ.get(
            "HVD_TPU_CKPT_MAX_RESTARTS", "3"))
        cooldown = float(os.environ.get("HVD_TPU_ELASTIC_COOLDOWN", "10"))
        self._hosts = HostManager(discovery, cooldown=cooldown)
        # Optional mirror for host-health evidence (record_failure /
        # record_success): the fleet controller passes its
        # PlacementPool here so one tenant's crashing host blacklists
        # fleet-wide, not just within the observing job.
        self._health_sink = health_sink
        self._discovery_interval = float(
            os.environ.get("HVD_TPU_ELASTIC_DISCOVERY_INTERVAL", "1.0"))

        self._workers = {}  # worker_id -> _Worker
        self._next_worker_id = 0
        self._generation = -1  # first publish makes it 0
        self._published_at = 0.0
        self._published_size = 0
        self._job_done = False
        self._late_rcs = []

        # Graceful drain (docs/FLEET.md): the supervisor-side half of
        # the protocol. `_drain_epoch` numbers the published requests;
        # `_drain_victims` holds the worker ids the current epoch
        # covers (escalated with SIGKILL at `_drain_deadline`);
        # `_draining_all` marks a whole-job drain, whose completion
        # makes run() return EXIT_DRAINED instead of tearing down.
        self._drain_grace = drain_grace
        self._drain_epoch = 0
        self._drain_completed = 0
        self._drain_victims = set()
        self._drain_deadline = None
        self._draining_all = False
        self._term_requested = False
        self._abort = False
        # Guards the drain bookkeeping: request_drain runs on the
        # FLEET CONTROLLER's thread while the run loop's tombstone
        # check runs on the driver thread — without the lock, the loop
        # slipping between the epoch bump and the victim registration
        # would tombstone the brand-new epoch as already-completed, and
        # the live drain record would then never be tombstoned (late
        # replacement workers would keep re-acting on it).
        self._drain_lock = threading.Lock()

        self._secret = rendezvous.make_secret()
        self._server = rendezvous.RendezvousServer(key=self._secret)
        self._addr = None

    # -- worker spawn ------------------------------------------------------
    def _free_slot(self, hostname):
        """The lowest local slot on ``hostname`` that no live worker
        holds."""
        taken = {w.slot for w in self._workers.values()
                 if w.hostname == hostname}
        return next(s for s in itertools.count() if s not in taken)

    def _worker_env(self, worker_id, slot):
        from horovod_tpu_torch.run.run import worker_base_env
        env = worker_base_env(self._base_env)
        for key in ("HVD_TPU_ADDRS", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                    "HVD_TPU_LOCAL_RANK", "HVD_TPU_LOCAL_SIZE",
                    "HVD_TPU_CROSS_RANK", "HVD_TPU_CROSS_SIZE",
                    "HVD_TPU_GENERATION", "HVD_TPU_SLOTS"):
            env.pop(key, None)
        env.update({
            "HVD_TPU_ELASTIC": "1",
            "HVD_TPU_WORKER_ID": str(worker_id),
            "HVD_TPU_LOCAL_SLOT": str(slot),
            "HVD_TPU_RENDEZVOUS_ADDR": self._addr,
            rendezvous.KEY_ENV: self._secret,
        })
        if self._ckpt_dir:
            # Durable checkpoints (docs/ELASTIC.md "Durability"): every
            # worker — including replacements spawned mid-job and the
            # fresh cohort of a --restart-from-ckpt relaunch — writes
            # to and auto-resumes from the same directory.
            env["HVD_TPU_CKPT_DIR"] = self._ckpt_dir
        env.setdefault("HVD_TPU_START_TIMEOUT", str(self._start_timeout))
        return env

    def _spawn(self, hostname):
        from horovod_tpu_torch.run.run import launch

        wid = self._next_worker_id
        self._next_worker_id += 1
        local_slot = self._free_slot(hostname)
        proc = launch([_Slot(hostname=hostname, rank=wid)],
                      [self._worker_env(wid, local_slot)], self._command,
                      ssh_port=self._ssh_port, verbose=self._verbose)[0]
        self._workers[wid] = _Worker(wid, hostname, proc, local_slot)
        if self._verbose:
            sys.stderr.write("[elastic] spawned worker %d on %s slot %d\n"
                             % (wid, hostname, local_slot))
        return wid

    # -- membership publication --------------------------------------------
    def _put_state(self, status):
        """Publishes the current generation's membership; returns its
        size."""
        assignment = {str(wid): rank for rank, wid in
                      enumerate(sorted(self._workers))}
        self._server.put_local(SCOPE_ELASTIC, KEY_STATE, json.dumps({
            "generation": self._generation,
            "size": len(assignment),
            "assignment": assignment,
            "slots": {str(wid): w.slot for wid, w in self._workers.items()},
            "status": status,
        }))
        return len(assignment)

    def _publish(self, status="running"):
        self._generation += 1
        size = self._put_state(status)
        self._published_at = time.monotonic()
        self._published_size = size
        if self._verbose:
            sys.stderr.write("[elastic] generation %d: %s\n"
                             % (self._generation, {
                                 wid: (rank, self._workers[wid].slot)
                                 for rank, wid in
                                 enumerate(sorted(self._workers))}))

    def _publish_done(self):
        """Re-publishes the current generation with status \"done\": a
        replacement still waiting in bootstrap/rendezvous when training
        finishes has no generation left to join — it must exit cleanly
        instead of timing out with a failure rc. Generation is NOT
        bumped, so workers mid-training are not interrupted."""
        self._put_state("done")

    def _generation_resolved(self):
        """True when the current generation needs no rendezvous
        (size <= 1) or its rendezvous published a resolved table."""
        if self._published_size <= 1:
            return True
        resolved = self._server.scope_items(
            rendezvous.gen_scope(rendezvous.SCOPE_RESOLVED,
                                 self._generation))
        return "table" in resolved

    def _generation_stalled(self):
        """True when the current generation's rendezvous has not
        converged (no resolved table) within the start timeout — e.g. a
        participant died mid-rendezvous without the driver noticing an
        exit. Bumping the generation unsticks the survivors."""
        if self._published_size <= 1:
            return False  # size-1 generations do not rendezvous
        if time.monotonic() - self._published_at < self._start_timeout:
            return False
        return not self._generation_resolved()

    def _generation_ready(self):
        """Growth gate: True once the CURRENT generation either has a
        resolved rendezvous or has provably stalled (the stall path
        bumps it anyway). Publishing a grow-generation while the
        current one is still rendezvousing strands late-arriving
        survivors in the superseded scope: after a shrink, the
        survivors re-bootstrap a second or two apart (connection-loss
        detection and reconnect windows are not synchronized across
        ranks), and if the blacklist cooldown expires inside that gap
        the respawn used to bump the generation between their
        bootstraps — one survivor then waited in gen N and the other in
        gen N+1 until both timed out. (Within the start-timeout window
        the stalled check short-circuits on time, so an unresolved
        generation costs one scope lookup per tick, not two.)"""
        return self._generation_resolved() or self._generation_stalled()

    def _reinit_requested(self):
        """True when any live worker published a reinit request for the
        current (or a newer) generation — its core lost a peer connection
        without any process exiting."""
        for key, val in self._server.scope_items(SCOPE_ELASTIC).items():
            if not key.startswith("reinit/"):
                continue
            try:
                if int(val.decode()) >= self._generation:
                    return True
            except ValueError:
                continue
        return False

    # -- monitoring --------------------------------------------------------
    def _reap(self):
        """Collects exited workers. Returns True when membership changed
        due to a failure."""
        changed = False
        health_after = min(10.0, self._start_timeout)
        now = time.monotonic()
        for wid, w in list(self._workers.items()):
            rc = w.proc.poll()
            if rc is None:
                if not w.healthy and now - w.started > health_after:
                    w.healthy = True
                    self._hosts.record_success(w.hostname,
                                               started_at=w.started)
                    if self._health_sink is not None:
                        self._health_sink.record_success(
                            w.hostname, started_at=w.started)
                continue
            del self._workers[wid]
            if rc == 0:
                if not self._job_done:
                    self._job_done = True
                    self._publish_done()
                if self._verbose:
                    sys.stderr.write(
                        "[elastic] worker %d finished\n" % wid)
            elif rc == EXIT_DRAINED or wid in self._drain_victims:
                # Voluntary exit (graceful drain / preemption hand-back,
                # incl. a victim the grace escalation had to SIGKILL):
                # the host is healthy by definition — it re-enters the
                # spawnable pool immediately instead of tripping the
                # failure blacklist's backoff cooldown. Membership still
                # changed, so survivors repartition at a new generation.
                self._drain_victims.discard(wid)
                self._hosts.record_release(w.hostname)
                sys.stderr.write(
                    "[elastic] worker %d on %s drained (%s); host "
                    "released without blacklist\n"
                    % (wid, w.hostname,
                       "rc=%d" % rc if rc == EXIT_DRAINED
                       else "escalated, rc=%d" % rc))
                if not self._job_done:
                    changed = True
            elif self._job_done:
                self._late_rcs.append(rc)
            else:
                sys.stderr.write(
                    "[elastic] worker %d on %s failed (rc=%d); "
                    "blacklisting host with backoff\n"
                    % (wid, w.hostname, rc))
                self._hosts.record_failure(w.hostname)
                if self._health_sink is not None:
                    self._health_sink.record_failure(w.hostname)
                changed = True
        return changed

    def _plan_growth(self):
        """Hosts with free, non-blacklisted slots to spawn on (one entry
        per new worker), capped at max_np. The planning rule itself is
        the shared `plan_spawns` — the fleet controller plans multi-job
        placements with the same function."""
        if self._job_done or self._draining_all:
            return []
        live_per_host = collections.Counter(
            w.hostname for w in self._workers.values())
        return plan_spawns(self._hosts.available_hosts_and_slots(),
                           live_per_host,
                           self._max_np - len(self._workers),
                           placement=self._placement)

    def _kill_all(self):
        for w in self._workers.values():
            try:
                os.killpg(os.getpgid(w.proc.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass

    # -- graceful drain (supervisor side; docs/FLEET.md) -------------------
    def request_drain(self, victims="all", grace=None):
        """Publishes a drain request: the victim workers finish their
        in-flight step, force a durable commit of exactly that step,
        and exit with EXIT_DRAINED (elastic/run.py honors it at the
        next commit's agreement allreduce). `victims` is "all" or a
        list of worker ids; `grace` the seconds before the driver
        escalates to SIGKILL. Thread-safe enough for the fleet
        controller's call pattern (one supervisor thread per job plus
        the controller thread requesting drains)."""
        if grace is None:
            grace = self._drain_grace if self._drain_grace else 30.0
        with self._drain_lock:
            self._drain_epoch += 1
            if victims == "all":
                self._drain_victims.update(self._workers)
                self._draining_all = True
                wire_victims = "all"
            else:
                wire_victims = [str(v) for v in victims]
                self._drain_victims.update(int(v) for v in wire_victims)
            self._server.put_local(SCOPE_ELASTIC, KEY_DRAIN, json.dumps({
                "epoch": self._drain_epoch,
                "workers": wire_victims,
                "grace": grace,
            }))
            self._drain_deadline = time.monotonic() + grace
        sys.stderr.write(
            "[elastic] drain epoch %d requested for worker(s) %s "
            "(grace %.0fs)\n" % (self._drain_epoch, wire_victims, grace))

    def draining(self):
        """True while a drain epoch has victims that have not exited."""
        return bool(self._drain_victims)

    def _escalate_drain(self):
        """SIGKILLs drain victims that outlived the grace window (a
        worker wedged in a collective cannot reach its next commit to
        notice the request). Their exits still count as voluntary —
        the ESCALATION was planned, the host is not failure-suspect."""
        if self._drain_deadline is None or \
                time.monotonic() < self._drain_deadline:
            return
        for wid in sorted(self._drain_victims):
            w = self._workers.get(wid)
            if w is None:
                self._drain_victims.discard(wid)
                continue
            sys.stderr.write(
                "[elastic] drain grace expired; escalating to SIGKILL "
                "for worker %d\n" % wid)
            try:
                os.killpg(os.getpgid(w.proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        self._drain_deadline = None

    # -- durable-checkpoint restart (--restart-from-ckpt) -----------------
    def _report_last_durable(self):
        """Names the newest durable step in the teardown summary, so an
        operator knows exactly what a restart recovers (nothing, when
        durability was off or no checkpoint ever published)."""
        if not self._ckpt_dir:
            return
        from .durable import describe_last_durable
        sys.stderr.write(
            "[elastic] %s\n" % describe_last_durable(self._ckpt_dir))

    def _teardown_workers(self, grace=10.0):
        """Kills every remaining worker (SIGTERM, then SIGKILL after
        `grace`) and reaps them WITHOUT blacklisting their hosts — a
        deliberate restart kill is not host evidence."""
        self._kill_all()
        deadline = time.monotonic() + grace
        while self._workers:
            for wid, w in list(self._workers.items()):
                if w.proc.poll() is not None:
                    del self._workers[wid]
            if not self._workers:
                break
            if time.monotonic() > deadline:
                for w in self._workers.values():
                    try:
                        os.killpg(os.getpgid(w.proc.pid), signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        pass
                for w in self._workers.values():
                    try:
                        w.proc.wait(timeout=5)
                    except Exception:
                        pass
                self._workers = {}
                break
            time.sleep(0.1)

    def _try_restart_from_ckpt(self, reason):
        """Full-job restart instead of teardown: kill whatever is left,
        clear the host blacklist, wait for discovery to offer at least
        --min-np slots again, and spawn a fresh cohort that auto-resumes
        from the newest valid durable manifest. Returns True when the
        restart was performed (the caller continues supervising)."""
        if not self._restart_from_ckpt:
            return False
        if self._restarts >= self._max_restarts:
            sys.stderr.write(
                "[elastic] restart budget exhausted (%d/%d); tearing "
                "down for real\n" % (self._restarts, self._max_restarts))
            return False
        self._restarts += 1
        from .durable import last_durable_step
        step, _ = last_durable_step(self._ckpt_dir)
        sys.stderr.write(
            "[elastic] %s; full-job restart %d/%d from durable "
            "checkpoint (last durable step: %s)\n"
            % (reason, self._restarts, self._max_restarts,
               step if step is not None else "none — fresh start"))
        self._teardown_workers()
        self._hosts.reset()
        deadline = time.monotonic() + self._start_timeout
        while True:
            self._hosts.refresh()
            capacity = sum(
                self._hosts.available_hosts_and_slots().values())
            if capacity >= self._min_np:
                break
            if time.monotonic() > deadline:
                sys.stderr.write(
                    "[elastic] restart aborted: discovery offered %d "
                    "slot(s) < --min-np=%d within %ds\n"
                    % (capacity, self._min_np, int(self._start_timeout)))
                return False
            time.sleep(self._discovery_interval)
        target = min(self._np_initial or capacity, self._max_np, capacity)
        for host in self._plan_growth()[:target]:
            self._spawn(host)
        self._publish()
        return True

    # -- fleet-controller surface (horovod_tpu/fleet/controller.py; the
    # port's fleet is ROADMAP A8f) -----------------------------------------
    def live_per_host(self):
        """{host: live worker count} — the controller's occupancy view
        (snapshot read; safe from another thread under the GIL)."""
        counts = collections.Counter(
            w.hostname for w in self._workers.values())
        return dict(counts)

    def live_workers(self):
        """Sorted live worker ids (chaos kill-victim candidates)."""
        return sorted(self._workers)

    def worker_hosts(self):
        """{worker id: hostname} for live workers — serve endpoint
        discovery needs the HOST each replica landed on, not just its
        id (snapshot read; safe from another thread under the GIL)."""
        return {wid: w.hostname for wid, w in self._workers.items()}

    def worker_pid(self, wid):
        w = self._workers.get(wid)
        return w.proc.pid if w is not None else None

    def resize(self, max_np):
        """Moves the growth ceiling (the fleet controller shrinks it
        before a partial drain so the driver does not regrow into the
        slots it is handing back, and raises it again when capacity is
        leased back)."""
        self._max_np = max(1, int(max_np))

    def terminate(self):
        """Hard teardown from the controller (fleet shutdown): the run
        loop kills the workers and returns 1 at its next tick."""
        self._abort = True

    # -- main loop ---------------------------------------------------------
    def run(self, install_signal_handlers=True):
        """Supervises the job; returns its exit code. The fleet
        controller runs one driver per job in a worker THREAD and
        passes install_signal_handlers=False (signal.signal is
        main-thread-only; the controller owns the process's signals)."""
        local_addr = self._base_env.get("HVD_TPU_RENDEZVOUS_HOST")
        self._hosts.refresh()
        hosts = self._hosts.available_hosts_and_slots()
        if local_addr is None:
            remote = [h for h in hosts if not util.is_local_host(h)]
            local_addr = (rendezvous.routable_ip(remote[0]) if remote
                          else "127.0.0.1")
        self._addr = "%s:%d" % (local_addr, self._server.start())
        if not install_signal_handlers:
            try:
                return self._run_loop()
            finally:
                self._server.stop()

        def on_signal(signum, frame):
            if signum == signal.SIGTERM and self._drain_grace:
                # Preemption-style SIGTERM (fleet controller, cluster
                # manager): drain instead of killing — workers finish
                # the in-flight step, durable-commit it, and exit
                # cleanly; the loop escalates at grace expiry and
                # run() returns EXIT_DRAINED.
                self._term_requested = True
                return
            self._publish(status="shutdown")
            self._kill_all()
            sys.exit(1)

        old_int = signal.signal(signal.SIGINT, on_signal)
        old_term = signal.signal(signal.SIGTERM, on_signal)
        try:
            return self._run_loop()
        finally:
            signal.signal(signal.SIGINT, old_int)
            signal.signal(signal.SIGTERM, old_term)
            self._server.stop()

    def _run_loop(self):
        # Initial cohort: -np (clamped to capacity and max_np); spawning
        # less than min_np up front is a hard error — elasticity begins
        # once a valid job exists.
        capacity = sum(self._hosts.available_hosts_and_slots().values())
        target = min(self._np_initial or capacity, self._max_np, capacity)
        if target < self._min_np:
            raise RuntimeError(
                "elastic launch needs at least --min-np=%d slots but "
                "discovery found %d" % (self._min_np, capacity))
        plan = self._plan_growth()[:target]
        below_min_since = None
        last_discovery = 0.0
        while True:
            if plan and (self._job_done or self._draining_all):
                # Completion (or a whole-job drain) won the race against
                # a planned grow — spawning into a finished/draining job
                # would strand a worker outside the drain epoch.
                plan = []
            if plan:
                # Spawn first (allocating the new worker ids), then
                # publish one assignment covering old + new workers.
                # Ordering is race-free either way: starting workers
                # poll the assignment until their id appears, and live
                # workers notice the bumped generation at their next
                # commit.
                for host in plan:
                    self._spawn(host)
                self._publish()
                plan = []
            time.sleep(0.1)
            if self._abort:
                self._publish(status="shutdown")
                self._teardown_workers()
                return 1
            if self._term_requested and not self._draining_all:
                self.request_drain("all")
            self._escalate_drain()
            changed = self._reap()
            with self._drain_lock:
                if not self._drain_victims:
                    self._drain_deadline = None
                    if self._drain_epoch > self._drain_completed and \
                            not self._draining_all:
                        # Tombstone the completed epoch: a replacement
                        # spawned AFTER a partial drain must fast-forward
                        # past the stale record instead of re-acting on
                        # it (elastic/run.py reads `done` as
                        # already-honored).
                        self._drain_completed = self._drain_epoch
                        self._server.put_local(
                            SCOPE_ELASTIC, KEY_DRAIN, json.dumps({
                                "epoch": self._drain_epoch, "workers": [],
                                "grace": 0, "done": True}))
            if self._job_done:
                if not self._workers:
                    return max(self._late_rcs, default=0)
                continue  # let the rest finish; no more respawns
            if self._draining_all and not self._workers:
                # Whole-job drain complete: every worker durable-
                # committed and handed its host back. EXIT_DRAINED (not
                # 1) tells the supervisor this was the requested
                # preemption, restorable from the durable lineage.
                self._publish(status="shutdown")
                self._report_last_durable()
                sys.stderr.write(
                    "[elastic] drain complete; job preempted cleanly\n")
                return EXIT_DRAINED
            if not changed and self._reinit_requested():
                sys.stderr.write("[elastic] reinit requested by a worker; "
                                 "bumping generation\n")
                changed = True
            if not changed and self._generation_stalled():
                sys.stderr.write("[elastic] generation %d stalled; "
                                 "bumping\n" % self._generation)
                changed = True

            now = time.monotonic()
            if now - last_discovery > self._discovery_interval:
                last_discovery = now
                self._hosts.refresh()
            # Growth only once the current generation has converged (or
            # stalled) — see _generation_ready. Shrink/failure bumps are
            # not gated: a dead worker must repartition immediately.
            plan = self._plan_growth() if self._generation_ready() else []

            if self._draining_all:
                # Victims are exiting by design; the below-min teardown
                # and restart-from-ckpt paths must not fire on the way
                # down (the drain-complete check above owns the exit).
                continue
            if len(self._workers) + len(plan) < self._min_np:
                plan = []
                if not self._workers:
                    if self._try_restart_from_ckpt(
                            "no workers left and no spawnable hosts"):
                        below_min_since = None
                        continue
                    self._publish(status="shutdown")
                    self._report_last_durable()
                    sys.stderr.write(
                        "[elastic] no workers left and no spawnable "
                        "hosts; failing the job\n")
                    return 1
                if below_min_since is None:
                    below_min_since = now
                elif now - below_min_since > self._start_timeout:
                    if self._try_restart_from_ckpt(
                            "stuck below --min-np=%d for %ds"
                            % (self._min_np, int(self._start_timeout))):
                        below_min_since = None
                        continue
                    sys.stderr.write(
                        "[elastic] stuck below --min-np=%d for %ds; "
                        "tearing down\n"
                        % (self._min_np, int(self._start_timeout)))
                    self._publish(status="shutdown")
                    self._report_last_durable()
                    self._kill_all()
                    return 1
                continue
            below_min_since = None
            if changed and not plan:
                self._publish()
            # When plan is non-empty (with or without a membership
            # change), the top of the next iteration spawns the new
            # workers first — allocating their worker ids — and then
            # publishes one combined assignment.


def run_elastic(np_, discovery, command, min_np, max_np, ssh_port=None,
                start_timeout=60, verbose=False, env=None,
                ckpt_dir=None, restart_from_ckpt=False,
                drain_grace=None):
    """Launcher entry: supervise `command` elastically. Returns exit
    code (EXIT_DRAINED after a SIGTERM-driven graceful drain when
    `drain_grace` is set)."""
    driver = ElasticDriver(command, discovery, min_np, max_np,
                           np_initial=np_, ssh_port=ssh_port,
                           start_timeout=start_timeout, verbose=verbose,
                           env=env, ckpt_dir=ckpt_dir,
                           restart_from_ckpt=restart_from_ckpt,
                           drain_grace=drain_grace)
    return driver.run()
