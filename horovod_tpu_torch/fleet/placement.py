"""Placement library shared by the fleet controller and the single-job
elastic driver: a copy of ``horovod_tpu/fleet/placement.py`` for the port.

Two layers:

* :func:`plan_spawns` — the pure spawn-planning rule the elastic
  driver's growth path has always used (refactored out of
  ``elastic/driver.py`` into ``elastic/discovery.py`` so one
  implementation serves both consumers; re-exported here): given the
  available inventory, the live per-host occupancy, and the remaining
  room, list the hosts to spawn on (one entry per worker).

* :class:`PlacementPool` — the fleet controller's ledger over the host
  inventory: slot-granular leases per job, gang grants (all-or-nothing
  at ``min_slots``), voluntary release vs. failure blacklisting (via the
  shared :class:`~horovod_tpu_torch.elastic.discovery.HostManager`), and the
  oversubscription invariant: the pool REFUSES any lease that would put
  a host's leased slot total above its capacity, and counts every
  refusal-worthy request in ``oversubscription_refusals`` — the fleet
  chaos e2e asserts the observed occupancy never exceeds capacity.
"""

import threading

# plan_spawns LIVES in the elastic layer (the base layer both consumers
# sit on) and is re-exported here as part of the placement library's
# public face — fleet importing elastic keeps the dependency pointing
# one way (fleet -> elastic, never the reverse).
from horovod_tpu_torch.elastic.discovery import HostManager, plan_spawns  # noqa: F401


class PlacementPool:
    """Slot-granular host leases for N concurrent jobs.

    The pool wraps a :class:`HostManager` (discovery + per-host failure
    blacklist with exponential backoff) and tracks, per host, how many
    slots each job holds. Lease-ledger mutations are controller-thread
    only (the lock exists for the metrics/view readers);
    ``record_failure``/``record_success`` additionally arrive from the
    per-job driver threads (their health evidence is mirrored here so
    one tenant's crashing host blacklists fleet-wide) — single-dict-op
    updates on the HostManager, safe under the GIL."""

    def __init__(self, discovery, cooldown=10.0, max_backoff=600.0,
                 clock=None):
        kwargs = {"cooldown": cooldown, "max_backoff": max_backoff}
        if clock is not None:
            kwargs["clock"] = clock
        self._hosts = HostManager(discovery, **kwargs)
        self._lock = threading.Lock()
        self._leases = {}  # host -> {job_name: slots}
        self.oversubscription_refusals = 0

    # -- inventory ---------------------------------------------------------
    def refresh(self):
        return self._hosts.refresh()

    def record_failure(self, host):
        """Failure evidence (a worker on `host` crashed): backoff
        blacklist, shared across every job in the fleet."""
        self._hosts.record_failure(host)

    def record_success(self, host, started_at=None):
        self._hosts.record_success(host, started_at=started_at)

    def inventory(self):
        """{host: slots} — discovered minus blacklisted."""
        return self._hosts.available_hosts_and_slots()

    def is_blacklisted(self, host):
        return self._hosts.is_blacklisted(host)

    # -- lease ledger ------------------------------------------------------
    def _leased_slots(self, host):
        return sum(self._leases.get(host, {}).values())

    def free_by_host(self):
        """{host: free slots} over the non-blacklisted inventory."""
        out = {}
        with self._lock:
            for host, slots in self.inventory().items():
                free = slots - self._leased_slots(host)
                if free > 0:
                    out[host] = free
        return out

    def free_slots(self):
        return sum(self.free_by_host().values())

    def lease(self, job, want_slots, min_slots=None, placement="pack"):
        """Gang grant: lease up to `want_slots` (but at least
        `min_slots`, default = want) across hosts; returns {host:
        slots} or {} when the minimum cannot be met — nothing is leased
        on failure, so a job never holds a useless partial gang.

        `placement` shapes the grant the same way
        :func:`plan_spawns` shapes a spawn plan: ``"pack"`` fills
        hosts densely in sorted order (training locality); ``"spread"``
        takes one slot per host round-robin (serve-replica
        failure-domain diversity)."""
        if min_slots is None:
            min_slots = want_slots
        if placement not in ("pack", "spread"):
            raise ValueError("unknown placement %r (pack|spread)"
                             % (placement,))
        grant = {}
        got = 0
        if placement == "spread":
            free = sorted(self.free_by_host().items())
            while got < want_slots:
                progressed = False
                for host, cap in free:
                    if got >= want_slots:
                        break
                    if grant.get(host, 0) < cap:
                        grant[host] = grant.get(host, 0) + 1
                        got += 1
                        progressed = True
                if not progressed:
                    break
        else:
            for host, free in sorted(self.free_by_host().items()):
                if got >= want_slots:
                    break
                take = min(free, want_slots - got)
                if take > 0:
                    grant[host] = take
                    got += take
        if got < max(1, min_slots):
            return {}
        with self._lock:
            for host, take in grant.items():
                inv = self.inventory().get(host, 0)
                if self._leased_slots(host) + take > inv:
                    # Raced against another grant (single-controller
                    # fleets never hit this) — refuse rather than
                    # oversubscribe, and make the near-miss visible.
                    self.oversubscription_refusals += 1
                    return {}
            for host, take in grant.items():
                self._leases.setdefault(host, {})[job] = \
                    self._leases.get(host, {}).get(job, 0) + take
        return dict(grant)

    def release(self, job, host=None, slots=None):
        """Voluntary hand-back (drain, completion, controller shrink):
        the slots re-enter the free pool IMMEDIATELY — no blacklist
        cooldown (that is failure evidence only; see
        ``HostManager.record_release``)."""
        with self._lock:
            hosts = [host] if host is not None else list(self._leases)
            for h in hosts:
                by_job = self._leases.get(h)
                if not by_job or job not in by_job:
                    continue
                self._hosts.record_release(h)
                if slots is None or slots >= by_job[job]:
                    del by_job[job]
                else:
                    by_job[job] -= slots
                if not by_job:
                    self._leases.pop(h, None)

    def lease_of(self, job):
        """{host: slots} currently leased to `job`."""
        with self._lock:
            return {h: by_job[job] for h, by_job in self._leases.items()
                    if job in by_job}

    def leased_slots_of(self, job):
        return sum(self.lease_of(job).values())

    # -- invariants / views ------------------------------------------------
    def check_occupancy(self, live_by_job):
        """Verifies no host runs more workers than it has slots.
        ``live_by_job``: {job: {host: live workers}}. Returns the list
        of violated hosts (empty = invariant holds). The RAW discovered
        inventory is the capacity reference — blacklisting a host must
        not turn its still-draining workers into a false violation."""
        raw = self._hosts._current
        occupancy = {}
        for per_host in live_by_job.values():
            for host, n in per_host.items():
                occupancy[host] = occupancy.get(host, 0) + n
        return [h for h, n in occupancy.items() if n > raw.get(h, 0)]

    def host_states(self):
        """{host: {"slots", "leased", "by_job", "state"}} over the raw
        discovered inventory; state is free | leased | blacklisted."""
        out = {}
        with self._lock:
            for host, slots in sorted(self._hosts._current.items()):
                by_job = dict(self._leases.get(host, {}))
                leased = sum(by_job.values())
                if self._hosts.is_blacklisted(host):
                    state = "blacklisted"
                elif leased:
                    state = "leased"
                else:
                    state = "free"
                out[host] = {"slots": slots, "leased": leased,
                             "by_job": by_job, "state": state}
        return out
