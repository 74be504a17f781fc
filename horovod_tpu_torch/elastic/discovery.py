"""Host discovery + failure blacklisting for elastic jobs.

A copy of ``horovod_tpu/elastic/discovery.py`` for the port (no torch).

Reference analogue: ``horovod/run/elastic/discovery.py`` (HostDiscovery /
HostDiscoveryScript / HostManager with host blacklisting); fresh
implementation. The discovery contract: a source of truth (usually a
user script) reports the currently-available hosts as ``host:slots``
lines; the driver diffs successive readings to grow or shrink the job.

Blacklisting differs from the reference's permanent blacklist: failures
here carry an **exponential backoff** (base cooldown doubling per
consecutive failure), because preempted hosts routinely come
back — a permanent blacklist would turn every transient preemption into
a permanent capacity loss.
"""

import subprocess
import time


def plan_spawns(available, live_per_host, room, placement="pack"):
    """Hosts to spawn new workers on, one list entry per worker — the
    pure placement rule shared by the single-job elastic driver's
    growth path and the fleet controller's pool
    (``horovod_tpu/fleet/placement.py`` re-exports it; the fleet is
    ROADMAP A8f).

    ``available``: {host: slots} — the spawnable inventory (already
    blacklist-filtered). ``live_per_host``: {host: live worker count}.
    ``room``: how many more workers may be added.

    ``placement`` picks the shape (docs/FLEET.md "Placement"):

    * ``"pack"`` (default, the historical rule) fills hosts densely in
      sorted order — training gangs want locality (intra-host data
      plane, shared-memory composites).
    * ``"spread"`` places each worker on the least-occupied host with a
      free slot (ties by name) — serve replicas want failure-domain
      diversity: one host dying must not take the whole pool's
      capacity with it.

    Either way hosts are walked deterministically, so the plan agrees
    across supervisors."""
    if room <= 0:
        return []
    if placement not in ("pack", "spread"):
        raise ValueError("unknown placement %r (pack|spread)"
                         % (placement,))
    plan = []
    if placement == "spread":
        occupancy = dict(live_per_host)
        while len(plan) < room:
            candidates = [(occupancy.get(h, 0), h)
                          for h, slots in sorted(available.items())
                          if occupancy.get(h, 0) < slots]
            if not candidates:
                break
            _, host = min(candidates)
            plan.append(host)
            occupancy[host] = occupancy.get(host, 0) + 1
        return plan
    for host, slots in sorted(available.items()):
        free = slots - live_per_host.get(host, 0)
        for _ in range(max(0, free)):
            if len(plan) >= room:
                return plan
            plan.append(host)
    return plan


class HostDiscovery:
    """Interface: report the currently-available hosts."""

    def find_available_hosts_and_slots(self):
        """Returns {hostname: slots}."""
        raise NotImplementedError


class FixedHosts(HostDiscovery):
    """Static host set (the non-discovery case, e.g. plain ``-H``)."""

    def __init__(self, hosts):
        # hosts: {hostname: slots} or a "h1:2,h2:2" string.
        if isinstance(hosts, str):
            from horovod_tpu_torch.run.util import parse_hosts
            hosts = {h.hostname: h.slots for h in parse_hosts(hosts)}
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self):
        return dict(self._hosts)


class HostDiscoveryScript(HostDiscovery):
    """Runs a user script that prints one ``host`` or ``host:slots`` line
    per available host (the reference's ``--host-discovery-script``
    contract). A non-zero exit or unparseable output reads as "no
    change" (the previous host set is kept) — a flaky discovery script
    must not shrink a healthy job."""

    def __init__(self, script, default_slots=1, timeout=10):
        self._script = script
        self._default_slots = default_slots
        self._timeout = timeout
        self._last = {}

    def find_available_hosts_and_slots(self):
        try:
            out = subprocess.run(
                self._script, shell=True, capture_output=True, text=True,
                timeout=self._timeout)
        except (subprocess.TimeoutExpired, OSError):
            return dict(self._last)
        if out.returncode != 0:
            return dict(self._last)
        hosts = {}
        for line in out.stdout.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if ":" in line:
                name, _, slots = line.rpartition(":")
                try:
                    hosts[name] = int(slots)
                except ValueError:
                    continue
            else:
                hosts[line] = self._default_slots
        if not hosts:
            # Exit 0 with empty/unparseable output gets the same benefit
            # of the doubt as a crash: "no hosts at all" would shrink a
            # healthy job below --min-np and tear it down, and a flaky
            # script racing its data source must not cause that. A truly
            # empty fleet surfaces through worker failures instead.
            return dict(self._last)
        self._last = dict(hosts)
        return hosts


class HostManager:
    """Tracks the available host set and per-host failure blacklisting.

    A host that causes a worker failure is blacklisted for
    ``cooldown * 2**(consecutive_failures - 1)`` seconds (capped at
    ``max_backoff``); it is not retried before the backoff expires, and
    a success (a worker on the host outliving ``success_after``) resets
    the streak. ``clock`` is injectable for deterministic tests."""

    def __init__(self, discovery, cooldown=10.0, max_backoff=600.0,
                 clock=time.monotonic):
        self._discovery = discovery
        self._cooldown = cooldown
        self._max_backoff = max_backoff
        self._clock = clock
        self._current = {}
        # host -> (consecutive_failures, blacklisted_until, failed_at)
        self._failures = {}

    def refresh(self):
        """Re-reads discovery; returns True when the raw host set (before
        blacklist filtering) changed."""
        hosts = self._discovery.find_available_hosts_and_slots()
        changed = hosts != self._current
        self._current = hosts
        return changed

    def record_failure(self, host):
        count, _, _ = self._failures.get(host, (0, 0.0, 0.0))
        count += 1
        now = self._clock()
        backoff = min(self._cooldown * (2 ** (count - 1)),
                      self._max_backoff)
        self._failures[host] = (count, now + backoff, now)

    def record_release(self, host):
        """A worker on `host` exited VOLUNTARILY — planned drain,
        preemption hand-back, controller-requested shrink. Unlike
        :meth:`record_failure` this must NOT start (or extend) the
        backoff blacklist: a drained host is healthy by definition and
        re-enters the spawnable pool immediately. It is not success
        evidence either — a pre-existing failure streak (from an
        earlier real crash) keeps its cooldown untouched, so a flaky
        host can't launder its blacklist through a planned drain."""
        # Deliberately records nothing: voluntary exit is neither
        # failure evidence nor post-failure health proof.

    def record_success(self, host, started_at=None):
        """Clears the failure streak — but only on evidence that
        POSTDATES the last failure: a worker that was already running
        when the host failed proves nothing about the host now (without
        this guard, one long-lived survivor on a multi-slot host would
        wipe a fresh blacklist entry and defeat the backoff)."""
        ent = self._failures.get(host)
        if ent is None:
            return
        if started_at is not None and started_at <= ent[2]:
            return
        self._failures.pop(host, None)

    def reset(self):
        """Clears every failure streak and blacklist entry. Used by the
        driver's full-job checkpoint restart (--restart-from-ckpt): the
        restart is a clean slate — a host whose backoff window was the
        reason the world fell below --min-np must be retriable by the
        relaunched job, exactly as it would be by an operator-driven
        restart."""
        self._failures = {}

    def is_blacklisted(self, host):
        ent = self._failures.get(host)
        return ent is not None and self._clock() < ent[1]

    def blacklisted_until(self, host):
        ent = self._failures.get(host)
        return ent[1] if ent else 0.0

    def available_hosts_and_slots(self):
        """The discovered host set minus currently-blacklisted hosts."""
        return {h: s for h, s in self._current.items()
                if not self.is_blacklisted(h)}
