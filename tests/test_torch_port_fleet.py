"""The port's fleet controller (``horovod_tpu_torch.fleet``) and hvd-top
(``horovod_tpu_torch.run.top``) against the JAX package's
(``horovod_tpu.fleet``, ``horovod_tpu.run.top``), on the CPU.

The first part mirrors ``tests/test_fleet.py`` test for test, with the
same assertions: the placement library, the pool's leases, release and
blacklisting, the chaos grammar, the metrics, ``JobSpec``, the
controller's admission, preemption and grow planning against fake
drivers, and the three e2e tests (the chaos schedule in the slow tier, as
the reference marks it). The e2e jobs run ``tests/torch_port_fleet_worker.py
--device cpu`` on gloo ranks, the serve job the port's replica with
``HVD_TPU_SERVE_DEVICE=cpu``, under the port's launcher, elastic driver
and fleet CLI; ``python -m horovod_tpu_torch.run.top`` renders the live
controller. A test of the port's own ``--linger`` option (the card's
fleet phase reads the final counters through it) joins them.

The second part holds the port against the reference on the same seeded
inputs, compared for exact equality: ``plan_spawns`` and sequences of
``PlacementPool`` operations for ``pack`` and ``spread``, the chaos
schedule's firings and seeded picks, the Prometheus text of the same
``FleetMetrics`` updates, one scripted fleet run on both controllers with
fake drivers (every drain request, the job states tick by tick, the
``fleet_*`` counters and the ``view()`` document), and hvd-top's frames
of the same documents. The third part mirrors the hvd-top tests of
``test_serve.py``, ``test_compression.py``, ``test_autotune.py`` and
``test_trace.py`` onto the port's ``run.top``.
"""

import json
import os
import random
import re
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from horovod_tpu.elastic import discovery as ref_discovery
from horovod_tpu.fleet import chaos as ref_chaos
from horovod_tpu.fleet import controller as ref_controller
from horovod_tpu.fleet import metrics as ref_metrics
from horovod_tpu.fleet import placement as ref_placement
from horovod_tpu.run import top as ref_top
from horovod_tpu_torch.elastic.discovery import FixedHosts, HostManager
from horovod_tpu_torch.elastic.state import EXIT_DRAINED
from horovod_tpu_torch.fleet import controller as port_controller
from horovod_tpu_torch.fleet.chaos import FleetChaos, FleetChaosError
from horovod_tpu_torch.fleet.controller import (DRAINING, PENDING, RUNNING,
                                                FleetController, JobSpec)
from horovod_tpu_torch.fleet.metrics import FleetMetrics, render_prometheus
from horovod_tpu_torch.fleet.placement import PlacementPool, plan_spawns
from horovod_tpu_torch.run import top
from horovod_tpu_torch.run import util

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(ROOT / "tests" / "torch_port_fleet_worker.py")
WORKER_CMD = "%s %s --device cpu" % (sys.executable, WORKER)


# ---------------------------------------------------------------------------
# Placement library

def test_plan_spawns_fills_free_slots_in_sorted_host_order():
    plan = plan_spawns({"b": 2, "a": 2}, {"a": 1}, room=10)
    assert plan == ["a", "b", "b"]


def test_plan_spawns_respects_room_and_zero():
    assert plan_spawns({"a": 4}, {}, room=2) == ["a", "a"]
    assert plan_spawns({"a": 4}, {}, room=0) == []
    assert plan_spawns({}, {}, room=3) == []


def test_plan_spawns_ignores_overfull_hosts():
    # More live workers than slots (mid-drain overlap) must not
    # produce a negative contribution.
    assert plan_spawns({"a": 1, "b": 1}, {"a": 3}, room=2) == ["b"]


def test_plan_spawns_spread_balances_occupancy():
    # Spread: each worker lands on the least-occupied host (ties by
    # name) — serve replicas want failure-domain diversity.
    assert plan_spawns({"a": 4, "b": 4}, {}, room=4,
                       placement="spread") == ["a", "b", "a", "b"]
    # Existing occupancy is honored: "a" already carries 2, so "b"
    # catches up before the round-robin resumes.
    assert plan_spawns({"a": 4, "b": 4}, {"a": 2}, room=3,
                       placement="spread") == ["b", "b", "a"]
    # Full hosts drop out; a full pool stops the plan short.
    assert plan_spawns({"a": 1, "b": 2}, {"a": 1}, room=3,
                       placement="spread") == ["b", "b"]


def test_plan_spawns_rejects_unknown_placement():
    with pytest.raises(ValueError):
        plan_spawns({"a": 1}, {}, room=1, placement="sprinkle")


def test_pool_spread_lease_round_robins_hosts():
    pool = PlacementPool(FixedHosts({"a": 2, "b": 2}))
    pool.refresh()
    # Pack (default) fills "a" densely; spread alternates hosts.
    assert pool.lease("packed", 2) == {"a": 2}
    pool.release("packed")
    grant = pool.lease("spread", 2, placement="spread")
    assert grant == {"a": 1, "b": 1}
    pool.release("spread")
    # Want > one-per-host: the round-robin wraps for the remainder.
    assert pool.lease("big", 3, placement="spread") == {"a": 2, "b": 1}
    with pytest.raises(ValueError):
        pool.lease("x", 1, placement="sprinkle")


def test_jobspec_kind_defaults():
    train = JobSpec("t", ["true"], np=2)
    assert train.kind == "train"
    assert train.placement == "pack"
    assert train.start_timeout == 60
    serve = JobSpec("s", ["true"], np=2, kind="serve")
    assert serve.placement == "spread"  # failure-domain diversity
    assert serve.start_timeout == 2  # growth gate unsticks by stalling
    # Either default is overridable per job.
    pinned = JobSpec("p", ["true"], np=2, kind="serve",
                     placement="pack", start_timeout=30)
    assert pinned.placement == "pack" and pinned.start_timeout == 30
    with pytest.raises(ValueError):
        JobSpec("x", ["true"], np=2, kind="batch")
    with pytest.raises(ValueError):
        JobSpec("x", ["true"], np=2, placement="sprinkle")
    via_dict = JobSpec.from_dict(
        {"name": "d", "command": ["true"], "np": 1, "kind": "serve",
         "placement": "spread"})
    assert via_dict.kind == "serve"


def test_pool_gang_lease_all_or_nothing():
    pool = PlacementPool(FixedHosts({"a": 2, "b": 2}))
    pool.refresh()
    assert pool.free_slots() == 4
    grant = pool.lease("j1", 3)
    assert sum(grant.values()) == 3
    # j2 wants a gang of 2 but only 1 slot is free: NOTHING is leased.
    assert pool.lease("j2", 2) == {}
    assert pool.free_slots() == 1
    # min_slots relaxes the gang: 1 of 2 is acceptable.
    assert sum(pool.lease("j2", 2, min_slots=1).values()) == 1
    assert pool.free_slots() == 0


def test_pool_release_reenters_immediately():
    pool = PlacementPool(FixedHosts({"a": 2}))
    pool.refresh()
    pool.lease("j1", 2)
    assert pool.free_slots() == 0
    pool.release("j1", "a", 1)
    assert pool.free_slots() == 1  # no cooldown on voluntary release
    pool.release("j1")
    assert pool.free_slots() == 2
    assert pool.lease_of("j1") == {}


def test_pool_refuses_oversubscription():
    pool = PlacementPool(FixedHosts({"a": 2}))
    pool.refresh()
    assert sum(pool.lease("j1", 2).values()) == 2
    assert pool.lease("j2", 1) == {}
    assert pool.leased_slots_of("j2") == 0


def test_pool_occupancy_invariant_uses_raw_inventory():
    pool = PlacementPool(FixedHosts({"a": 2, "b": 1}))
    pool.refresh()
    assert pool.check_occupancy({"j1": {"a": 2}, "j2": {"b": 1}}) == []
    assert pool.check_occupancy({"j1": {"a": 2}, "j2": {"a": 1}}) == ["a"]
    # Blacklisting a host must not turn its still-draining workers into
    # a false violation: capacity reference is the RAW inventory.
    pool.record_failure("a")
    assert pool.check_occupancy({"j1": {"a": 2}}) == []


def test_pool_host_states():
    pool = PlacementPool(FixedHosts({"a": 2, "b": 2, "c": 1}))
    pool.refresh()
    pool.lease("j1", 2)  # lands on "a" (sorted order)
    pool.record_failure("c")
    states = pool.host_states()
    assert states["a"]["state"] == "leased"
    assert states["a"]["by_job"] == {"j1": 2}
    assert states["b"]["state"] == "free"
    assert states["c"]["state"] == "blacklisted"


# ---------------------------------------------------------------------------
# Voluntary release vs failure blacklist

def test_record_release_never_blacklists():
    mgr = HostManager(FixedHosts({"a": 2}), cooldown=10.0,
                      clock=lambda: 100.0)
    mgr.refresh()
    mgr.record_release("a")
    assert not mgr.is_blacklisted("a")
    assert mgr.available_hosts_and_slots() == {"a": 2}


def test_record_release_keeps_existing_failure_streak():
    clock = {"t": 0.0}
    mgr = HostManager(FixedHosts({"a": 1}), cooldown=10.0,
                      clock=lambda: clock["t"])
    mgr.refresh()
    mgr.record_failure("a")
    assert mgr.is_blacklisted("a")
    # A planned drain on a flaky host must not launder the blacklist.
    mgr.record_release("a")
    assert mgr.is_blacklisted("a")
    clock["t"] = 5.0
    mgr.record_failure("a")  # second consecutive failure: 2x backoff
    assert mgr.blacklisted_until("a") == pytest.approx(25.0)


# ---------------------------------------------------------------------------
# Chaos grammar

def test_chaos_spec_parse():
    c = FleetChaos("seed=7;job=b,at=3,action=arrive;"
                   "job=a,at=5,action=kill,count=2,every=2;"
                   "at=8,action=preempt")
    assert c.seed == 7
    assert c.arrival_override("b") == 3.0
    assert c.arrival_override("a") is None
    assert [e.action for e in c.due(5.9)] == ["kill"]
    assert [e.action for e in c.due(8.5)] == ["kill", "preempt"]
    assert c.due(100.0) == []  # counts exhausted


def test_chaos_pick_is_seed_deterministic():
    picks1 = [FleetChaos("seed=3;at=0,action=kill").pick(["a", "b", "c"])
              for _ in range(1)]
    picks2 = [FleetChaos("seed=3;at=0,action=kill").pick(["c", "b", "a"])
              for _ in range(1)]
    assert picks1 == picks2  # candidates sorted; same seed, same pick


@pytest.mark.parametrize("spec", [
    "garbage",
    "action=explode",
    "seed=x",
    "job=a",  # no action
    "at=-1,action=kill",
    "action=kill,count=0",
    "action=arrive",  # arrive needs an explicit job
    "action=kill,frobnicate=1",
])
def test_chaos_spec_rejects_garbage(spec):
    with pytest.raises(FleetChaosError):
        FleetChaos(spec)


# ---------------------------------------------------------------------------
# Fleet metrics

def test_fleet_metrics_snapshot_and_prometheus():
    m = FleetMetrics()
    m.inc("fleet_admissions_total")
    m.inc("fleet_preemptions_total", 2)
    m.set_gauge("fleet_jobs_running", 3)
    m.observe("fleet_drain_seconds", 0.7)
    snap = m.snapshot()
    assert snap["counters"]["fleet_admissions_total"] == 1
    assert snap["counters"]["fleet_preemptions_total"] == 2
    assert snap["gauges"]["fleet_jobs_running"] == 3
    h = snap["histograms"]["fleet_drain_seconds"]
    assert h["count"] == 1 and h["sum"] == pytest.approx(0.7)
    text = render_prometheus(m)
    assert "hvdtpu_fleet_admissions_total 1" in text
    assert "hvdtpu_fleet_drain_seconds_bucket" in text
    assert 'le="+Inf"' in text


# ---------------------------------------------------------------------------
# JobSpec / controller planning (fake drivers, no processes)

def test_jobspec_validation():
    with pytest.raises(ValueError):
        JobSpec("j", ["x"], np=1, min_np=2)
    with pytest.raises(ValueError):
        JobSpec.from_dict({"name": "j", "command": "x", "np": 1,
                           "bogus": True})
    spec = JobSpec.from_dict({"name": "j", "command": "python t.py",
                              "np": 2})
    assert spec.command == ["python", "t.py"]
    assert spec.max_np == 2


class _FakeDriver:
    """Controller-facing surface of ElasticDriver, slot-accurate."""

    def __init__(self, pool, job_name, np_now):
        self._pool = pool
        self._job = job_name
        self._wids = list(range(np_now))
        self.max_np = np_now
        self.drain_requests = []
        self._draining = False

    def live_per_host(self):
        out, left = {}, len(self._wids)
        for host, slots in sorted(self._pool.lease_of(self._job).items()):
            take = min(slots, left)
            if take:
                out[host] = take
                left -= take
        return out

    def live_workers(self):
        return sorted(self._wids)

    def worker_pid(self, wid):
        return None

    def resize(self, max_np):
        self.max_np = max_np

    def request_drain(self, victims, grace=None):
        self.drain_requests.append((victims, grace))
        if victims == "all":
            self._wids = []
        else:
            self._wids = [w for w in self._wids
                          if str(w) not in [str(v) for v in victims]]
        self._draining = False  # fake: drain completes instantly

    def draining(self):
        return self._draining

    def terminate(self):
        pass


def _fake_controller(hosts, monkeypatch):
    controller = FleetController(FixedHosts(hosts))
    controller._start = time.monotonic()
    controller.pool.refresh()

    def fake_start(job, granted):
        job.driver = _FakeDriver(controller.pool, job.name,
                                 sum(granted.values()))

    monkeypatch.setattr(controller, "_start_driver", fake_start)
    return controller


def test_gang_admission_and_backoff(monkeypatch):
    controller = _fake_controller({"h": 4}, monkeypatch)
    a = controller.submit(JobSpec("a", ["x"], np=3, min_np=3))
    b = controller.submit(JobSpec("b", ["x"], np=2, min_np=2))
    now = time.monotonic()
    assert controller._try_admit(a, now)
    assert a.state == RUNNING
    assert controller.pool.leased_slots_of("a") == 3
    # b's gang of 2 cannot fit into the single free slot: nothing
    # leased, backoff armed, retry counter bumped.
    assert not controller._try_admit(b, now)
    assert b.state == PENDING
    assert controller.pool.leased_slots_of("b") == 0
    assert b.next_try > now
    assert controller.metrics.get("fleet_admission_retries_total") == 1


def test_preemption_prefers_shrink_over_kill(monkeypatch):
    controller = _fake_controller({"h": 4}, monkeypatch)
    a = controller.submit(JobSpec("a", ["x"], np=4, min_np=1,
                                  priority=0))
    b = controller.submit(JobSpec("b", ["x"], np=2, min_np=2,
                                  priority=5))
    now = time.monotonic()
    assert controller._try_admit(a, now)
    assert controller._preempt_for(b)
    # a was SHRUNK (drain of its 2 youngest workers), not killed.
    assert a.state == RUNNING
    assert a.driver.drain_requests[0][0] == [2, 3]
    assert a.driver.max_np == 2
    # The fake drain completed instantly; reconciliation frees slots.
    controller._finish_shrinks(time.monotonic())
    assert controller.pool.free_slots() == 2
    assert controller._try_admit(b, time.monotonic())
    assert controller.metrics.get("fleet_shrinks_total") == 1


def test_preemption_full_when_shrink_cannot_cover(monkeypatch):
    controller = _fake_controller({"h": 2}, monkeypatch)
    a = controller.submit(JobSpec("a", ["x"], np=2, min_np=2,
                                  priority=0))
    b = controller.submit(JobSpec("b", ["x"], np=2, min_np=2,
                                  priority=5))
    now = time.monotonic()
    assert controller._try_admit(a, now)
    assert controller._preempt_for(b)
    assert a.state == DRAINING
    assert a.driver.drain_requests[0][0] == "all"


def test_no_preemption_of_equal_or_higher_priority(monkeypatch):
    controller = _fake_controller({"h": 2}, monkeypatch)
    a = controller.submit(JobSpec("a", ["x"], np=2, min_np=1,
                                  priority=5))
    b = controller.submit(JobSpec("b", ["x"], np=2, min_np=1,
                                  priority=5))
    now = time.monotonic()
    assert controller._try_admit(a, now)
    assert not controller._preempt_for(b)
    assert a.state == RUNNING and not a.driver.drain_requests


def test_no_grow_while_higher_priority_waits(monkeypatch):
    controller = _fake_controller({"h": 4}, monkeypatch)
    a = controller.submit(JobSpec("a", ["x"], np=4, min_np=1,
                                  priority=0))
    b = controller.submit(JobSpec("b", ["x"], np=4, min_np=4,
                                  priority=5))
    now = time.monotonic()
    assert controller._try_admit(a, now)
    controller._shrink(a, 1, b)
    controller._finish_shrinks(time.monotonic())
    assert controller.pool.free_slots() == 3
    # b (min_np=4) still cannot fit, but it outranks a: a must NOT eat
    # the free slots back while b waits.
    controller._grow_running(time.monotonic())
    assert controller.pool.leased_slots_of("a") == 1
    # Once b is gone (failed/done), a grows back toward max_np.
    b.state = "failed"
    controller._grow_running(time.monotonic())
    assert controller.pool.leased_slots_of("a") == 4
    assert a.driver.max_np == 4
    assert controller.metrics.get("fleet_grows_total") == 3


def test_reap_mid_shrink_clears_stale_shrink_state(monkeypatch):
    # A job that dies (or is fully drained) while a partial shrink is
    # still pending must not carry shrink_target into its next
    # incarnation: a stale target would make _finish_shrinks release
    # slots freshly leased to the restarted driver.
    controller = _fake_controller({"h": 4}, monkeypatch)
    a = controller.submit(JobSpec("a", ["x"], np=4, min_np=1,
                                  priority=0, max_restarts=1))
    b = controller.submit(JobSpec("b", ["x"], np=2, min_np=2,
                                  priority=5))
    now = time.monotonic()
    assert controller._try_admit(a, now)
    controller._shrink(a, 2, b)
    assert a.shrink_target == 2 and a.drain_started is not None
    # a dies mid-shrink (driver thread finished with rc=1).
    a.rc = 1
    a.thread = type("T", (), {"join": lambda self, timeout=None: None,
                              "is_alive": lambda self: False})()
    controller._reap_job(a, time.monotonic())
    assert a.state == PENDING and a.restarts == 1
    assert a.shrink_target is None and a.drain_started is None
    # Restarted at full size: _finish_shrinks must not steal the fresh
    # lease out from under the new driver.
    assert controller._try_admit(a, time.monotonic())
    controller._finish_shrinks(time.monotonic())
    assert controller.pool.leased_slots_of("a") == 4
    assert controller.metrics.get("fleet_shrinks_total") == 0


# ---------------------------------------------------------------------------
# E2E helpers

LOG_COMMIT = re.compile(
    r"job (\S+) worker (\S+) commit step (\d+) crc ([0-9a-f]{8})")
LOG_START = re.compile(
    r"job (\S+) worker (\S+) start step (\d+) crc ([0-9a-f]{8}) size (\d+)")
LOG_DONE = re.compile(
    r"job (\S+) worker (\S+) done step (\d+) crc ([0-9a-f]{8})")


def _fleet_env(extra=None):
    """The env of the CLI and its workers: this checkout first on
    PYTHONPATH, no card, PYTHONUNBUFFERED popped."""
    return util.cpu_worker_env(repo_root=str(ROOT), extra_env=extra)


def _wait_for(predicate, timeout, what, poll=0.2):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(poll)
    raise AssertionError("timed out after %ss waiting for %s"
                         % (timeout, what))


def _read(path):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def assert_lineage_consistent(out):
    """The chaos/restore invariant: every (re)entry at step > 0 must
    carry the crc of a state that job COMMITTED earlier — bitwise
    consistency with the checkpoint lineage."""
    committed = {}  # (job, step) -> set of crcs
    checked = 0
    for line in out.splitlines():
        m = LOG_COMMIT.search(line)
        if m:
            committed.setdefault((m.group(1), int(m.group(3))),
                                 set()).add(m.group(4))
            continue
        m = LOG_START.search(line)
        if m and int(m.group(3)) > 0:
            job, step, crc = m.group(1), int(m.group(3)), m.group(4)
            assert crc in committed.get((job, step), set()), (
                "job %s resumed at step %d with crc %s, which was "
                "never committed (lineage: %s)"
                % (job, step, crc,
                   sorted(k for k in committed if k[0] == job)))
            checked += 1
    return checked


def _cli(jobfile_path, log, env, *extra):
    with open(log, "w") as logf:
        return subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.fleet.cli",
             "--port", "0"] + list(extra) + [str(jobfile_path)],
            env=env, stdout=logf, stderr=subprocess.STDOUT,
            start_new_session=True)


def _controller_port(log):
    return int(_wait_for(
        lambda: (re.search(r"metrics at http://localhost:(\d+)",
                           _read(log)) or [None, None])[1],
        timeout=30, what="controller metrics port"))


def _fleet_view(port):
    with urllib.request.urlopen("http://localhost:%d/fleet" % port,
                                timeout=5) as resp:
        return json.loads(resp.read().decode())


def _reap(proc):
    if proc.poll() is None:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        proc.wait(timeout=10)


# ---------------------------------------------------------------------------
# E2E: --drain-grace SIGTERM drains through a durable commit of the
# drained step, and the job resumes from it at equal AND smaller size

@pytest.mark.e2e
def test_drain_grace_durable_commit_and_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    log = str(tmp_path / "out.log")
    env = _fleet_env({
        "HVD_TPU_CKPT_DIR": ckpt,
        # Sparse durable cadence: only the very first commit would be
        # durable on its own, so the manifest for the DRAINED step can
        # only exist if the drain force-wrote it (not an older sticky
        # anchor).
        "HVD_TPU_CKPT_EVERY_N_COMMITS": "1000",
        "FLEET_TEST_JOB": "s",
        "FLEET_TEST_TOTAL_STEPS": "500",
        "FLEET_TEST_STEP_SLEEP": "0.1",
    })
    with open(log, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
             "--drain-grace", "30", "--",
             sys.executable, WORKER, "--device", "cpu"],
            env=env, stdout=logf, stderr=subprocess.STDOUT,
            start_new_session=True)
    try:
        _wait_for(
            lambda: len(LOG_COMMIT.findall(_read(log))) >= 10,
            timeout=90, what="10 commits before the drain")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=90)
    finally:
        _reap(proc)
    out = _read(log)
    assert rc == EXIT_DRAINED, (rc, out)
    assert "drain requested" in out
    assert "exiting with EXIT_DRAINED" in out
    # Escalation must NOT have fired: the workers drained voluntarily.
    assert "escalating" not in out

    from horovod_tpu_torch.elastic.durable import last_durable_step
    drained_step, _ = last_durable_step(ckpt)
    commits = [(int(s), c) for _, _, s, c in LOG_COMMIT.findall(out)]
    max_commit = max(s for s, _ in commits)
    # The durable manifest is for the DRAINED step — the step the
    # workers were at when the drain landed — not the step-1 anchor the
    # sparse cadence would have left behind.
    assert drained_step == max_commit, (drained_step, max_commit)
    drained_crcs = {c for s, c in commits if s == drained_step}

    # Resume at EQUAL world size (2) and SMALLER world size (1): both
    # start bitwise-identically from the drained commit. Each resume
    # gets a pristine copy of the drained lineage — a resumed run
    # writes its own fresh durable anchor, which would otherwise leak
    # into the next resume's view.
    import shutil
    for np_resume in (2, 1):
        ckpt_copy = str(tmp_path / ("ckpt-resume-%d" % np_resume))
        shutil.copytree(ckpt, ckpt_copy)
        resume_env = dict(env)
        resume_env["HVD_TPU_CKPT_DIR"] = ckpt_copy
        resume_env["FLEET_TEST_TOTAL_STEPS"] = str(drained_step + 3)
        result = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run",
             "-np", str(np_resume), "--",
             sys.executable, WORKER, "--device", "cpu"],
            env=resume_env, timeout=120, capture_output=True, text=True)
        assert result.returncode == 0, (np_resume, result.stdout,
                                        result.stderr)
        starts = LOG_START.findall(result.stdout)
        assert starts, result.stdout
        for _, _, step, crc, size in starts:
            assert int(step) == drained_step, (np_resume, starts)
            assert crc in drained_crcs, (np_resume, starts, drained_crcs)
            assert int(size) == np_resume


# ---------------------------------------------------------------------------
# E2E: fleet preemption — drain, reclaim, restore, all observable
# (/fleet + the port's hvd-top --fleet + fleet_* metrics)

@pytest.mark.e2e
def test_fleet_preempt_reclaim_restore_observable(tmp_path):
    jobfile = {
        "hosts": "localhost:2",
        "drain_grace": 30,
        "jobs": [
            # min_np == np == pool size: the only way to fit "hi" is a
            # WHOLE-JOB preemption of "lo", and the only way to finish
            # "lo" afterwards is a full restore from its lineage.
            {"name": "lo", "command": WORKER_CMD,
             "np": 2, "min_np": 2, "priority": 0,
             "ckpt_dir": str(tmp_path / "ckpt-lo"),
             "env": {"FLEET_TEST_JOB": "lo",
                     "FLEET_TEST_TOTAL_STEPS": "60",
                     "FLEET_TEST_STEP_SLEEP": "0.2"}},
            {"name": "hi", "command": WORKER_CMD,
             "np": 2, "min_np": 2, "priority": 10, "arrival": 6.0,
             "ckpt_dir": str(tmp_path / "ckpt-hi"),
             "env": {"FLEET_TEST_JOB": "hi",
                     "FLEET_TEST_TOTAL_STEPS": "8",
                     "FLEET_TEST_STEP_SLEEP": "0.2"}},
        ],
    }
    jobfile_path = tmp_path / "jobs.json"
    jobfile_path.write_text(json.dumps(jobfile))
    log = str(tmp_path / "fleet.log")
    env = _fleet_env({"HVD_TPU_ELASTIC_COOLDOWN": "2"})
    proc = _cli(jobfile_path, log, env)
    try:
        port = _controller_port(log)

        # The drain → reclaim cycle is OBSERVABLE: at some poll, job lo
        # is draining or already preempted while hi holds/waits for the
        # slots.
        seen_states = set()

        def lo_preempted():
            view = _fleet_view(port)
            seen_states.add(view["jobs"]["lo"]["state"])
            return ("preempted" in seen_states
                    or "draining" in seen_states)

        _wait_for(lo_preempted, timeout=90,
                  what="job lo draining/preempted in /fleet")

        # the port's hvd-top --fleet renders the cross-job view against
        # the live endpoint.
        top_proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run.top",
             "--fleet", "--once", "localhost:%d" % port],
            env=env, timeout=30, capture_output=True, text=True)
        assert top_proc.returncode == 0, (top_proc.stdout, top_proc.stderr)
        assert "lo" in top_proc.stdout and "hi" in top_proc.stdout
        assert "preempted" in top_proc.stdout or \
            "draining" in top_proc.stdout

        # The fleet_* Prometheus plane records the drain cycle live.
        with urllib.request.urlopen(
                "http://localhost:%d/metrics" % port, timeout=5) as resp:
            prom = resp.read().decode()
        assert "hvdtpu_fleet_drains_requested_total" in prom
        assert re.search(
            r"hvdtpu_fleet_drains_requested_total \d", prom), prom
        assert "hvdtpu_fleet_drain_seconds" in prom
        assert "hvdtpu_fleet_jobs_preempted" in prom

        rc = proc.wait(timeout=240)
    finally:
        _reap(proc)
    out = _read(log)
    assert rc == 0, out
    # Both jobs completed; lo was preempted and restored.
    assert len(LOG_DONE.findall(out)) >= 2, out
    assert "preempting job lo" in out
    assert "job lo preempted" in out
    assert "job lo restored" in out
    # The restore resumed bitwise-consistently with the lineage.
    assert assert_lineage_consistent(out) >= 1
    assert "fleet finished: all 2 job(s) completed" in out


# ---------------------------------------------------------------------------
# E2E: serve/train co-tenancy — a serving job preempts lower-priority
# training via the same graceful drain, answers traffic from its
# checkpoint lineage while it holds the slots, and when traffic subsides
# (replicas exit 0) the training job restores from its durable lineage.

@pytest.mark.e2e
def test_fleet_serve_cotenancy_preempts_and_training_restores(tmp_path):
    from horovod_tpu_torch.serve import model as smodel
    from horovod_tpu_torch.serve.client import ServeClient
    from horovod_tpu_torch.serve.swap import publish_leaves
    from tests.test_serve import _free_port_base

    dim = 4
    leaves = smodel.init_leaves("affine", dim, seed=11)
    crc = smodel.fingerprint(leaves)
    serve_ckpt = str(tmp_path / "ckpt-serve")
    publish_leaves(serve_ckpt, 10, leaves)
    port_base = _free_port_base(2)

    jobfile = {
        "hosts": "localhost:2",
        "drain_grace": 30,
        "jobs": [
            # min_np == np == pool size: serving can only be admitted
            # by a whole-job preemption of the training gang.
            {"name": "train0", "command": WORKER_CMD,
             "np": 2, "min_np": 2, "priority": 0,
             "ckpt_dir": str(tmp_path / "ckpt-train"),
             "env": {"FLEET_TEST_JOB": "train0",
                     "FLEET_TEST_TOTAL_STEPS": "60",
                     "FLEET_TEST_STEP_SLEEP": "0.2"}},
            {"name": "serve0", "kind": "serve",
             "command": "%s -m horovod_tpu_torch.serve.replica"
                        % sys.executable,
             "np": 2, "min_np": 2, "priority": 10, "arrival": 4.0,
             "ckpt_dir": serve_ckpt,
             "env": {"HVD_TPU_SERVE_DEVICE": "cpu",
                     "HVD_TPU_SERVE_MODEL": "affine",
                     "HVD_TPU_SERVE_DIM": str(dim),
                     "HVD_TPU_SERVE_PORT": str(port_base),
                     # "Traffic subsides": replicas retire after 6s of
                     # serving and exit 0, completing the job.
                     "HVD_TPU_SERVE_EXIT_AFTER": "6"}},
        ],
    }
    jobfile_path = tmp_path / "jobs.json"
    jobfile_path.write_text(json.dumps(jobfile))
    log = str(tmp_path / "fleet.log")
    env = _fleet_env({"HVD_TPU_ELASTIC_COOLDOWN": "2"})
    proc = _cli(jobfile_path, log, env)
    try:
        port = _controller_port(log)
        # The serving job carries its kind/placement through /fleet.
        view = _wait_for(lambda: _fleet_view(port), timeout=10,
                         what="/fleet view")
        assert view["jobs"]["serve0"]["kind"] == "serve"
        assert view["jobs"]["serve0"]["placement"] == "spread"
        assert view["jobs"]["train0"]["kind"] == "train"

        # While the serving job holds the slots, it ANSWERS — with the
        # weights of its published lineage (fingerprint-checked).
        endpoints = ["127.0.0.1:%d" % (port_base + wid)
                     for wid in (0, 1)]
        client = ServeClient(endpoints, total_deadline=45.0,
                             attempt_timeout=3.0)
        x = np.arange(dim, dtype=np.float32)
        doc = client.infer(x, rid="cotenancy")
        assert doc["weights_crc"] == crc, doc
        assert doc["model_step"] == 10
        assert np.allclose(doc["y"],
                           smodel.forward("affine", leaves, x),
                           atol=1e-4)

        rc = proc.wait(timeout=240)
    finally:
        _reap(proc)
    out = _read(log)
    assert rc == 0, out
    # The serving job preempted training via the graceful drain...
    assert "preempting job train0" in out
    assert "job train0 preempted" in out
    # ...and training restored from its durable lineage after traffic
    # subsided, resuming bitwise-consistently.
    assert "job train0 restored" in out
    assert assert_lineage_consistent(out) >= 1
    assert "fleet finished: all 2 job(s) completed" in out


def test_cli_linger_serves_the_final_view(tmp_path):
    """The port's ``--linger``: once every job is terminal the controller
    keeps ``/metrics`` and ``/fleet`` up, so the final counters can be
    read; an interrupt ends the wait with the fleet's exit code."""
    jobfile_path = tmp_path / "jobs.json"
    jobfile_path.write_text(json.dumps({
        "hosts": "localhost:1",
        "jobs": [{"name": "once", "command": [sys.executable, "-c", "pass"],
                  "np": 1}]}))
    log = str(tmp_path / "fleet.log")
    proc = _cli(jobfile_path, log, _fleet_env(), "--linger", "120")
    try:
        port = _controller_port(log)
        _wait_for(lambda: "final view served for 120 s" in _read(log),
                  timeout=60, what="the fleet's end")
        with urllib.request.urlopen("http://localhost:%d/metrics" % port,
                                    timeout=5) as resp:
            prom = resp.read().decode()
        assert "hvdtpu_fleet_job_completions_total 1" in prom, prom
        assert _fleet_view(port)["jobs"]["once"]["state"] == "done"
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=30)
    finally:
        _reap(proc)
    assert rc == 0, _read(log)
    assert "fleet finished: all 1 job(s) completed" in _read(log)


# ---------------------------------------------------------------------------
# E2E: seeded fleet chaos — arrivals + random SIGKILLs + forced
# preemption over 3 concurrent jobs (slow tier, as in the reference)

@pytest.mark.e2e
@pytest.mark.slow
def test_fleet_chaos_schedule(tmp_path):
    def job(name, np_, min_np, priority, arrival=0.0, steps=40,
            sleep=0.15):
        return {"name": name, "command": WORKER_CMD,
                "np": np_, "min_np": min_np, "priority": priority,
                "arrival": arrival,
                "ckpt_dir": str(tmp_path / ("ckpt-%s" % name)),
                "env": {"FLEET_TEST_JOB": name,
                        "FLEET_TEST_TOTAL_STEPS": str(steps),
                        "FLEET_TEST_STEP_SLEEP": str(sleep)}}

    jobfile = {
        "hosts": "localhost:4",
        "drain_grace": 30,
        "jobs": [
            job("a", 2, 1, priority=0, steps=60),
            job("b", 2, 1, priority=3, steps=40),
            job("c", 2, 2, priority=8, steps=25),
        ],
    }
    jobfile_path = tmp_path / "jobs.json"
    jobfile_path.write_text(json.dumps(jobfile))
    log = str(tmp_path / "fleet.log")
    env = _fleet_env({
        "HVD_TPU_ELASTIC_COOLDOWN": "2",
        # Seeded schedule: b arrives at t=4, c at t=8 (its gang of 2
        # with min_np=2 forces preemption pressure), a random worker of
        # a is SIGKILLed twice, and b eats one forced preemption at t=6
        # — while its ~6s of stepping is guaranteed still in flight
        # (a late preempt would be dropped against an already-done b).
        "HVD_TPU_FLEET_CHAOS_SPEC":
            "seed=1702;job=b,at=4,action=arrive;"
            "job=c,at=8,action=arrive;"
            "job=a,at=6,action=kill,count=2,every=5;"
            "job=b,at=6,action=preempt",
    })
    proc = _cli(jobfile_path, log, env, "--timeout", "420")
    try:
        rc = proc.wait(timeout=480)
    finally:
        _reap(proc)
    out = _read(log)
    assert rc == 0, out[-4000:]
    # Every job completed...
    for name in ("a", "b", "c"):
        assert re.search(r"job %s worker \S+ done step" % name, out), (
            "job %s never printed done\n%s" % (name, out[-4000:]))
    # ...the chaos actually happened...
    assert out.count("chaos: SIGKILL") >= 1, out
    assert "chaos: forced preemption of job b" in out
    # ...every resume was bitwise-consistent with the lineage...
    assert assert_lineage_consistent(out) >= 1
    # ...and the pool never double-assigned a host.
    assert "OCCUPANCY VIOLATION" not in out
    assert "fleet finished: all 3 job(s) completed" in out


# ---------------------------------------------------------------------------
# The port against the reference, on the same seeded inputs

def _random_hosts(rng):
    names = rng.sample(["a", "b", "c", "d", "e", "f"], rng.randint(1, 5))
    return {h: rng.randint(1, 4) for h in names}


@pytest.mark.parametrize("placement", ["pack", "spread"])
def test_plan_spawns_equals_the_reference(placement):
    rng = random.Random(21 if placement == "pack" else 22)
    for _ in range(400):
        available = _random_hosts(rng)
        live = {h: rng.randint(0, 5) for h in rng.sample(
            sorted(available) + ["z"], rng.randint(0, len(available)))}
        room = rng.randint(0, 12)
        assert plan_spawns(available, live, room, placement=placement) == \
            ref_discovery.plan_spawns(available, live, room,
                                      placement=placement)


def _pool_script(pool, rng, steps=300):
    """A seeded sequence of pool operations; returns what each returned
    and the pool's views after it."""
    jobs = ["j0", "j1", "j2", "j3"]
    out = []
    for _ in range(steps):
        op = rng.choice(["lease", "lease", "lease", "release", "release_part",
                         "failure", "success", "refresh"])
        job = rng.choice(jobs)
        if op == "lease":
            want = rng.randint(1, 6)
            got = pool.lease(job, want, min_slots=rng.randint(1, want),
                             placement=rng.choice(["pack", "spread"]))
        elif op == "release":
            got = pool.release(job)
        elif op == "release_part":
            lease = sorted(pool.lease_of(job).items())
            host, slots = lease[0] if lease else ("a", 1)
            got = pool.release(job, host, rng.randint(1, slots))
        elif op == "failure":
            got = pool.record_failure(rng.choice(["a", "b", "c"]))
        elif op == "success":
            got = pool.record_success(rng.choice(["a", "b", "c"]))
        else:
            got = pool.refresh()
        out.append((op, job, got, pool.free_by_host(), pool.host_states(),
                    {j: pool.lease_of(j) for j in jobs},
                    pool.check_occupancy({j: pool.lease_of(j)
                                          for j in jobs}),
                    pool.oversubscription_refusals))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_placement_pool_sequences_equal_the_reference(seed):
    """The same operations on both pools (one fake clock each, advanced
    alike) give the same grants, releases and views at every step."""
    hosts = {"a": 3, "b": 2, "c": 4}
    clocks = [{"t": 0.0}, {"t": 0.0}]
    port_pool = PlacementPool(FixedHosts(hosts), cooldown=1.0,
                              clock=lambda: clocks[0]["t"])
    ref_pool = ref_placement.PlacementPool(
        ref_discovery.FixedHosts(hosts), cooldown=1.0,
        clock=lambda: clocks[1]["t"])
    for pool, clock in ((port_pool, clocks[0]), (ref_pool, clocks[1])):
        pool.refresh()
    rngs = [random.Random(seed), random.Random(seed)]

    class Ticking:
        """Advances the pool's clock 0.1 s before each operation."""

        def __init__(self, pool, clock):
            self.pool, self.clock = pool, clock

        def __getattr__(self, name):
            self.clock["t"] += 0.1
            return getattr(self.pool, name)

    port = _pool_script(Ticking(port_pool, clocks[0]), rngs[0])
    ref = _pool_script(Ticking(ref_pool, clocks[1]), rngs[1])
    assert port == ref
    assert any(op == "lease" and got for op, _, got, *_ in port)
    assert any(s["state"] == "blacklisted" for *_, states, _, _, _ in port
               for s in states.values())


@pytest.mark.parametrize("spec", [
    "seed=3;at=0,action=kill,count=5,every=0.5;job=b,at=2,action=preempt",
    "seed=1702;job=b,at=4,action=arrive;job=c,at=8,action=arrive;"
    "job=a,at=6,action=kill,count=2,every=5;job=b,at=6,action=preempt",
    "job=x,at=1.5,action=preempt,count=3,every=0.25",
])
def test_chaos_schedule_and_picks_equal_the_reference(spec):
    port, ref = FleetChaos(spec), ref_chaos.FleetChaos(spec)
    assert port.seed == ref.seed
    assert [repr(e) for e in port.events] == [repr(e) for e in ref.events]
    for name in ("a", "b", "c", "x"):
        assert port.arrival_override(name) == ref.arrival_override(name)
    rng = random.Random(5)
    for step in range(200):
        now = step * 0.1
        fired = [repr(e) for e in port.due(now)]
        assert fired == [repr(e) for e in ref.due(now)]
        cands = rng.sample(["a", "b", "c", "d"] if step % 2 else [1, 2, 3],
                           rng.randint(0, 3))
        assert port.pick(cands) == ref.pick(cands)
    for seed in range(20):
        cands = list(range(seed % 7 + 1))
        assert FleetChaos("", seed).pick(cands) == \
            ref_chaos.FleetChaos("", seed).pick(cands)


def test_fleet_metrics_prometheus_text_equals_the_reference():
    rng = random.Random(9)
    port, ref = FleetMetrics(), ref_metrics.FleetMetrics()
    from horovod_tpu_torch.fleet import metrics as port_metrics
    assert port_metrics.COUNTERS == ref_metrics.COUNTERS
    assert port_metrics.GAUGES == ref_metrics.GAUGES
    assert port_metrics.HISTOGRAMS == ref_metrics.HISTOGRAMS
    for _ in range(300):
        kind = rng.choice(["inc", "gauge", "observe"])
        if kind == "inc":
            name, n = rng.choice(ref_metrics.COUNTERS), rng.randint(1, 3)
            port.inc(name, n)
            ref.inc(name, n)
        elif kind == "gauge":
            name, v = rng.choice(ref_metrics.GAUGES), rng.randint(0, 9)
            port.set_gauge(name, v)
            ref.set_gauge(name, v)
        else:
            name = rng.choice(ref_metrics.HISTOGRAMS)
            v = rng.choice([0.05, 0.1, 0.3, 1.0, 7.0, 900.0,
                            rng.uniform(0, 700)])
            port.observe(name, v)
            ref.observe(name, v)
    assert port.snapshot() == ref.snapshot()
    assert render_prometheus(port) == ref_metrics.render_prometheus(ref)


class _ScriptedDriver(_FakeDriver):
    """A fake driver whose job ends after ``life`` ticks of running, or
    drains to EXIT_DRAINED when every worker is asked to go."""

    def __init__(self, pool, job, np_now, life, log):
        super().__init__(pool, job.name, np_now)
        self.job, self.life, self.log = job, life, log
        self.done = False

    def request_drain(self, victims, grace=None):
        super().request_drain(victims, grace)
        self.log.append(("drain", self.job.name, victims, grace))
        if victims == "all":
            self.finish(EXIT_DRAINED)

    def finish(self, rc):
        self.job.rc = rc
        self.done = True

    def tick(self):
        if not self.done:
            self.life[self.job.name] -= 1
            if self.life[self.job.name] <= 0:
                self.finish(0)


class _ScriptedThread:
    def __init__(self, driver):
        self.driver = driver

    def is_alive(self):
        return not self.driver.done

    def join(self, timeout=None):
        pass


def _scripted_fleet(module, chaos_module, discovery_module):
    """One fleet run on ``module``'s controller with scripted drivers and
    a fake clock: hosts a:2 and b:2, a low job that shrinks, a gang that
    preempts it, a serve job, and a chaos preemption. Returns (the drain
    requests, the job states at every tick, the counters, the view)."""
    log, states = [], []
    life = {"lo": 60, "mid": 12, "hi": 8, "srv": 10}
    chaos = chaos_module.FleetChaos("seed=4;job=lo,at=9,action=preempt;"
                                    "job=*,at=14,action=kill")
    controller = module.FleetController(
        discovery_module.FixedHosts({"a": 2, "b": 2}), chaos=chaos)
    drivers = []

    def fake_start(job, granted):
        drv = _ScriptedDriver(controller.pool, job, sum(granted.values()),
                              life, log)
        drivers.append(drv)
        log.append(("start", job.name, sorted(granted.items())))
        job.driver, job.thread = drv, _ScriptedThread(drv)

    controller._start_driver = fake_start
    for spec in (dict(name="lo", command="x", np=4, min_np=1),
                 dict(name="mid", command="x", np=2, min_np=2, priority=5,
                      arrival=2.0),
                 dict(name="hi", command="x", np=4, min_np=4, priority=9,
                      arrival=5.0),
                 dict(name="srv", command="x", np=2, min_np=1, priority=7,
                      arrival=11.0, kind="serve")):
        controller.submit(spec)
    t0 = 1000.0
    controller._start = t0
    for tick in range(400):
        now = t0 + 0.25 * tick
        for drv in drivers:
            drv.tick()
        controller._tick_once(now)
        states.append({n: (j.state, controller.pool.leased_slots_of(n),
                           j.live()) for n, j in controller.jobs.items()})
        if all(j.state in module.TERMINAL for j in controller.jobs.values()):
            break
    view = controller.view()
    for j in view["jobs"].values():
        j.pop("age_seconds")
    view.pop("t")
    return log, states, controller.metrics.snapshot()["counters"], view


def test_scripted_fleet_decisions_equal_the_reference():
    port = _scripted_fleet(port_controller,
                           sys.modules["horovod_tpu_torch.fleet.chaos"],
                           sys.modules["horovod_tpu_torch.elastic"
                                       ".discovery"])
    ref = _scripted_fleet(ref_controller, ref_chaos, ref_discovery)
    log, states, counters, view = port
    assert log == ref[0]
    assert states == ref[1]
    assert counters == ref[2]
    assert view == ref[3]
    # the script reaches every path it is there for
    assert all(j["state"] == "done" for j in view["jobs"].values()), view
    assert counters["fleet_shrinks_total"] >= 1
    assert counters["fleet_preemptions_total"] >= 1
    assert counters["fleet_restores_total"] >= 1
    assert counters["fleet_grows_total"] >= 1
    assert counters["fleet_preempts_injected_total"] == 1
    assert counters["fleet_job_completions_total"] == 4
    assert any(e[0] == "drain" and e[2] != "all" for e in log)


def test_view_document_keys_equal_the_reference(tmp_path):
    """The /fleet document of a fresh controller with a train and a serve
    job (one with a lineage on disk): the same keys, job keys and host
    keys as the reference's, and the same values but the clock's."""
    from horovod_tpu_torch.elastic import durable
    d = tmp_path / "ckpt"
    d.mkdir()
    docs = []
    for module, disc in ((port_controller, FixedHosts),
                         (ref_controller, ref_discovery.FixedHosts)):
        c = module.FleetController(disc({"a": 2}))
        c.submit(dict(name="t", command="x", np=2, ckpt_dir=str(d)))
        c.submit(dict(name="s", command="x", np=1, kind="serve"))
        c.pool.refresh()
        docs.append(c.view())
    port, ref = docs
    assert set(port) == set(ref) == {"t", "jobs", "hosts", "free_slots",
                                     "counters"}
    assert set(port["jobs"]["t"]) == set(ref["jobs"]["t"])
    assert port["jobs"]["s"]["kind"] == "serve"
    assert port["jobs"]["t"]["placement"] == "pack"
    port.pop("t"), ref.pop("t")
    assert port == ref
    assert durable.last_durable_step(str(d))[0] is None


def _frames(module):
    serve = _serve_doc()
    fleet = _scripted_fleet(port_controller,
                            sys.modules["horovod_tpu_torch.fleet.chaos"],
                            sys.modules["horovod_tpu_torch.elastic"
                                        ".discovery"])[3]
    fleet["t"] = 12.5
    draining = json.loads(json.dumps(fleet))
    draining["jobs"]["lo"]["state"] = "draining"
    workers = {"0": {"cycles_total": 100.0, "cycle_seconds_sum": 1.0,
                     "tensors_performed_total": 50.0,
                     "bytes_performed_total": 4.0e6,
                     "compression_bytes_in_total": 4.0e6,
                     "compression_bytes_out_total": 1.0e6,
                     "cache_hit_total": 5, "cache_miss_total": 5,
                     "autotune_active": 1.0, "autotune_rearms_total": 2.0,
                     "groups": 2, "group_tensors_total": 30.0,
                     "shm_segments_active": 2,
                     "net_shm_bytes_sent_total": 1e6,
                     "trace_spans_total": 5000.0,
                     "trace_spans_dropped_total": 3,
                     "faults_injected_total": 1,
                     "last_durable_step": 7},
               "1": {"cycles_total": 90.0, "cycle_seconds_sum": 1.0}}
    prev = {"0": dict(workers["0"], cycles_total=40.0,
                      trace_spans_total=1000.0, group_tensors_total=6.0),
            "1": dict(workers["1"], cycles_total=30.0)}
    job = _job(workers, lag=[0.5, 2.0], ages={"0": 0.0, "1": 12.0})
    prev_job = _job(prev, lag=[0.4, 1.0], ages={"0": 0.0, "1": 0.0})
    return [module.render(job, None, 0.0, "h:1"),
            module.render(job, prev_job, 2.0, "h:1"),
            module.render(_job({"0": workers["1"]}), None, 0.0, "h:1"),
            module.render_serve(serve, "h:2"),
            module.render_serve(serve["per_replica"][0], "h:3"),
            module.render_serve({}, "h:4"),
            module.render_fleet(fleet, "h:5"),
            module.render_fleet(draining, "h:5"),
            module.render_fleet({"t": 1.0}, "h:6")]


def test_hvd_top_frames_equal_the_reference(monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:34:56")
    port, ref = _frames(top), _frames(ref_top)
    assert port == ref
    assert "straggler: rank 1" in port[1] and "draining: lo" in port[7]
    assert [c[:2] for c in top._COLUMNS] == [c[:2] for c in ref_top._COLUMNS]
    assert [c[:2] for c in top._FLEET_COLUMNS] == \
        [c[:2] for c in ref_top._FLEET_COLUMNS]
    assert [c[:2] for c in top._SERVE_COLUMNS] == \
        [c[:2] for c in ref_top._SERVE_COLUMNS]


# ---------------------------------------------------------------------------
# hvd-top: the mirrors of the reference's renderer tests

def _job(per_rank, lag=None, ages=None):
    return {"size": len(per_rank), "generation": 1,
            "per_rank": per_rank,
            "age_seconds": ages if ages is not None else
            {r: 0.0 for r in per_rank},
            "rank_lag_seconds": lag if lag is not None else
            [0.0] * len(per_rank)}


def _serve_doc():
    rep = {"state": "serving", "replica": 0, "model_step": 12,
           "weights_crc": "cafe0123", "queue_depth": 2, "inflight": 1,
           "requests_total": 100, "responses_total": 97,
           "batches_total": 30, "rejects_total": 1, "errors_total": 2,
           "cancelled_total": 0, "frame_corrupt_total": 1,
           "swaps_total": 3,
           "swap_rejects_total": 1, "swap_aborts_total": 0,
           "p50_ms": 4.2, "p99_ms": 19.0}
    return {"kind": "serve-pool", "replicas": 2, "replicas_reporting": 2,
            "draining": 0, "scale_events": 1, "requests_total": 150,
            "responses_total": 140, "rejects_total": 1,
            "errors_total": 2, "swaps_total": 3, "p99_ms": 19.0,
            "frame_corrupt_total": 1, "model_steps": [11, 12],
            "per_replica": [rep,
                            # An OLDER replica mid-rolling-upgrade:
                            # its document predates the swap fields.
                            {"state": "serving", "replica": 1,
                             "model_step": 11, "weights_crc": "beef",
                             "queue_depth": 0, "requests_total": 50}]}


def test_hvd_top_serve_renders_and_tolerates_old_replicas():
    frame = top.render_serve(_serve_doc(), "test:0")
    lines = frame.splitlines()
    rows = [ln for ln in lines if ln.strip().startswith(("0 ", "1 "))
            or ln.strip().split()[:1] in (["0"], ["1"])]
    assert len(rows) == 2, frame
    # The new replica renders numbers; the old replica renders '-' in
    # the columns its summary predates, WITHOUT shifting the row.
    new_cells = rows[0].split()
    old_cells = rows[1].split()
    assert len(new_cells) == len(old_cells) == len(top._SERVE_COLUMNS) + 1
    assert "cafe0123" in new_cells
    assert "-" in old_cells  # e.g. the swp/p50 cells
    # Mixed-weights banner: a rolling swap is visibly in flight.
    assert "mixed weights" in frame
    assert "corrupt batch frame" in frame


def test_hvd_top_fleet_kind_column_tolerates_old_controller():
    fleet = {"t": 1.0, "free_slots": 0, "counters": {}, "hosts": {},
             "jobs": {"train0": {"state": "running", "priority": 0,
                                 "live": 2, "np": 2, "min_np": 1},
                      "serve0": {"state": "running", "kind": "serve",
                                 "placement": "spread", "priority": 5,
                                 "live": 2, "np": 2, "min_np": 1}}}
    frame = top.render_fleet(fleet, "test:0")
    train_row = [ln for ln in frame.splitlines()
                 if ln.startswith("train0")][0]
    serve_row = [ln for ln in frame.splitlines()
                 if ln.startswith("serve0")][0]
    assert "serve" in serve_row and "spread" in serve_row
    assert "-" in train_row.split()  # old controller doc: kind absent


def test_hvd_top_tolerates_workers_without_cmp_fields():
    """Mixed-version elastic job: rank 0 reports the new compression
    fields, rank 1 (older worker) does not. The renderer must keep the
    columns aligned and show '-' for the missing cmp value — not
    misalign or crash."""
    new_worker = {"cycles_total": 100.0, "cycle_seconds_sum": 1.0,
                  "compression_bytes_in_total": 4.0e6,
                  "compression_bytes_out_total": 1.0e6,
                  "cache_hit_total": 5, "cache_miss_total": 5}
    old_worker = {"cycles_total": 90.0, "cycle_seconds_sum": 1.0,
                  "cache_hit_total": 5, "cache_miss_total": 5}
    frame = top.render(_job({"0": new_worker, "1": old_worker}), None, 0.0,
                       "test:0")
    lines = frame.splitlines()
    rows = [ln for ln in lines if ln.strip().startswith(("0", "1"))]
    assert len(rows) == 2, frame
    header = next(ln for ln in lines if " cmp" in ln)
    cmp_col = header.index(" cmp")
    # New worker shows the live ratio; old worker shows '-' in the SAME
    # column span (no shift).
    assert "4.0x" in rows[0], frame
    assert rows[1][cmp_col:cmp_col + 5].strip() == "-", frame
    # Every row is exactly as wide as the header (nothing misaligned).
    assert all(len(r) == len(rows[0]) for r in rows), frame


def test_hvd_top_cmp_ratio_rendering():
    w = {"cycles_total": 10.0, "cycle_seconds_sum": 0.1,
         "compression_bytes_in_total": 39.0e6,
         "compression_bytes_out_total": 10.0e6}
    frame = top.render(_job({"0": w}), None, 0.0, "test:0")
    assert "3.9x" in frame, frame
    # Zero bytes out (compression never engaged) renders '-', not a
    # division error.
    w0 = dict(w, compression_bytes_in_total=0.0,
              compression_bytes_out_total=0.0)
    frame0 = top.render(_job({"0": w0}), None, 0.0, "test:0")
    assert frame0


def test_hvd_top_tun_column_and_mixed_version_tolerance():
    """The `tun` column renders tuning posture + re-arm count, and a
    mixed-version job (rank 1's summary predates the autotune fields)
    shows '-' in the same column span without shifting anything."""
    new_worker = {"cycles_total": 100.0, "cycle_seconds_sum": 1.0,
                  "cache_hit_total": 5, "cache_miss_total": 5,
                  "autotune_active": 1.0, "autotune_rearms_total": 2.0}
    old_worker = {"cycles_total": 90.0, "cycle_seconds_sum": 1.0,
                  "cache_hit_total": 5, "cache_miss_total": 5}
    frame = top.render(_job({"0": new_worker, "1": old_worker}), None, 0.0,
                       "test:0")
    lines = frame.splitlines()
    rows = [ln for ln in lines if ln.strip().startswith(("0", "1"))]
    assert len(rows) == 2, frame
    header = next(ln for ln in lines if " tun" in ln)
    tun_col = header.index(" tun")
    assert "tun/2" in rows[0], frame
    assert rows[1][tun_col:tun_col + 5].strip() == "-", frame
    assert all(len(r) == len(rows[0]) for r in rows), frame
    # Converged posture with no re-arms renders plain 'cvg'.
    cvg = dict(new_worker, autotune_active=0.0, autotune_rearms_total=0.0)
    assert "cvg" in top.render(_job({"0": cvg}), None, 0.0, "t"), "cvg"


def test_top_trc_column():
    """hvd-top's trc cell: '-' for a summary predating the trace fields
    (mixed-version elastic job), 'off' when tracing is disabled, span
    rate when flowing, '/dN' suffix once the ring ever dropped."""
    from horovod_tpu_torch.run.top import _trc_state

    assert _trc_state({}, None, 1.0, {}) == "-"
    assert _trc_state({"trace_spans_total": 0}, None, 1.0, {}) == "off"
    cur = {"trace_spans_total": 5000.0, "trace_spans_dropped_total": 0}
    prev = {"trace_spans_total": 2000.0, "trace_spans_dropped_total": 0}
    assert _trc_state(cur, prev, 2.0, {}) == "1.5k"
    cur = {"trace_spans_total": 5000.0, "trace_spans_dropped_total": 37}
    assert _trc_state(cur, prev, 2.0, {}) == "1.5k/d37"


def test_top_fleet_view_reads_either_controller():
    """Cross-reading: the port's ``run.top --fleet --once`` against the
    reference's controller endpoint, the reference's ``bin/hvd-top``
    against the port's; the port's ``/metrics`` is its registry's text;
    an endpoint that does not answer exits 1."""
    from horovod_tpu_torch.fleet.metrics import start_server
    ref_c = ref_controller.FleetController(
        ref_discovery.FixedHosts({"a": 1}), port=0)
    port_c = FleetController(FixedHosts({"a": 1}))
    port_c.submit(dict(name="s", command="x", np=1, kind="serve"))
    httpd, port_port = start_server(0, port_c.metrics, port_c.view)
    try:
        ref_c.submit(dict(name="t", command="x", np=1))
        env = util.cpu_worker_env(repo_root=str(ROOT))
        for tool, endpoint, name in (
                (["-m", "horovod_tpu_torch.run.top"], ref_c.port, "t"),
                ([str(ROOT / "bin" / "hvd-top")], port_port, "s")):
            proc = subprocess.run(
                [sys.executable] + tool + ["--fleet", "--once",
                                           "localhost:%d" % endpoint],
                env=env, capture_output=True, text=True, timeout=60)
            assert proc.returncode == 0, proc.stderr
            assert re.search(r"^%s +pending " % name, proc.stdout,
                             re.M), proc.stdout
        with urllib.request.urlopen("http://localhost:%d/metrics"
                                    % port_port, timeout=5) as resp:
            text = resp.read().decode()
        assert text == render_prometheus(port_c.metrics)
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run.top", "--fleet",
             "--once", "localhost:1"], env=env, capture_output=True,
            text=True, timeout=60)
        assert proc.returncode == 1 and "cannot reach fleet" in proc.stderr
    finally:
        httpd.shutdown()
        httpd.server_close()
        ref_c.shutdown()
