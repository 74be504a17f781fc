"""Local slots that survive an elastic generation (ROADMAP A8b-rest).

The port's elastic driver gives each worker a local slot on its host for
its whole life, the lowest one no live worker there holds; a worker's
local rank, and so its GPU, is its slot in every generation, and a serve
replica takes ``cuda:(slot mod count)``. Held here on the CPU: the
driver's assignments over a shrink and a regrow (fake processes), the
topology each rank derives from them, a respawned replica's device, and
the mirror of
``tests/test_sharded_update.py::test_elastic_shrink_then_regrow_with_sharded_update``
on gloo ranks."""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from horovod_tpu_torch.elastic import driver as edriver
from horovod_tpu_torch.elastic.discovery import FixedHosts
from horovod_tpu_torch.elastic.state import KEY_STATE, SCOPE_ELASTIC
from horovod_tpu_torch.run import util

ROOT = Path(__file__).resolve().parent.parent


class _Proc:
    """A fake worker process: alive until ``rc`` is set."""

    def __init__(self, env):
        self.env = env
        self.rc = None
        self.pid = 0

    def poll(self):
        return self.rc


@pytest.fixture
def driver(monkeypatch):
    """An ElasticDriver whose spawns are fake processes (their env kept)."""
    from horovod_tpu_torch.run import run as launcher
    monkeypatch.setattr(launcher, "launch", lambda slots, envs, command,
                        **kw: [_Proc(env) for env in envs])
    monkeypatch.setenv("HVD_TPU_ELASTIC_COOLDOWN", "0")
    drv = edriver.ElasticDriver(["true"], FixedHosts({"a": 4, "b": 2}),
                                min_np=1, max_np=6)
    drv._addr = "127.0.0.1:1"
    yield drv
    drv._server._httpd.server_close()


def _state(drv):
    return json.loads(drv._server.scope_items(SCOPE_ELASTIC)[KEY_STATE])


def _topologies(drv):
    """{worker id: (host, local rank)} as every live worker derives it
    from the published state (``bootstrap_topology``'s HVD_TPU_SLOTS and
    ``topology_of`` over the rendezvous table's hosts)."""
    state = _state(drv)
    by_rank = sorted(state["assignment"], key=state["assignment"].get)
    hosts = [drv._workers[int(w)].hostname for w in by_rank]
    slots = [state["slots"][w] for w in by_rank]
    out = {}
    for rank, w in enumerate(by_rank):
        local, local_size, cross, cross_size, _ = util.topology_of(
            hosts, rank, slots)
        assert local_size == hosts.count(hosts[rank])
        out[int(w)] = (hosts[rank], local)
    return out


def _kill(drv, wid, rc=31):
    drv._workers[wid].proc.rc = rc
    assert drv._reap()


def test_shrink_and_regrow_keep_every_survivors_slot(driver):
    """Three workers on host a, one on b; a's worker 1 dies (shrink), its
    replacement takes slot 1 (regrow); then worker 0 dies and two more
    come: no two live workers share (host, slot), no survivor's slot
    moves, and each local rank is the slot."""
    for host in ("a", "a", "a", "b"):
        driver._spawn(host)
    driver._publish()
    first = _topologies(driver)
    assert first == {0: ("a", 0), 1: ("a", 1), 2: ("a", 2), 3: ("b", 0)}
    history = [first]
    _kill(driver, 1)
    driver._publish()
    history.append(_topologies(driver))
    # the reference's order (ranks by worker id, local rank by place on
    # the host) would move worker 2 to local rank 1 here
    assert history[-1] == {0: ("a", 0), 2: ("a", 2), 3: ("b", 0)}
    assert driver._spawn("a") == 4
    driver._publish()
    history.append(_topologies(driver))
    assert history[-1][4] == ("a", 1)
    _kill(driver, 0)
    driver._publish()
    history.append(_topologies(driver))
    assert driver._spawn("a") == 5 and driver._spawn("b") == 6
    driver._publish()
    history.append(_topologies(driver))
    assert history[-1][5] == ("a", 0) and history[-1][6] == ("b", 1)
    for topo in history:
        assert len(set(topo.values())) == len(topo), topo
    for before, after in zip(history, history[1:]):
        for wid in set(before) & set(after):
            assert before[wid] == after[wid], (wid, before, after)
    # the spawn env carries the slot; the published state every slot
    assert [driver._workers[w].proc.env["HVD_TPU_LOCAL_SLOT"]
            for w in (2, 3, 4, 5, 6)] == ["2", "0", "1", "0", "1"]
    assert _state(driver)["slots"] == {"2": 2, "3": 0, "4": 1, "5": 0,
                                       "6": 1}


def test_bootstrap_sets_every_ranks_slot(monkeypatch):
    """``bootstrap_topology`` orders the published slots by rank into
    HVD_TPU_SLOTS, and ``init()``'s topology takes them as local ranks."""
    import importlib
    # the package's ``run`` is the decorator, which shadows the module
    erun = importlib.import_module("horovod_tpu_torch.elastic.run")
    info = {"generation": 3, "size": 3, "status": "running",
            "assignment": {"7": 2, "2": 0, "4": 1},
            "slots": {"7": 0, "2": 2, "4": 1}}
    monkeypatch.setattr(erun, "fetch_assignment", lambda *a, **k: info)
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_ADDR", "127.0.0.1:1")
    monkeypatch.setenv("HVD_TPU_WORKER_ID", "7")
    for key in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_GENERATION",
                "HVD_TPU_SLOTS"):
        monkeypatch.setenv(key, "")  # so that the test's end restores it
        monkeypatch.delenv(key)
    erun.bootstrap_topology()
    import os
    assert (os.environ["HVD_TPU_RANK"], os.environ["HVD_TPU_SIZE"],
            os.environ["HVD_TPU_SLOTS"]) == ("2", "3", "2,1,0")
    assert util.slots_from_env(3) == [2, 1, 0]
    assert util.slots_from_env(2) is None
    env = util.topology_env(2, ["h:1", "h:2", "h:3"], util.slots_from_env())
    assert (env["HVD_TPU_LOCAL_RANK"], env["HVD_TPU_LOCAL_SIZE"]) == \
        ("0", "3")


@pytest.mark.parametrize("hosts", [
    ["a", "b", "a", "b"], ["a", "b", "b", "a"], ["a", "a", "a", "b"],
    ["x"], ["a", "b", "c", "a", "c", "a"]])
def test_topology_without_slots_is_the_place_on_the_host(hosts):
    """Given no slots (or each rank's place among its host's ranks as its
    slot), ``topology_of`` is the reference launcher's topology."""
    places = [hosts[:r].count(h) for r, h in enumerate(hosts)]
    host_ports = ["%s:%d" % (h, 100 + r) for r, h in enumerate(hosts)]
    for rank in range(len(hosts)):
        assert util.topology_of(hosts, rank) == \
            util.topology_of(hosts, rank, places)
        env = util.topology_env(rank, host_ports)
        assert env == util.topology_env(rank, host_ports, places)
        assert env["HVD_TPU_LOCAL_RANK"] == str(places[rank])


def test_respawned_replica_takes_the_killed_replicas_gpu(driver,
                                                         monkeypatch):
    """A serve pool of two replicas on one host of two GPUs: the replica
    the test kills is respawned (a new worker id) into its slot, and so
    onto its GPU; the survivor keeps the other."""
    from horovod_tpu_torch.serve import replica
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def device_of(wid):
        env = driver._workers[wid].proc.env
        for key in ("HVD_TPU_WORKER_ID", "HVD_TPU_LOCAL_SLOT"):
            monkeypatch.setenv(key, env[key])
        args = replica.make_parser().parse_args(["--device", ""])
        args.device = None  # the default: the GPU of the slot
        return replica.Replica(args).device

    driver._spawn("a")
    driver._spawn("a")
    assert [device_of(w) for w in (0, 1)] == [torch.device("cuda", 0),
                                              torch.device("cuda", 1)]
    _kill(driver, 0, rc=-9)
    assert driver._spawn("a") == 2
    assert device_of(2) == torch.device("cuda", 0)
    assert device_of(1) == torch.device("cuda", 1)
    _kill(driver, 1, rc=-9)
    assert driver._spawn("a") == 3
    assert device_of(3) == torch.device("cuda", 1)


START = re.compile(r"worker (\S+) start step (\d+) crc ([0-9a-f]{8}) "
                   r"size (\d+) gen (\d+) local (\d+)")
DONE = re.compile(r"worker (\S+) done step (\d+) crc ([0-9a-f]{8})")


@pytest.mark.e2e
def test_elastic_shrink_then_regrow_with_sharded_update():
    """The mirror of the reference's acceptance test (docs/ZERO.md): the
    sharded Adam update under ``python -m horovod_tpu_torch.run -np 3
    --min-np 1`` on gloo ranks. Worker 1 exits at step 7 of generation 0;
    the survivors roll back to the step-5 commit, re-shard the committed
    full-form state for two ranks and go on; a respawned worker regrows
    the job to three, and every rank ends on one process's 30 steps, bit
    for bit. Every generation's local ranks are distinct, each survivor
    keeps its own, and the replacement takes worker 1's."""
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        import torch_port_durable_worker as worker
    finally:
        sys.path.remove(str(ROOT / "tests"))
    env = util.cpu_worker_env(repo_root=str(ROOT), extra_env={
        "HVD_TPU_ELASTIC_COOLDOWN": "2",
        "HVD_TPU_ELASTIC_DISCOVERY_INTERVAL": "0.3",
        "HVD_TPU_ELASTIC_CHECK_INTERVAL": "0.1",
        "HVD_TPU_START_TIMEOUT": "30",
        "DURABLE_TEST_TOTAL_STEPS": "30",
        "DURABLE_TEST_COMMIT_EVERY": "5",
        "DURABLE_TEST_CRASH_STEP": "7",
        "DURABLE_TEST_CRASH_WIDS": "1",
        "DURABLE_TEST_STEP_SLEEP": "0.25"})
    t0 = time.monotonic()
    result = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "3",
         "--min-np", "1", "--", sys.executable,
         str(ROOT / "tests" / "torch_port_durable_worker.py")],
        env=env, cwd=str(ROOT), timeout=150, capture_output=True, text=True)
    out = result.stdout
    assert result.returncode == 0, (out, result.stderr)
    assert "worker 1 crashing now" in out
    starts = [(int(w), int(s), int(n), int(g), int(loc))
              for w, s, _, n, g, loc in START.findall(out)]
    gen0 = [r for r in starts if r[3] == 0]
    shrunk = [r for r in starts if r[2] == 2]
    grown = [r for r in starts if r[3] > 0 and r[2] == 3]
    assert sorted(r[0] for r in gen0) == [0, 1, 2], out
    # shrink: two ranks resume from the step-5 commit, re-sharded
    assert shrunk and all(r[1] == 5 for r in shrunk), starts
    # regrow: a later generation at three ranks with a replacement
    assert grown and any(r[0] > 2 for r in grown), starts
    by_gen = {}
    for w, _, _, g, loc in starts:
        by_gen.setdefault(g, {})[w] = loc
    slot = {}
    for g in sorted(by_gen):
        locs = by_gen[g]
        assert len(set(locs.values())) == len(locs), (g, locs)
        for w, loc in locs.items():
            assert slot.setdefault(w, loc) == loc, (w, g, slot, loc)
    assert slot[0] == 0 and slot[2] == 2
    assert {slot[w] for w in slot if w > 2} == {1}, slot
    done = DONE.findall(out)
    assert len(done) == 3, out
    assert all(int(s) == 30 for _, s, _ in done), done
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        want = "%08x" % worker.run_steps(30)
    finally:
        hvd.shutdown()
    assert {c for _, _, c in done} == {want}, (done, want)
    assert time.monotonic() - t0 < 120
