"""The port's launcher, rendezvous and middleman (``horovod_tpu_torch.run``)
and its Spark runner against the JAX package's (``horovod_tpu.run``,
``horovod_tpu.spark``), on the CPU.

Pure functions run on both packages with the same inputs, drawn by
hypothesis from a fixed seed, and must agree exactly. The rendezvous wire
protocol is held byte-compatible both ways (a port client on the
reference's server and a reference client on the port's, signed). The
multi-process runs start gloo workers (``device="cpu"``) through
``python -m horovod_tpu_torch.run``: the dynamic rendezvous, the ssh
branch through ``tests/fake_ssh.py``, ``init(ranks=[1, 3])`` in a world of
4, the Spark run through ``tests/fake_pyspark``, and the middleman's
kill-tree. Mirrors ``test_launcher.py``, ``test_rendezvous.py``,
``test_rank_subset.py``, ``test_spark.py`` and ``test_kill_tree.py``.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
from pathlib import Path

import pytest
from hypothesis import given, settings, seed, strategies as st

from horovod_tpu.run import rendezvous as ref_rdv
from horovod_tpu.run import run as ref_run
from horovod_tpu.run import util as ref_util
from horovod_tpu.spark import _task_topology_env as ref_task_env
from horovod_tpu_torch import spark as port_spark
from horovod_tpu_torch.run import rendezvous, run as port_run, util
from horovod_tpu_torch.run.cache import Cache

ROOT = Path(__file__).resolve().parent.parent
SEED = 20261018
# every process a test starts is bounded by this many seconds
PROC_TIMEOUT = 120

hosts_st = st.lists(
    st.tuples(st.sampled_from(["a", "b", "node-1", "10.0.0.7", "h"]),
              st.integers(1, 4), st.booleans()),
    min_size=1, max_size=5)


def _hosts_string(hosts):
    return ",".join("%s:%d" % (h, n) if explicit or n != 1 else h
                    for h, n, explicit in hosts)


# ---------------------------------------------------------------------------
# Pure functions against the reference

@seed(SEED)
@settings(max_examples=60, deadline=None)
@given(hosts_st)
def test_parse_hosts_matches_the_reference(hosts):
    text = _hosts_string(hosts)
    assert util.parse_hosts(text) == ref_util.parse_hosts(text)


def test_parse_hostfile_matches_the_reference(tmp_path):
    f = tmp_path / "hostfile"
    f.write_text("hosta slots=2\n# comment\nhostb slots=4  # x\nhostc\n\n")
    assert util.parse_hostfile(str(f)) == ref_util.parse_hostfile(str(f))
    assert [(h.hostname, h.slots) for h in util.parse_hostfile(str(f))] \
        == [("hosta", 2), ("hostb", 4), ("hostc", 1)]


@seed(SEED)
@settings(max_examples=80, deadline=None)
@given(hosts_st, st.integers(1, 20))
def test_allocate_slots_matches_the_reference(hosts, np_):
    parsed = util.parse_hosts(_hosts_string(hosts))
    try:
        want = ref_util.allocate_slots(parsed, np_)
    except ValueError:
        with pytest.raises(ValueError):
            util.allocate_slots(parsed, np_)
        return
    assert [tuple(s) for s in util.allocate_slots(parsed, np_)] == \
        [tuple(s) for s in want]


@seed(SEED)
@settings(max_examples=80, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["nodeA", "nodeB", "10.1.2.3",
                                           "c"]),
                          st.integers(1, 65535)), min_size=1, max_size=9))
def test_topology_env_matches_the_reference(hosts):
    host_ports = ["%s:%d" % hp for hp in hosts]
    for rank in range(len(host_ports)):
        want = ref_util.topology_env(rank, host_ports)
        assert util.topology_env(rank, host_ports) == want
        assert port_spark._task_topology_env(rank, host_ports) == \
            ref_task_env(rank, host_ports)


def test_describe_exit_matches_the_reference():
    for rc in range(0, 200):
        assert port_run.describe_exit(rc) == ref_run.describe_exit(rc)


def test_cpu_worker_env():
    env = util.cpu_worker_env(base_env={"PYTHONUNBUFFERED": "1",
                                        "PYTHONPATH": "x"},
                              extra_env={"A": "1"}, repo_root="/repo")
    assert env["PYTHONPATH"] == "/repo" + os.pathsep + "x"
    assert env["CUDA_VISIBLE_DEVICES"] == "" and env["A"] == "1"
    assert "PYTHONUNBUFFERED" not in env


# ---------------------------------------------------------------------------
# The ssh preflight cache (a copy of the reference's)

def test_preflight_cache_roundtrip_merge_and_prune(tmp_path):
    c = Cache(str(tmp_path), staleness_minutes=60, parameters_hash="p1")
    assert c.get("ssh://a") is None
    c.put("ssh://a", True)
    assert Cache(str(tmp_path), 60, "p1").get("ssh://a") is True
    assert Cache(str(tmp_path), 60, "p2").get("ssh://a") is None
    other = Cache(str(tmp_path), 60, "p1")
    other.put("ssh://b", True)  # merges, does not clobber ssh://a
    both = Cache(str(tmp_path), 60, "p1")
    assert both.get("ssh://a") and both.get("ssh://b")
    path = tmp_path / "cache.json"
    content = json.loads(path.read_text())
    content["entries"]["ssh://a"][0] -= 3601.0
    path.write_text(json.dumps(content))
    Cache(str(tmp_path), 60, "p1").put("ssh://c", True)
    assert "ssh://a" not in json.loads(path.read_text())["entries"]
    path.write_text("{not json")  # a corrupt file heals to empty
    assert Cache(str(tmp_path), 60, "p1").get("ssh://b") is None


def test_ssh_preflight_uses_cache(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    calls.mkdir()
    probe = tmp_path / "counting_ssh.py"
    probe.write_text(
        "import os, sys, uuid\n"
        "open(os.path.join(%r, str(uuid.uuid4())), 'w').close()\n"
        "sys.exit(0)\n" % str(calls))
    monkeypatch.setenv("HVD_TPU_SSH_CMD", "%s %s" % (sys.executable, probe))
    cache = Cache(str(tmp_path / "store"), 60, "t")
    port_run.ssh_preflight(["hostA", "hostB"], fn_cache=cache)
    assert len(list(calls.iterdir())) == 2
    port_run.ssh_preflight(["hostA", "hostB"], fn_cache=cache)
    assert len(list(calls.iterdir())) == 2
    port_run.ssh_preflight(["hostA", "hostC"], fn_cache=cache)
    assert len(list(calls.iterdir())) == 3


# ---------------------------------------------------------------------------
# The rendezvous server and client

@pytest.fixture
def server():
    s = rendezvous.RendezvousServer(host="127.0.0.1")
    s.start()
    yield s
    s.stop()


def test_kv_put_get_list_and_wait_all(server):
    addr = "127.0.0.1:%d" % server.port
    assert rendezvous.get(addr, "s", "k") is None
    rendezvous.put(addr, "s", "k", b"value-1")
    rendezvous.put(addr, "s", "k2", "value-2")
    rendezvous.put(addr, "other", "k", "hidden")
    assert rendezvous.get(addr, "s", "k") == b"value-1"
    assert rendezvous.list_scope(addr, "s") == {"k": "value-1",
                                                "k2": "value-2"}
    with pytest.raises(TimeoutError, match="missing ranks"):
        rendezvous.wait_all(addr, "s", ["k", "k3"], timeout=0.3,
                            poll_interval=0.05)


def test_hmac_auth(monkeypatch):
    key = rendezvous.make_secret()
    server = rendezvous.RendezvousServer(host="127.0.0.1", key=key)
    server.start()
    addr = "127.0.0.1:%d" % server.port
    try:
        monkeypatch.delenv(rendezvous.KEY_ENV, raising=False)
        with pytest.raises(urllib.error.HTTPError) as e:
            rendezvous.put(addr, "s", "k", b"unsigned")
        assert e.value.code == 403
        monkeypatch.setenv(rendezvous.KEY_ENV, "wrong-" + key)
        with pytest.raises(RuntimeError, match="auth failed"):
            rendezvous.wait_all(addr, "s", ["k"], timeout=2)
        monkeypatch.setenv(rendezvous.KEY_ENV, key)
        rendezvous.put(addr, "s", "k", b"signed")
        assert rendezvous.get(addr, "s", "k") == b"signed"
    finally:
        server.stop()


def _resolve_all(clients, addr, timeout=30):
    """Every rank's resolve_topology on a thread, rank r through
    ``clients[r]`` (a rendezvous module); returns the envs."""
    envs, errors = [None] * len(clients), []

    def worker(rank):
        try:
            envs[rank] = clients[rank].resolve_topology(
                rank, len(clients), addr, timeout=timeout)
        except Exception as e:  # pragma: no cover
            errors.append((rank, e))

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(len(clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 10)
    rendezvous.release_held_ports()
    ref_rdv.release_held_ports()
    assert not errors, errors
    return envs


TOPOLOGY = ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_LOCAL_RANK",
            "HVD_TPU_LOCAL_SIZE", "HVD_TPU_CROSS_RANK", "HVD_TPU_CROSS_SIZE",
            "HVD_TPU_ADDRS")


def test_resolve_topology_worker_chosen_ports(server):
    envs = _resolve_all([rendezvous] * 3, "127.0.0.1:%d" % server.port)
    assert len({e["HVD_TPU_ADDRS"] for e in envs}) == 1
    ports = [int(a.rsplit(":", 1)[1])
             for a in envs[0]["HVD_TPU_ADDRS"].split(",")]
    assert len(set(ports)) == 3 and all(p > 0 for p in ports)
    for rank, env in enumerate(envs):
        assert set(env) == set(TOPOLOGY)
        assert (env["HVD_TPU_RANK"], env["HVD_TPU_LOCAL_RANK"],
                env["HVD_TPU_LOCAL_SIZE"], env["HVD_TPU_CROSS_SIZE"]) == (
            str(rank), str(rank), "3", "1")


@pytest.mark.parametrize("server_side", ["reference", "port"])
def test_protocol_interop_both_ways(server_side, monkeypatch):
    """Port and reference clients resolve one table together on either
    package's server, with signed requests: the wire protocol is the
    reference's byte for byte."""
    key = rendezvous.make_secret()
    monkeypatch.setenv(rendezvous.KEY_ENV, key)
    mod = ref_rdv if server_side == "reference" else rendezvous
    server = mod.RendezvousServer(host="127.0.0.1", key=key)
    server.start()
    try:
        envs = _resolve_all([rendezvous, ref_rdv, rendezvous, ref_rdv],
                            "127.0.0.1:%d" % server.port)
    finally:
        server.stop()
    table = envs[0]["HVD_TPU_ADDRS"]
    for rank, env in enumerate(envs):
        assert {k: env[k] for k in TOPOLOGY} == \
            ref_util.topology_env(rank, table.split(","))


def test_resolve_topology_picks_reachable_interface(server, monkeypatch):
    monkeypatch.setattr(rendezvous, "candidate_ips",
                        lambda *a, **k: ["10.255.255.1", "127.0.0.1"])
    monkeypatch.setattr(rendezvous, "probe_connect",
                        lambda ip, port, timeout=None: ip == "127.0.0.1")
    envs = _resolve_all([rendezvous] * 2, "127.0.0.1:%d" % server.port)
    for env in envs:
        assert all(a.startswith("127.0.0.1:")
                   for a in env["HVD_TPU_ADDRS"].split(","))


def test_resolve_topology_unreachable_advertise_fails_fast(server,
                                                           monkeypatch):
    monkeypatch.setattr(rendezvous, "candidate_ips",
                        lambda *a, **k: ["10.255.255.1"])
    monkeypatch.setattr(rendezvous, "probe_connect",
                        lambda ip, port, timeout=None: False)
    addr = "127.0.0.1:%d" % server.port
    errors = []

    def worker(rank):
        try:
            rendezvous.resolve_topology(rank, 2, addr, timeout=15)
        except Exception as e:
            errors.append(e)

    t0 = time.monotonic()
    threads = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    rendezvous.release_held_ports()
    assert len(errors) == 2
    assert all("10.255.255.1" in str(e) and "firewall" in str(e)
               for e in errors)
    assert time.monotonic() - t0 < 20


def test_reserve_port_holds_until_released():
    port = rendezvous.reserve_port(hold=True)
    assert 0 < port < 65536 and rendezvous._held_sockets
    rendezvous.release_held_ports()
    assert not rendezvous._held_sockets
    assert 0 < rendezvous.reserve_port() < 65536


# ---------------------------------------------------------------------------
# The launcher: options and the capability matrix

def test_table_store_bind_failure_names_the_port():
    """Rank 0 binds the process group's store once on its port of the
    table; a port that another process holds raises an error naming it."""
    import socket
    from horovod_tpu_torch.common import basics
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        port = taken.getsockname()[1]
        with pytest.raises(RuntimeError, match="port %d" % port):
            basics._table_store(["127.0.0.1:%d" % port], 0, 2, 5)


@pytest.mark.parametrize("explicit", [
    dict(store=True, rank=0, size=1), dict(rank=0), dict(size=1)])
def test_rank_subset_init_takes_no_store_rank_or_size(explicit):
    """init(ranks=) forms the subset from the launcher's table only."""
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    if explicit.get("store"):
        explicit = dict(explicit, store=dist.HashStore())
    with pytest.raises(ValueError, match="ranks="):
        hvd.init(device="cpu", ranks=[0], **explicit)
    assert not hvd.is_initialized()


def test_check_build_reports_the_ports_matrix():
    out = io.StringIO()
    port_run.check_build(out)
    text = out.getvalue()
    for row in ("PyTorch", "[X] TCP (dynamic rendezvous)", "gloo",
                "NCCL", "nvcc", "flash_fwd.cu", "batch_norm.cu",
                "crc32c"):
        assert row in text, (row, text)


def test_restart_from_ckpt_needs_ckpt_dir(monkeypatch, capsys):
    monkeypatch.delenv("HVD_TPU_CKPT_DIR", raising=False)
    with pytest.raises(SystemExit):
        port_run.main(["-np", "1", "--restart-from-ckpt", "--min-np", "1",
                       "--", "true"])
    assert "requires --ckpt-dir" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Launched multi-process runs (gloo workers on the CPU)

def _env(extra=None):
    return util.cpu_worker_env(extra_env=extra, repo_root=str(ROOT))


def _launch(args, env=None, timeout=PROC_TIMEOUT):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run"] + list(args),
        env=env or _env(), cwd=str(ROOT), timeout=timeout,
        capture_output=True, text=True)


def _topologies(out):
    return [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
            if line.startswith("TOPOLOGY ")]


OPS_WORKER = str(ROOT / "tests" / "torch_port_launch_ops_worker.py")


def test_launcher_dynamic_rendezvous_and_rank_subset():
    """Four gloo workers that get only rank, size and the rendezvous
    address: init() resolves the table, binds rank 0's store on its
    reserved port (no MASTER_ADDR: the workers assert it) and takes the
    local rank from the table; then init(ranks=[1, 3]): world ranks 1
    and 3 form a group of 2 (sub-ranks in the listed order, its store
    bound by world rank 1), 0 and 2 a group of 1 each (the workers check
    every group's collectives)."""
    env = _env()
    env.pop("MASTER_ADDR", None)
    result = _launch(["-np", "4", sys.executable, OPS_WORKER,
                      "--subset", "1,3"], env=env)
    assert result.returncode == 0, (result.stdout, result.stderr)
    tops = _topologies(result.stdout)
    world = sorted((t for t in tops if t["init"] == "world"),
                   key=lambda t: t["rank"])
    assert [(t["rank"], t["size"], t["local_rank"], t["local_size"],
             t["cross_rank"], t["cross_size"], t["homogeneous"])
            for t in world] == [(r, 4, r, 4, 0, 1, True) for r in range(4)]
    assert len({t["addrs"] for t in world}) == 1
    assert len(world[0]["addrs"].split(",")) == 4
    sub = {t["world_rank"]: t for t in tops if t["init"] == "subset"}
    assert {w: (t["rank"], t["size"], t["local_rank"])
            for w, t in sub.items()} == {
        0: (0, 1, 0), 1: (0, 2, 0), 2: (0, 1, 0), 3: (1, 2, 1)}
    table = world[0]["addrs"].split(",")
    assert sub[1]["addrs"] == sub[3]["addrs"] == \
        ",".join([table[1], table[3]])


def test_launcher_ssh_remote_branch():
    """The remote branch end to end (ssh fan-out, connect-back
    preflight, the secret over stdin, the env-export filter, the remote
    middleman) with a fake ssh that runs the command here."""
    result = _launch(
        ["-np", "2", "-H", "fakehost-a:1,fakehost-b:1", "--",
         sys.executable, OPS_WORKER],
        env=_env({"HVD_TPU_SSH_CMD": "%s %s" % (
            sys.executable, ROOT / "tests" / "fake_ssh.py"),
            "HVD_TPU_REMOTE_PYTHON": sys.executable,
            "HVD_TPU_DISABLE_CACHE": "1"}))
    assert result.returncode == 0, (result.stdout, result.stderr)
    tops = _topologies(result.stdout)
    assert sorted(t["rank"] for t in tops) == [0, 1]
    assert {t["size"] for t in tops} == {2}


def test_launcher_failure_summary_names_the_first_failing_rank():
    result = _launch(["-np", "1", "--", sys.executable, "-c",
                      "import sys; sys.exit(3)"])
    assert result.returncode == 3
    assert "first failing rank was rank 0 (exit code 3)" in result.stderr


# ---------------------------------------------------------------------------
# Spark

def test_spark_run_without_pyspark():
    with pytest.raises(ImportError, match="pyspark"):
        port_spark.run(lambda: 1, num_proc=2)


def test_spark_run_e2e_fake_pyspark():
    """``spark.run()`` itself through the fake pyspark: each barrier task
    a forked process that publishes its host:port, calls
    ``hvd.init(device="cpu")`` on the static table and allreduces."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_port_spark_worker.py")],
        env=_env(), timeout=PROC_TIMEOUT, capture_output=True, text=True)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "spark run ok" in proc.stdout, proc.stdout


# ---------------------------------------------------------------------------
# The middleman's kill-tree

GRANDCHILD = (
    "import os, subprocess, sys, time\n"
    "subprocess.Popen([sys.executable, '-c', \"import os, sys, time; "
    "open(sys.argv[1], 'w').write(str(os.getpid())); time.sleep(300)\", "
    "sys.argv[1]], start_new_session=True)\n"
    "while not (os.path.exists(sys.argv[1]) and "
    "os.path.getsize(sys.argv[1])):\n"
    "    time.sleep(0.02)\n"
    "if sys.argv[2] == 'wait':\n"
    "    print('ready', flush=True)\n"
    "    time.sleep(300)\n")


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        with open("/proc/%d/stat" % pid) as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _gone(pid, timeout=10):
    deadline = time.monotonic() + timeout
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    return not _alive(pid)


@pytest.mark.parametrize("how", ["killed", "clean_exit"])
def test_middleman_reaps_setsid_descendants(tmp_path, how):
    """A worker's grandchild in its own session (out of reach of a
    process-group kill) dies with the middleman: when the launcher's
    teardown signals the middleman's group, and when the command exits 0
    leaving it behind."""
    pidfile = str(tmp_path / "grandchild.pid")
    mm = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run.exec_middleman", "--",
         sys.executable, "-c", GRANDCHILD, pidfile,
         "wait" if how == "killed" else "exit"],
        env=_env(), cwd=str(ROOT), start_new_session=True,
        stdout=subprocess.PIPE, text=True)
    grandchild = None
    try:
        if how == "killed":
            assert mm.stdout.readline().strip() == "ready"
            grandchild = int(open(pidfile).read())
            assert _alive(grandchild)
            os.killpg(os.getpgid(mm.pid), signal.SIGTERM)
            assert mm.wait(timeout=30) == 128 + signal.SIGTERM
        else:
            assert mm.wait(timeout=PROC_TIMEOUT) == 0
            grandchild = int(open(pidfile).read())
        assert _gone(grandchild), "grandchild %d survived" % grandchild
    finally:
        if mm.poll() is None:
            mm.kill()
        if grandchild is not None and _alive(grandchild):
            os.kill(grandchild, signal.SIGKILL)
