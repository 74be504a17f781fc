"""The port's launcher: ``python -m horovod_tpu_torch.run -np N cmd``.

Copy of ``horovod_tpu/run/run.py`` (``horovodrun_tpu``) for the port.
Starts N copies of a training script, the way the reference ``horovodrun``
does for its Gloo path (Horovod's horovod/run/run.py:379-508 +
gloo_run.py:156-233): local slots via subprocess, remote slots via ssh
(after a reachability preflight, ref run/run.py:53-106), each through the
process-tree middleman (``exec_middleman.py``). SIGINT/SIGTERM fan out to
every launched process.

Rendezvous is dynamic by default: the launcher hosts a KV server and
injects only HVD_TPU_RANK / HVD_TPU_SIZE / HVD_TPU_RENDEZVOUS_ADDR;
every worker's ``hvd.init()`` reserves a free port, publishes it, and
derives the local/cross topology from the published peer table
(``rendezvous.py``); rank 0 then binds the process group's ``TCPStore``
on its reserved port, so no worker reads ``MASTER_ADDR``.
``--start-port`` switches to a static pre-assigned port table.

``--min-np`` / ``--max-np`` / ``--host-discovery-script`` switch to the
ELASTIC supervisor (``horovod_tpu_torch/elastic/driver.py``): a failing
worker shrinks the job instead of tearing it down, recovered hosts grow
it back, and failing hosts are blacklisted with exponential backoff.
``--ckpt-dir`` makes elastic commits durable, ``--restart-from-ckpt``
restarts the whole job from the newest durable checkpoint when the world
falls below ``--min-np``.

Not ported: the reference's TPU pod auto-discovery (``--tpu-pod``, TPU VM
metadata, which has no GPU counterpart), and two options whose modules
come later: ``--lint`` (ROADMAP A8g) and ``--metrics-port`` (A8d) raise
``NotImplementedError`` naming them.

This module imports no torch: the launcher and the elastic driver start
without it, and ``--check-build`` imports it only to report it.
"""

import argparse
import json
import os
import shlex
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import rendezvous, util
# Workers that honor a graceful drain exit with this code: the launcher
# must read it as a planned hand-back, not a failure.
from ..elastic.state import EXIT_DRAINED  # noqa: E402

# The directory that holds horovod_tpu_torch/: put first on the workers'
# PYTHONPATH, so the middleman and the workers import this checkout.
PACKAGE_ROOT = str(Path(__file__).resolve().parent.parent.parent)


def _importable(mod):
    import importlib.util
    return importlib.util.find_spec(mod) is not None


def check_build(out=sys.stdout):
    """Prints the port's capability matrix (reference: run.py:262-298):
    torch and the CUDA it was built for, the collective backends, nvcc,
    and which of the hand-written kernels and the durable checkpoints'
    crc32c library are built in this checkout (nothing is built here)."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch import __version__
    from horovod_tpu_torch.elastic import durable
    from horovod_tpu_torch.ops import _build

    def flag(v):
        return "X" if v else " "

    try:
        nvcc = _build.nvcc()
    except _build.KernelBuildError:
        nvcc = None
    cuda = torch.cuda.is_available()
    lines = [
        "Horovod-TPU PyTorch port v%s:" % __version__,
        "",
        "Available frameworks:",
        "    [X] PyTorch %s (CUDA %s)" % (torch.__version__,
                                          torch.version.cuda or "none"),
        "",
        "Available controllers:",
        "    [X] TCP (dynamic rendezvous)",
        "",
        "Available data planes:",
        "    [%s] gloo (CPU tensors)" % flag(dist.is_gloo_available()),
        "    [%s] NCCL (CUDA tensors)" % flag(dist.is_nccl_available()),
        "",
        "Devices:",
        "    [%s] CUDA: %s" % (flag(cuda), ", ".join(
            torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())) if cuda
            else "none"),
        "    [%s] nvcc: %s" % (flag(nvcc), nvcc or "not found"),
        "",
        "Built kernels (CUDA, sm_90a; they build at first use):",
    ]
    for name in _build.SOURCES:
        lines.append("    [%s] %s.cu" % (
            flag(_build.library_path(name).exists()), name))
    lines.append("    [%s] crc32c (durable checkpoints, g++)"
                 % flag(durable.native_library_path().exists()))
    out.write("\n".join(lines) + "\n")


def make_parser():
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.run",
        description="Launch a horovod_tpu_torch distributed job.")
    parser.add_argument("-np", "--num-proc", type=int, default=None,
                        help="number of processes to launch")
    parser.add_argument("-H", "--hosts", default=None,
                        help='host slots, e.g. "localhost:4,host2:4"')
    parser.add_argument("--hostfile", default=None,
                        help='hostfile; lines "hostname slots=N"')
    parser.add_argument("--start-port", type=int, default=0,
                        help="base port for rendezvous (0 = auto for local)")
    parser.add_argument("--min-np", type=int, default=None,
                        help="elastic mode: minimum world size the job "
                             "may shrink to before the driver gives up")
    parser.add_argument("--max-np", type=int, default=None,
                        help="elastic mode: maximum world size to grow "
                             "to (default: -np)")
    parser.add_argument("--host-discovery-script", default=None,
                        help="elastic mode: executable printing one "
                             "'host' or 'host:slots' line per available "
                             "host; polled to grow/shrink the job")
    parser.add_argument("--ckpt-dir", default=None,
                        help="durable checkpoint directory: elastic "
                             "commits are asynchronously written here "
                             "as CRC-checksummed shards + manifest, and "
                             "a fresh job auto-resumes from the newest "
                             "valid one (docs/ELASTIC.md 'Durability')")
    parser.add_argument("--restart-from-ckpt", action="store_true",
                        help="elastic mode with --ckpt-dir: when the "
                             "world would fall below --min-np, perform "
                             "a full-job restart that resumes from the "
                             "newest durable checkpoint instead of "
                             "tearing the job down (bounded by "
                             "HVD_TPU_CKPT_MAX_RESTARTS, default 3)")
    parser.add_argument("--drain-grace", type=float, default=None,
                        metavar="SECONDS",
                        help="graceful drain window (docs/FLEET.md): on "
                             "SIGTERM the launcher publishes a drain "
                             "request instead of killing — workers "
                             "finish the in-flight step, force a "
                             "durable commit, and exit cleanly (code "
                             "83) — and only escalates to a hard tree "
                             "kill after SECONDS. Needs the dynamic "
                             "rendezvous KV (np > 1 without "
                             "--start-port), or elastic mode")
    parser.add_argument("--ssh-port", type=int, default=None)
    parser.add_argument("--start-timeout", type=int, default=60,
                        help="seconds to wait for all ranks to connect")
    parser.add_argument("--check-build", action="store_true")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="live Prometheus metrics: not ported yet "
                             "(ROADMAP A8d); raises NotImplementedError")
    parser.add_argument("--lint", nargs="?", const="warn",
                        choices=("warn", "strict", "verify"), default=None,
                        help="hvd-lint preflight: not ported yet "
                             "(ROADMAP A8g); raises NotImplementedError")
    parser.add_argument("--disable-cache", action="store_true",
                        help="re-run host checks even if cached "
                             "(reference: horovodrun --disable-cache; "
                             "successful ssh probes are otherwise "
                             "remembered for 60 minutes in "
                             "~/.horovod_tpu_torch/cache.json)")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="command to run, e.g. python train.py")
    return parser


def make_log_dir():
    """Per-job worker log directory (HVD_TPU_LOG_DIR overrides the
    tmp default). Every rank's middleman tees its output into
    ``rank<k>.log`` here, so the failure summary can name the exact log
    of the first-failing rank. Returns None when unwritable."""
    log_dir = os.environ.get("HVD_TPU_LOG_DIR")
    try:
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            return log_dir
        return tempfile.mkdtemp(prefix="hvd_tpu_logs_")
    except OSError:
        return None


def describe_exit(rc):
    """Human-readable exit status: middlemen report signal deaths as
    128+signum (shell convention)."""
    if rc > 128 and rc <= 128 + 64:
        try:
            name = signal.Signals(rc - 128).name
        except ValueError:
            name = "signal %d" % (rc - 128)
        return "killed by %s" % name
    return "exit code %d" % rc


def worker_base_env(env=None):
    """The env every worker starts from: ``env`` (default: this
    process's), with this checkout's root first on ``PYTHONPATH``."""
    env = dict(env if env is not None else os.environ)
    path = env.get("PYTHONPATH", "")
    if path.split(os.pathsep)[0] != PACKAGE_ROOT:
        env["PYTHONPATH"] = PACKAGE_ROOT + (os.pathsep + path if path
                                            else "")
    return env


def build_env(slot, addrs, base_env=None):
    env = dict(base_env if base_env is not None else os.environ)
    env.update({
        "HVD_TPU_RANK": str(slot.rank),
        "HVD_TPU_SIZE": str(slot.size),
        "HVD_TPU_LOCAL_RANK": str(slot.local_rank),
        "HVD_TPU_LOCAL_SIZE": str(slot.local_size),
        "HVD_TPU_CROSS_RANK": str(slot.cross_rank),
        "HVD_TPU_CROSS_SIZE": str(slot.cross_size),
        "HVD_TPU_ADDRS": ",".join(addrs),
    })
    return env


def _ssh_base_cmd(extra_opts=(), ssh_port=None):
    """The remote-shell argv prefix. HVD_TPU_SSH_CMD overrides the
    program (bastion wrappers, agents — and it lets tests drive the
    remote branch with a fake ssh that execs locally); the standard
    non-interactive options are only added for real ssh."""
    override = os.environ.get("HVD_TPU_SSH_CMD")
    if override:
        cmd = shlex.split(override)
    else:
        cmd = ["ssh", "-o", "StrictHostKeyChecking=no"] + list(extra_opts)
    if ssh_port:
        cmd += ["-p", str(ssh_port)]
    return cmd


def _preflight_cache(ssh_port):
    """60-minute on-disk cache of successful host checks (reference:
    run/run.py:421-424 + run/util/cache.py), keyed by the remote-shell
    configuration so an ssh-command/port change invalidates it.
    Disabled by --disable-cache / HVD_TPU_DISABLE_CACHE=1."""
    if os.environ.get("HVD_TPU_DISABLE_CACHE") == "1":
        return None
    from .cache import Cache
    params = "%r:%r" % (_ssh_base_cmd(), ssh_port)
    folder = os.path.join(os.path.expanduser("~"), ".horovod_tpu_torch")
    try:
        return Cache(folder, staleness_minutes=60,
                     parameters_hash=params)
    except OSError:
        return None  # unwritable home: probe uncached


def ssh_preflight(hostnames, ssh_port=None, timeout=5, fn_cache=None):
    """Verifies every remote host is reachable over non-interactive ssh
    before launching anything (reference: run/run.py:53-106). Raises with
    an actionable message listing the unreachable hosts. Successful
    checks are remembered in `fn_cache` (only successes — a host that
    failed is re-probed next run, like the reference's None-result
    rule)."""
    import concurrent.futures

    CACHED = "cached"

    def probe(host):
        if fn_cache is not None and fn_cache.get("ssh://" + host):
            return host, 0, CACHED
        cmd = _ssh_base_cmd(
            ["-o", "BatchMode=yes", "-o", "ConnectTimeout=%d" % timeout],
            ssh_port=ssh_port)
        cmd += [host, "true"]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=timeout + 10)
            return host, r.returncode, r.stderr.strip()
        except (subprocess.TimeoutExpired, OSError) as e:
            return host, 255, str(e)

    failures = []
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(32, len(hostnames))) as pool:
        for host, rc, err in pool.map(probe, hostnames):
            if rc != 0:
                failures.append((host, err))
            elif fn_cache is not None and err is not CACHED:
                # Record REAL probes only: re-putting a cache hit would
                # slide the entry's timestamp forever and the 60-minute
                # staleness window would never re-probe a frequently
                # used host.
                fn_cache.put("ssh://" + host, True)
    if failures:
        detail = "\n".join("  %s: %s" % (h, e or "ssh exited nonzero")
                           for h, e in failures)
        raise RuntimeError(
            "ssh preflight failed for %d host(s):\n%s\n"
            "Ensure passwordless (key-based) ssh to every host in -H/"
            "--hostfile works from this machine, e.g. "
            "`ssh -o BatchMode=yes %s true`." %
            (len(failures), detail, failures[0][0]))


def rendezvous_preflight(remote_host, addr, port, ssh_port=None,
                         timeout=8):
    """Connect-back check: `remote_host` must be able to open a TCP
    connection to the launcher's advertised rendezvous address. Raises
    with an actionable message naming the override knob when it can't
    (reference analogue: the driver/task service reachability probes,
    run/run.py:189-259)."""
    cmd = _ssh_base_cmd(
        ["-o", "BatchMode=yes", "-o", "ConnectTimeout=%d" % timeout],
        ssh_port=ssh_port)
    probe = "timeout %d bash -c 'exec 3<>/dev/tcp/%s/%d' 2>&1" % (
        timeout, addr, port)
    cmd += [remote_host, probe]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout + 15)
    except (subprocess.TimeoutExpired, OSError) as e:
        raise RuntimeError(
            "rendezvous connect-back preflight could not run on %s: %s"
            % (remote_host, e))
    if r.returncode != 0:
        raise RuntimeError(
            "remote host %s cannot reach the launcher's rendezvous "
            "address %s:%d (%s). The launcher guessed this interface "
            "from its route toward %s; on multi-NIC machines set "
            "HVD_TPU_RENDEZVOUS_HOST=<ip reachable from the workers> "
            "or fix the firewall/route." %
            (remote_host, addr, port,
             (r.stdout + r.stderr).strip() or "connection refused/timed "
             "out", remote_host))


def launch(slots, rank_envs, command, ssh_port=None, verbose=False):
    """Launches one process per slot; returns the list of Popens."""
    procs = []
    for slot, rank_env in zip(slots, rank_envs):
        if util.is_local_host(slot.hostname):
            if verbose:
                sys.stderr.write("[launcher] rank %d local: %s\n" %
                                 (slot.rank, " ".join(command)))
            # Via the middleman so teardown reaps the worker's WHOLE
            # descendant tree — killpg alone misses grandchildren that
            # re-sessioned with setsid (see exec_middleman.py).
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "horovod_tpu_torch.run.exec_middleman",
                 "--"] + list(command),
                env=rank_env, start_new_session=True))
        else:
            # Remote launch over ssh with explicit env exports. The
            # rendezvous secret must NOT ride the command line (argv is
            # world-readable via ps on both hosts); it is piped over the
            # ssh channel's stdin instead.
            secret = rank_env.get(rendezvous.KEY_ENV)
            exports = " ".join(
                "%s=%s" % (k, shlex.quote(v))
                for k, v in rank_env.items()
                if (k.startswith("HVD_TPU_") or k in ("PYTHONPATH", "PATH"))
                and k != rendezvous.KEY_ENV)
            ssh_cmd = _ssh_base_cmd(ssh_port=ssh_port)
            # Same middleman wrapping as local slots: the remote
            # worker's descendant tree (incl. setsid'd helpers) dies
            # with the ssh channel, not just its process group.
            # Requires a python + horovod_tpu_torch importable remotely —
            # both already required to run the worker itself.
            # HVD_TPU_REMOTE_PYTHON names the remote interpreter (venv
            # workers where bare `python3` is the wrong env).
            remote_py = (rank_env.get("HVD_TPU_REMOTE_PYTHON") or
                         os.environ.get("HVD_TPU_REMOTE_PYTHON") or
                         "python3")
            remote = "cd %s && env %s %s -m " \
                "horovod_tpu_torch.run.exec_middleman -- %s" % (
                    shlex.quote(os.getcwd()), exports,
                    shlex.quote(remote_py),
                    " ".join(shlex.quote(c) for c in command))
            if secret is not None:
                remote = ("IFS= read -r %s && export %s && " %
                          (rendezvous.KEY_ENV, rendezvous.KEY_ENV)) + remote
            if verbose:
                sys.stderr.write("[launcher] rank %d ssh %s\n" %
                                 (slot.rank, slot.hostname))
            proc = subprocess.Popen(
                ssh_cmd + [slot.hostname, remote],
                start_new_session=True,
                stdin=subprocess.PIPE if secret is not None else None)
            if secret is not None:
                proc.stdin.write((secret + "\n").encode())
                proc.stdin.close()
            procs.append(proc)
    return procs


def run_command(np, hosts, command, start_port=0, ssh_port=None,
                start_timeout=60, verbose=False, env=None,
                drain_grace=None):
    """Programmatic entry: launch and wait; returns max exit code
    (EXIT_DRAINED after a SIGTERM-driven graceful drain when
    `drain_grace` is set)."""
    host_list = util.parse_hosts(hosts) if isinstance(hosts, str) else hosts
    slots = util.allocate_slots(host_list, np)

    all_local = all(util.is_local_host(s.hostname) for s in slots)
    remote_hosts = sorted({s.hostname for s in slots
                           if not util.is_local_host(s.hostname)})
    if remote_hosts:
        ssh_preflight(remote_hosts, ssh_port=ssh_port,
                      fn_cache=_preflight_cache(ssh_port))

    base_env = worker_base_env(env)
    base_env.setdefault("HVD_TPU_START_TIMEOUT", str(start_timeout))
    if drain_grace:
        # Rank-uniform drain-polling gate (elastic/run.py): set at spawn
        # time for EVERY worker, so the per-commit agreement allreduce
        # is enabled identically across the job.
        base_env["HVD_TPU_DRAIN_ENABLE"] = "1"

    # Local slots must be advertised with an address the *other hosts*
    # can reach; 127.0.0.1 is only valid when every slot is local.
    # HVD_TPU_RENDEZVOUS_HOST overrides the kernel-route guess on
    # multi-NIC launchers.
    local_addr = base_env.get("HVD_TPU_RENDEZVOUS_HOST") or (
        "127.0.0.1" if all_local
        else rendezvous.routable_ip(remote_hosts[0]))

    server = None
    if start_port:
        # Static pre-assigned port table (compat path).
        ports = [start_port + i for i in range(np)]
        addrs = ["%s:%d" % (slot.hostname
                            if not util.is_local_host(slot.hostname)
                            else local_addr, port)
                 for slot, port in zip(slots, ports)]
        rank_envs = [build_env(slot, addrs, base_env) for slot in slots]
    elif np == 1:
        rank_envs = [build_env(slots[0], ["127.0.0.1:0"], base_env)]
    else:
        # Dynamic rendezvous: workers pick their own ports and publish
        # them to the launcher-hosted KV server. Requests are signed
        # with a per-job secret so a network peer can't poison the
        # peer table.
        rdv_key = rendezvous.make_secret()
        server = rendezvous.RendezvousServer(key=rdv_key)
        rdv_addr = "%s:%d" % (local_addr, server.start())
        if remote_hosts:
            # Connect-back preflight: before launching all ranks,
            # verify one remote host can actually reach the advertised
            # rendezvous address (a wrong interface guess otherwise
            # surfaces as every worker hanging until timeout).
            rendezvous_preflight(remote_hosts[0], local_addr,
                                 server.port, ssh_port=ssh_port)
        rank_envs = []
        for slot in slots:
            rank_env = dict(base_env)
            # A stale address table in the caller's env must not bypass
            # the rendezvous the workers are about to perform.
            for key in ("HVD_TPU_ADDRS", "HVD_TPU_LOCAL_RANK",
                        "HVD_TPU_LOCAL_SIZE", "HVD_TPU_CROSS_RANK",
                        "HVD_TPU_CROSS_SIZE"):
                rank_env.pop(key, None)
            rank_env.update({
                "HVD_TPU_RANK": str(slot.rank),
                "HVD_TPU_SIZE": str(slot.size),
                "HVD_TPU_RENDEZVOUS_ADDR": rdv_addr,
                rendezvous.KEY_ENV: rdv_key,
            })
            rank_envs.append(rank_env)

    # Per-rank tee'd logs: the middleman duplicates each worker's output
    # into rank<k>.log so a torn-down job's failure summary can point at
    # the first-failing rank's exact log. Local slots only — a
    # launcher-local tmp path does not exist on a remote host (set
    # HVD_TPU_LOG_DIR to a path valid everywhere to tee remote ranks
    # too; remote output still streams through the ssh channel either
    # way). The tmp dir is created lazily and removed again when the
    # job succeeds, so a long-lived launcher host doesn't accumulate
    # one directory per run.
    tee_slots = [i for i, slot in enumerate(slots)
                 if util.is_local_host(slot.hostname)
                 or os.environ.get("HVD_TPU_LOG_DIR")]
    log_dir = make_log_dir() if tee_slots else None
    log_paths = [None] * len(slots)
    if log_dir is not None:
        for i in tee_slots:
            log_paths[i] = os.path.join(log_dir,
                                        "rank%d.log" % slots[i].rank)
            rank_envs[i]["HVD_TPU_LOG_FILE"] = log_paths[i]

    procs = launch(slots, rank_envs, command, ssh_port=ssh_port,
                   verbose=verbose)

    # Graceful drain (docs/FLEET.md): a SIGTERM with --drain-grace set
    # publishes a drain request on the rendezvous KV instead of killing
    # — workers finish the in-flight step, force a durable commit, and
    # exit EXIT_DRAINED; the launcher escalates to the middleman's
    # kill_tree only after the grace window. Needs the KV server, so
    # the static port table and np==1 fall back to the immediate kill.
    drain = {"requested": False, "published_at": None,
             "escalated": False}

    def kill_all(signum, frame):
        if (signum == signal.SIGTERM and drain_grace
                and server is not None and not drain["requested"]):
            drain["requested"] = True
            return  # the poll loop publishes and supervises the drain
        for p in procs:
            try:
                os.killpg(os.getpgid(p.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        sys.exit(1)

    old_int = signal.signal(signal.SIGINT, kill_all)
    old_term = signal.signal(signal.SIGTERM, kill_all)
    try:
        # Poll (rather than wait in rank order) so the FIRST failure —
        # the root cause, not the teardown collateral — is the one the
        # summary names.
        exit_code = 0
        first_fail = None  # (slot, rc, log_path)
        drained_ranks = []
        pending = set(range(len(procs)))
        while pending:
            if drain["requested"] and drain["published_at"] is None:
                from ..elastic.state import KEY_DRAIN, SCOPE_ELASTIC
                server.put_local(SCOPE_ELASTIC, KEY_DRAIN, json.dumps({
                    "epoch": 1, "workers": "all",
                    "grace": drain_grace}))
                drain["published_at"] = time.monotonic()
                sys.stderr.write(
                    "[launcher] SIGTERM: drain requested (grace %.0fs); "
                    "workers will durable-commit and exit\n"
                    % drain_grace)
            if (drain["published_at"] is not None
                    and not drain["escalated"]
                    and time.monotonic() - drain["published_at"]
                    > drain_grace):
                drain["escalated"] = True
                sys.stderr.write(
                    "[launcher] drain grace expired; escalating to "
                    "kill_tree for %d remaining worker(s)\n"
                    % sum(1 for p in procs if p.poll() is None))
                for q in procs:
                    if q.poll() is None:
                        try:
                            os.killpg(os.getpgid(q.pid), signal.SIGTERM)
                        except (ProcessLookupError, PermissionError):
                            pass
            progressed = False
            for i in sorted(pending):
                rc = procs[i].poll()
                if rc is None:
                    continue
                pending.discard(i)
                progressed = True
                if rc == 0:
                    continue
                if drain["requested"] and (
                        rc == EXIT_DRAINED or drain["escalated"]):
                    # Voluntary exit under an active drain (or the
                    # launcher's own escalation kill): planned, not a
                    # failure.
                    drained_ranks.append(slots[i].rank)
                    continue
                exit_code = max(exit_code, rc if rc > 0 else 1)
                if first_fail is None:
                    first_fail = (slots[i], rc, log_paths[i])
                    if not drain["requested"]:
                        # One failed rank: tear down the rest (they
                        # would hang in negotiation otherwise). Under a
                        # drain the peers are already on their way out.
                        for q in procs:
                            if q.poll() is None:
                                try:
                                    os.killpg(os.getpgid(q.pid),
                                              signal.SIGTERM)
                                except (ProcessLookupError,
                                        PermissionError):
                                    pass
            if pending and not progressed:
                time.sleep(0.05)
        if drain["requested"] and exit_code == 0:
            sys.stderr.write(
                "[launcher] drain complete: %d worker(s) exited "
                "cleanly under the drain%s\n"
                % (len(drained_ranks),
                   " (after escalation)" if drain["escalated"] else ""))
            ckpt_dir = os.environ.get("HVD_TPU_CKPT_DIR")
            if ckpt_dir:
                from ..elastic.durable import describe_last_durable
                sys.stderr.write(
                    "[launcher] %s\n" % describe_last_durable(ckpt_dir))
            if drained_ranks:
                # EXIT_DRAINED (not 0) so a supervisor can tell a
                # preempted job from a completed one; ranks that
                # finished before the drain landed still count as a
                # completed job.
                return EXIT_DRAINED
        if first_fail is not None:
            slot, rc, log_path = first_fail
            where = ("" if util.is_local_host(slot.hostname)
                     else " on %s" % slot.hostname)
            sys.stderr.write(
                "[launcher] job failed: first failing rank was rank %d%s "
                "(%s); worker log: %s\n"
                % (slot.rank, where, describe_exit(rc),
                   log_path or "<unavailable>"))
            ckpt_dir = os.environ.get("HVD_TPU_CKPT_DIR")
            if ckpt_dir:
                # Durable checkpoints were on: tell the operator what a
                # relaunch of this same command recovers.
                from ..elastic.durable import describe_last_durable
                sys.stderr.write(
                    "[launcher] %s\n" % describe_last_durable(ckpt_dir))
        elif (exit_code == 0 and log_dir is not None
              and not os.environ.get("HVD_TPU_LOG_DIR")):
            # Clean run: reclaim the tmp log dir (an explicit
            # HVD_TPU_LOG_DIR is the user's to keep).
            import shutil
            shutil.rmtree(log_dir, ignore_errors=True)
        return exit_code
    finally:
        signal.signal(signal.SIGINT, old_int)
        signal.signal(signal.SIGTERM, old_term)
        if server is not None:
            server.stop()


def main(argv=None):
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.check_build:
        check_build()
        return 0
    if args.disable_cache:
        os.environ["HVD_TPU_DISABLE_CACHE"] = "1"
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        parser.error("no command given")
    if args.lint:
        raise NotImplementedError(
            "--lint, the hvd-lint preflight, is not ported yet: it comes "
            "with hvd-lint and the model checker (ROADMAP A8g)")
    if args.metrics_port:
        raise NotImplementedError(
            "--metrics-port, the workers' Prometheus endpoint, is not "
            "ported yet (ROADMAP A8d)")
    if args.ckpt_dir:
        # Both launch paths (static run_command and the elastic driver)
        # inherit this process's env into every worker; workers
        # auto-enable durable commits from it (elastic/durable.py).
        os.environ["HVD_TPU_CKPT_DIR"] = os.path.abspath(args.ckpt_dir)
    if args.restart_from_ckpt and not (
            args.ckpt_dir or os.environ.get("HVD_TPU_CKPT_DIR")):
        # The env var is the documented equivalent of --ckpt-dir
        # everywhere else (worker auto-enable, driver, summaries).
        parser.error("--restart-from-ckpt requires --ckpt-dir (or "
                     "HVD_TPU_CKPT_DIR in the environment)")
    if args.hostfile:
        hosts = util.parse_hostfile(args.hostfile)
        if args.num_proc is None:
            args.num_proc = sum(h.slots for h in hosts)
    else:
        hosts = args.hosts or "localhost:%d" % (args.num_proc or 1)
    if args.min_np or args.max_np or args.host_discovery_script:
        # Elastic mode: a supervisor loop (shrink on failure, grow on
        # recovery, host blacklisting) replaces the static
        # kill-all-on-first-exit behavior. See docs/ELASTIC.md.
        from ..elastic.discovery import FixedHosts, HostDiscoveryScript
        from ..elastic.driver import run_elastic
        if args.start_port:
            parser.error("--start-port (static port table) is "
                         "incompatible with elastic mode")
        if args.host_discovery_script:
            discovery = HostDiscoveryScript(args.host_discovery_script)
        else:
            if isinstance(hosts, str):
                discovery = FixedHosts(hosts)
            else:
                discovery = FixedHosts({h.hostname: h.slots
                                        for h in hosts})
        capacity = sum(
            discovery.find_available_hosts_and_slots().values())
        np_ = args.num_proc or capacity
        if not np_:
            parser.error("elastic launch found no hosts (discovery "
                         "script returned nothing and no -np given)")
        return run_elastic(np_, discovery, command,
                           min_np=args.min_np or 1,
                           max_np=args.max_np or np_,
                           ssh_port=args.ssh_port,
                           start_timeout=args.start_timeout,
                           verbose=args.verbose,
                           ckpt_dir=os.environ.get("HVD_TPU_CKPT_DIR"),
                           restart_from_ckpt=args.restart_from_ckpt,
                           drain_grace=args.drain_grace)
    if args.restart_from_ckpt:
        parser.error("--restart-from-ckpt needs elastic mode (give "
                     "--min-np / --max-np / --host-discovery-script); "
                     "the static launcher has no supervisor to relaunch "
                     "the job")
    if args.num_proc is None:
        parser.error("-np is required")
    if args.drain_grace and args.start_port:
        parser.error("--drain-grace needs the dynamic rendezvous KV to "
                     "publish the drain request; it is incompatible "
                     "with --start-port's static port table")
    return run_command(args.num_proc, hosts, command,
                       start_port=args.start_port, ssh_port=args.ssh_port,
                       start_timeout=args.start_timeout, verbose=args.verbose,
                       drain_grace=args.drain_grace)


if __name__ == "__main__":
    sys.exit(main())
