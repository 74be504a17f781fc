"""Launcher utilities: host parsing, slot allocation, the topology env.

Copy of ``horovod_tpu/run/util.py`` for the port (which imports nothing of
``horovod_tpu``): ``parse_hosts``, ``parse_hostfile`` and
``allocate_slots`` (the reference launcher's host parsing and slot
allocation, ``horovod/run/gloo_run.py:51-109``), ``topology_env`` (the
``HVD_TPU_*`` topology of one rank from every rank's ``host:port``) and
``cpu_worker_env`` (the env of CPU-only worker processes).
"""

import collections
import socket

HostInfo = collections.namedtuple("HostInfo", ["hostname", "slots"])

SlotInfo = collections.namedtuple(
    "SlotInfo",
    ["hostname", "rank", "local_rank", "cross_rank", "size", "local_size",
     "cross_size"])


def parse_hosts(hosts_string):
    """Parses "host1:2,host2:2" into HostInfo list ("host" implies 1 slot)."""
    hosts = []
    for part in hosts_string.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, slots = part.rsplit(":", 1)
            hosts.append(HostInfo(name, int(slots)))
        else:
            hosts.append(HostInfo(part, 1))
    return hosts


def parse_hostfile(path):
    """Hostfile lines: "hostname slots=N" (or just "hostname")."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            fields = line.split()
            slots = 1
            for field in fields[1:]:
                if field.startswith("slots="):
                    slots = int(field[len("slots="):])
            hosts.append(HostInfo(fields[0], slots))
    return hosts


def allocate_slots(hosts, np):
    """Assigns np ranks to host slots in order; computes local/cross ranks.

    Mirrors the reference allocation semantics (gloo_run.py:51-109): ranks
    fill hosts in order, local_rank counts within a host, cross_rank indexes
    the host among hosts that have a slot at that local_rank.
    """
    total_slots = sum(h.slots for h in hosts)
    if np > total_slots:
        raise ValueError(
            "requested %d processes but only %d slots available" %
            (np, total_slots))
    slots = []
    rank = 0
    host_idx_assigned = []  # (host_index, local_rank) per rank
    local_sizes = collections.defaultdict(int)
    for hi, host in enumerate(hosts):
        for local_rank in range(host.slots):
            if rank >= np:
                break
            host_idx_assigned.append((hi, local_rank, host.hostname))
            local_sizes[hi] += 1
            rank += 1
    # cross structures: for a given local_rank, ranks across hosts.
    cross_groups = collections.defaultdict(list)  # local_rank -> [host_index]
    for hi, local_rank, _ in host_idx_assigned:
        if hi not in cross_groups[local_rank]:
            cross_groups[local_rank].append(hi)
    for rank, (hi, local_rank, hostname) in enumerate(host_idx_assigned):
        cross_ranks = cross_groups[local_rank]
        slots.append(SlotInfo(
            hostname=hostname,
            rank=rank,
            local_rank=local_rank,
            cross_rank=cross_ranks.index(hi),
            size=np,
            local_size=local_sizes[hi],
            cross_size=len(cross_ranks),
        ))
    return slots


def topology_env(rank, host_ports):
    """Computes the HVD_TPU_* env for `rank` given every rank's "host:port"
    (index == rank). Topology semantics shared by the launcher, the Spark
    barrier tasks and rank-subset init: local = same host, cross = same
    local_rank across hosts."""
    size = len(host_ports)
    hosts = [hp.rsplit(":", 1)[0] for hp in host_ports]
    by_host = collections.defaultdict(list)
    for r, h in enumerate(hosts):
        by_host[h].append(r)
    my_host = hosts[rank]
    local_ranks = by_host[my_host]
    local_rank = local_ranks.index(rank)
    # cross: hosts that have a rank at this local_rank, ordered by first
    # appearance.
    host_order = list(dict.fromkeys(hosts))
    cross_hosts = [h for h in host_order if len(by_host[h]) > local_rank]
    return {
        "HVD_TPU_RANK": str(rank),
        "HVD_TPU_SIZE": str(size),
        "HVD_TPU_LOCAL_RANK": str(local_rank),
        "HVD_TPU_LOCAL_SIZE": str(len(local_ranks)),
        "HVD_TPU_CROSS_RANK": str(cross_hosts.index(my_host)),
        "HVD_TPU_CROSS_SIZE": str(len(cross_hosts)),
        "HVD_TPU_ADDRS": ",".join(host_ports),
    }


def is_local_host(hostname):
    return hostname in ("localhost", "127.0.0.1", socket.gethostname())


def cpu_worker_env(base_env=None, extra_env=None, repo_root=None):
    """Env for spawning the port's CPU-only worker processes (the tests'
    gloo ranks, which pass ``device="cpu"``):

    * ``repo_root`` first on ``PYTHONPATH``, so the workers import this
      checkout's ``horovod_tpu_torch``;
    * ``CUDA_VISIBLE_DEVICES`` empty: these are CPU workers by
      definition, and a card must not be initialised by a worker that
      never uses it;
    * ``PYTHONUNBUFFERED`` popped: with it set every text write is its
      own raw write, so ``print(line)`` becomes two pipe writes (payload,
      then newline) and N workers sharing the launcher's stdout pipe
      interleave mid-line, corrupting line-oriented test protocols.
      Buffered stdout flushes a whole line at once; workers that need
      promptness use ``print(..., flush=True)``.
    """
    import os as _os
    env = dict(base_env if base_env is not None else _os.environ)
    if repo_root:
        env["PYTHONPATH"] = repo_root + _os.pathsep + \
            env.get("PYTHONPATH", "")
    env.pop("PYTHONUNBUFFERED", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    if extra_env:
        env.update(extra_env)
    return env
