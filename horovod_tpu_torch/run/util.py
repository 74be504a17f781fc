"""Launcher utilities: host parsing, slot allocation, the topology env.

Copy of ``horovod_tpu/run/util.py`` for the port (which imports nothing of
``horovod_tpu``): ``parse_hosts``, ``parse_hostfile`` and
``allocate_slots`` (the reference launcher's host parsing and slot
allocation, ``horovod/run/gloo_run.py:51-109``), ``topology_env`` (the
``HVD_TPU_*`` topology of one rank from every rank's ``host:port``,
``topology_of`` under it, with the elastic driver's stable slots) and
``cpu_worker_env`` (the env of CPU-only worker processes).
"""

import collections
import os
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


def topology_of(hosts, rank, slots=None):
    """(local_rank, local_size, cross_rank, cross_size, homogeneous) of
    ``rank`` from every rank's host (index == rank). Local = same host.
    The local rank is the rank's place among its host's ranks, or, given
    ``slots`` (every rank's local slot, index == rank: the elastic
    driver's, which a worker keeps across generations), its slot. Cross =
    the hosts with a rank at this local rank, in order of first
    appearance; homogeneous when every host holds the same number of
    ranks."""
    by_host = collections.defaultdict(list)
    for r, h in enumerate(hosts):
        by_host[h].append(r)
    if slots is None:
        slots = [by_host[h].index(r) for r, h in enumerate(hosts)]
    local_rank = slots[rank]
    cross = [h for h in dict.fromkeys(hosts)
             if any(slots[r] == local_rank for r in by_host[h])]
    return (local_rank, len(by_host[hosts[rank]]),
            cross.index(hosts[rank]), len(cross),
            len({len(v) for v in by_host.values()}) == 1)


def slots_from_env(size=None):
    """Every rank's local slot (index == rank) from ``HVD_TPU_SLOTS``,
    which an elastic worker sets from its generation's membership; None
    without it (or when it does not cover ``size`` ranks)."""
    raw = os.environ.get("HVD_TPU_SLOTS")
    if not raw:
        return None
    slots = [int(v) for v in raw.split(",")]
    return slots if size is None or len(slots) == size else None


def topology_env(rank, host_ports, slots=None):
    """Computes the HVD_TPU_* env for `rank` given every rank's "host:port"
    (index == rank). Topology semantics shared by the launcher, the Spark
    barrier tasks and rank-subset init: local = same host, cross = same
    local_rank across hosts (``topology_of``; ``slots`` as there)."""
    hosts = [hp.rsplit(":", 1)[0] for hp in host_ports]
    local_rank, local_size, cross_rank, cross_size, _ = topology_of(
        hosts, rank, slots)
    return {
        "HVD_TPU_RANK": str(rank),
        "HVD_TPU_SIZE": str(len(host_ports)),
        "HVD_TPU_LOCAL_RANK": str(local_rank),
        "HVD_TPU_LOCAL_SIZE": str(local_size),
        "HVD_TPU_CROSS_RANK": str(cross_rank),
        "HVD_TPU_CROSS_SIZE": str(cross_size),
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
    env = dict(base_env if base_env is not None else os.environ)
    if repo_root:
        env["PYTHONPATH"] = repo_root + os.pathsep + \
            env.get("PYTHONPATH", "")
    env.pop("PYTHONUNBUFFERED", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    if extra_env:
        env.update(extra_env)
    return env
