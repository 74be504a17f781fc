"""Process-group state of the port: init, shutdown and the topology.

Counterpart of ``horovod_tpu/__init__.py`` (init, the rank-subset init,
the init callbacks and the topology queries) and
``horovod_tpu/common/basics.py``. Where the JAX package starts its native
core, the port starts a ``torch.distributed`` process group: NCCL for CUDA
tensors, gloo when ``device="cpu"``.

The topology comes from the variables the launcher
(``python -m horovod_tpu_torch.run``, or the JAX package's) sets:

* only ``HVD_TPU_RANK``, ``HVD_TPU_SIZE`` and ``HVD_TPU_RENDEZVOUS_ADDR``
  (the dynamic rendezvous): ``init()`` publishes this worker's addresses
  and a reserved port, reads the resolved peer table
  (``run/rendezvous.py``) and derives ``HVD_TPU_LOCAL_RANK``,
  ``HVD_TPU_LOCAL_SIZE``, ``HVD_TPU_CROSS_RANK``, ``HVD_TPU_CROSS_SIZE``
  and ``HVD_TPU_ADDRS`` from it, as the reference's ``_maybe_rendezvous``;
* ``HVD_TPU_ADDRS`` (that table, or a static one: ``--start-port``,
  Spark) with the rank and size.

Either way the process group's store is a ``TCPStore`` that rank 0 binds
on its own port of the table (releasing the reservation just before;
``TCPStore`` cannot bind beside it; a bind that loses the short race to
another process raises an error that names the port), so no
``MASTER_ADDR`` is read. A size-1 world rendezvouses
through an in-process ``HashStore``. The ``store`` argument (with
``rank`` and ``size``) overrides all this; without a table or a store a
larger world falls back to ``MASTER_ADDR``/``MASTER_PORT`` (``env://``).
The local rank, which picks the GPU, comes from the table (or from the
launcher's ``HVD_TPU_LOCAL_RANK``); without one, from the hostnames the
ranks publish in the store, never from the rank. An elastic worker's
local rank is the slot the driver gave it on its host
(``HVD_TPU_SLOTS``, every rank's slot in its generation): it keeps it,
and with it its GPU, across generations.

``init(ranks=[...])`` is the rank-subset init (the reference's
``_remap_subset_env``): the listed world ranks form a process group with
sub-ranks in the listed order, from the launcher's table, the others a
size-1 group each.
``init(model_parallel=k)`` lays the world out as a (N/k, k) (batch,
model) mesh of process groups, as ``horovod_tpu``'s ``init`` does.
Callbacks registered with ``register_init_callback`` run after every
init, elastic re-inits included.
"""

import datetime
import os
import socket

import torch
import torch.distributed as dist

from horovod_tpu_torch.run.util import slots_from_env, topology_of


class CudaUnavailableError(RuntimeError):
    """An entry point was asked for the GPU (the default) on a machine
    where ``torch.cuda.is_available()`` is false."""


_state = {"device": None, "rank": 0, "size": 1, "local_rank": 0,
          "local_size": 1, "cross_rank": 0, "cross_size": 1,
          "homogeneous": True, "group": None, "mesh": None,
          "store": None, "init_args": None}

_TOPOLOGY_KEYS = ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_LOCAL_RANK",
                  "HVD_TPU_LOCAL_SIZE", "HVD_TPU_CROSS_RANK",
                  "HVD_TPU_CROSS_SIZE", "HVD_TPU_ADDRS")
# the launcher's topology env, saved before a rank-subset remap
_world_env = None
# run after every successful init(), elastic re-inits included
_init_callbacks = []


def register_init_callback(fn):
    """Registers ``fn()`` to run after every successful ``init()``,
    elastic re-inits included."""
    _init_callbacks.append(fn)


def resolve_device(device=None):
    """``None`` -> this rank's CUDA device (raises CudaUnavailableError
    without one); ``"cpu"`` -> the CPU; any other value as
    ``torch.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise CudaUnavailableError(
                "no CUDA device: horovod_tpu_torch runs on the GPU unless "
                "the caller passes device='cpu'")
        idx = _state["local_rank"] if is_initialized() else 0
        return torch.device("cuda", idx)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailableError(
            "%s asked for, but no CUDA device is available: horovod_tpu_torch "
            "runs on the GPU unless the caller passes device='cpu'" % device)
    return device


def _env_int(name, default):
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def _start_timeout():
    return float(os.environ.get("HVD_TPU_START_TIMEOUT", "60") or 60)


def _elastic():
    return os.environ.get("HVD_TPU_ELASTIC") == "1"


def _maybe_rendezvous():
    """The dynamic rendezvous (the reference's ``_maybe_rendezvous``):
    when the launcher supplied ``HVD_TPU_RENDEZVOUS_ADDR`` and no
    ``HVD_TPU_ADDRS``, publish this worker's addresses and a reserved
    port, read the resolved peer table and set the topology env from it.
    An elastic worker first takes its rank and size from the driver's
    published membership."""
    if os.environ.get("HVD_TPU_ADDRS"):
        return
    rdv_addr = os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    if not rdv_addr:
        return
    if _elastic() and "HVD_TPU_RANK" not in os.environ:
        from horovod_tpu_torch.elastic.run import bootstrap_topology
        bootstrap_topology()
    size = _env_int("HVD_TPU_SIZE", 1)
    if size <= 1:
        return
    if "HVD_TPU_RANK" not in os.environ:
        raise RuntimeError(
            "HVD_TPU_RENDEZVOUS_ADDR and HVD_TPU_SIZE are set but "
            "HVD_TPU_RANK is missing; the launcher must inject all three "
            "(check ssh env forwarding)")
    from horovod_tpu_torch.run import rendezvous
    os.environ.update(rendezvous.resolve_topology(
        _env_int("HVD_TPU_RANK", 0), size, rdv_addr, _start_timeout(),
        generation=_env_int("HVD_TPU_GENERATION", 0),
        slots=slots_from_env(size)))


def _restore_world_env():
    global _world_env
    if _world_env is None:
        return
    for k, v in _world_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    _world_env = None


def _remap_subset_env(ranks):
    """Rewrites the ``HVD_TPU_*`` env for the ``ranks`` sub-group (a
    member: its sub-rank, the subset's size and the subset's slice of the
    table) or a size-1 group (a non-member), as the reference's
    ``_remap_subset_env``. The world's env is saved first, so that a later
    plain ``init()`` sees the world again."""
    global _world_env
    from horovod_tpu_torch.run.util import topology_env
    if _world_env is None:
        _world_env = {k: os.environ.get(k) for k in _TOPOLOGY_KEYS}
    else:  # re-init with another subset: start from the world view
        saved = _world_env
        _restore_world_env()
        _world_env = saved
    world_rank = _env_int("HVD_TPU_RANK", 0)
    world_size = _env_int("HVD_TPU_SIZE", 1)
    _check_subset(ranks, world_size)
    if world_rank not in ranks:
        for k in _TOPOLOGY_KEYS:
            os.environ.pop(k, None)
        os.environ["HVD_TPU_RANK"] = "0"
        os.environ["HVD_TPU_SIZE"] = "1"
        return
    addrs = (os.environ.get("HVD_TPU_ADDRS") or "").split(",")
    if len(addrs) != world_size:
        raise RuntimeError(
            "HVD_TPU_ADDRS does not cover the world; cannot form a "
            "rank-subset communicator")
    os.environ.update(topology_env(list(ranks).index(world_rank),
                                   [addrs[r] for r in ranks]))


def _check_subset(ranks, world_size):
    if len(set(ranks)) != len(ranks):
        raise ValueError("duplicate entries in ranks: %r" % (ranks,))
    for r in ranks:
        if not 0 <= r < world_size:
            raise ValueError("rank %d out of range for world size %d" %
                             (r, world_size))


def _table_store(addrs, rank, size, timeout):
    """The process group's ``TCPStore`` at the table's rank-0 address:
    rank 0 releases its reserved port and binds the store there (a
    ``TCPStore`` cannot bind beside the reservation); the others
    connect."""
    from horovod_tpu_torch.run import rendezvous
    host, port = addrs[0].rsplit(":", 1)
    port = int(port)
    td = datetime.timedelta(seconds=timeout)
    if rank != 0:
        return dist.TCPStore(host, port, size, False, timeout=td)
    rendezvous.release_held_ports()
    try:
        return dist.TCPStore(host, port, size, True, timeout=td,
                             wait_for_workers=False)
    except RuntimeError as e:
        raise RuntimeError(
            "rank 0 cannot bind the process group's store on port %d, "
            "its reserved port of the peer table (%s): another process "
            "took it after the reservation was released" % (port, e)) \
            from e


def _hosts_from_store(store, rank, size, timeout):
    """Every rank's hostname, published in ``store``: the host table when
    the launcher gave none."""
    store.set("hvd_torch/host/%d" % rank, socket.gethostname())
    keys = ["hvd_torch/host/%d" % r for r in range(size)]
    store.wait(keys, datetime.timedelta(seconds=timeout))
    return [store.get(k).decode() for k in keys]


def init(device=None, store=None, rank=None, size=None, model_parallel=None,
         ranks=None):
    """Starts the process group. ``rank``/``size`` default to the
    launcher's ``HVD_TPU_RANK``/``HVD_TPU_SIZE`` (0 and 1 without them),
    after the dynamic rendezvous when the launcher asked for one. NCCL on
    the GPU (the default), gloo for ``device="cpu"``. Under the elastic
    driver (``HVD_TPU_ELASTIC=1``) the group's timeout is the elastic
    timeout (``HVD_TPU_ELASTIC_TIMEOUT``, else ``HVD_TPU_START_TIMEOUT``),
    and NCCL runs with blocking waits and async error handling in
    CleanUpOnly mode, so that a lost peer raises in the surviving
    process's wait, which ``@elastic.run`` turns into a rollback and a
    re-init.

    ``ranks=[...]``: the listed world ranks form a process group, with
    sub-ranks in the listed order; every other rank forms a size-1 group
    of its own (the reference's ``init(ranks=)``). The members' group is
    formed from the launcher's table (``HVD_TPU_ADDRS``), its store bound
    by the subset's first rank, so ``ranks`` takes no ``store``, ``rank``
    or ``size`` (``ValueError``). The GPU stays the one of the world's
    local rank.

    ``model_parallel=k`` (or ``HVD_TPU_MODEL_PARALLEL``) lays the N ranks
    out as a (N/k, k) (batch, model) mesh: rank r sits at batch row r // k
    and model column r % k; ``batch_group()`` is its model column (N/k
    members: the gradient reduction runs over it) and ``model_group()``
    its row of k consecutive ranks."""
    if is_initialized():
        return
    explicit = rank is not None or size is not None or store is not None
    if ranks and explicit:
        raise ValueError("init(ranks=) forms the subset from the launcher's "
                         "table; it takes no store, rank or size")
    if not explicit:
        _maybe_rendezvous()
    world_rank = _env_int("HVD_TPU_RANK", 0) if rank is None else rank
    world_size = _env_int("HVD_TPU_SIZE", 1) if size is None else size
    timeout = _start_timeout()

    # the world's local rank: it picks the GPU, also in a rank subset
    addrs = os.environ.get("HVD_TPU_ADDRS")
    table = addrs.split(",") if addrs and not explicit else None
    if table is not None and len(table) != world_size:
        raise RuntimeError("HVD_TPU_ADDRS holds %d addresses for a world "
                           "of %d" % (len(table), world_size))
    if table is not None:
        # an elastic worker's local rank is its slot, kept across
        # generations, so that it keeps its GPU
        topo = topology_of([a.rsplit(":", 1)[0] for a in table],
                           world_rank, slots_from_env(world_size))
    elif not explicit and "HVD_TPU_LOCAL_RANK" in os.environ:
        topo = (_env_int("HVD_TPU_LOCAL_RANK", 0),
                _env_int("HVD_TPU_LOCAL_SIZE", 1),
                _env_int("HVD_TPU_CROSS_RANK", 0),
                _env_int("HVD_TPU_CROSS_SIZE", 1), True)
    else:
        topo = None  # size 1, or env:// (read from the store below)
    device_index = topo[0] if topo is not None else 0

    if ranks:
        ranks = [int(r) for r in ranks]
        _remap_subset_env(ranks)
        rank_ = _env_int("HVD_TPU_RANK", 0)
        size_ = _env_int("HVD_TPU_SIZE", 1)
        if size_ > 1:  # a member: the subset's slice of the table
            table = os.environ["HVD_TPU_ADDRS"].split(",")
            topo = topology_of([a.rsplit(":", 1)[0] for a in table],
                               rank_)
        else:
            table, topo = None, (0, 1, 0, 1, True)
    else:
        if _world_env is not None:  # a plain init() after init(ranks=)
            _restore_world_env()
        rank_, size_ = world_rank, world_size

    dev = resolve_device(torch.device("cuda", device_index) if device is None
                         else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {"backend": backend, "rank": rank_, "world_size": size_}
    if _elastic():
        # A lost peer must surface within the elastic timeout (not NCCL's
        # default of 10 minutes), in the thread that waits on the
        # collective, before the step's result is committed. NCCL's
        # blocking wait raises the collective's error or timeout in its
        # wait(); without it the host would see the failure only at a
        # later collective, after committing a step that ran on an aborted
        # communicator. Async error handling in mode 2 (CleanUpOnly)
        # aborts the communicators and keeps the process alive for the
        # rollback: modes 1 (TearDown) and 3 (torch's default) end it. At
        # size 1 no peer can be lost, and the waits stay asynchronous.
        if backend == "nccl" and size_ > 1:
            os.environ.setdefault("TORCH_NCCL_BLOCKING_WAIT", "1")
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
        kwargs["timeout"] = datetime.timedelta(seconds=float(
            os.environ.get("HVD_TPU_ELASTIC_TIMEOUT", timeout)))
    generation = _env_int("HVD_TPU_GENERATION", 0)
    if store is not None:
        pg_store = store
    elif size_ == 1:
        pg_store = dist.HashStore()
    elif table is not None:
        # a fresh store for every generation (new ports from its own
        # rendezvous), under its generation's prefix besides; where the
        # negotiation core already listens on the table's ports, on a
        # port that rank 0 broadcasts through the core
        from horovod_tpu_torch.common import core
        make = core.process_group_store if core.is_initialized() and \
            not ranks else _table_store
        pg_store = dist.PrefixStore("g%d" % generation, make(
            table, rank_, size_, timeout))
    else:
        pg_store, _, _ = next(dist.rendezvous(
            "env://", rank_, size_,
            timeout=datetime.timedelta(seconds=timeout)))
    if topo is None:
        topo = (topology_of(_hosts_from_store(pg_store, rank_, size_,
                                               timeout), rank_)
                if size_ > 1 else (0, 1, 0, 1, True))
        if device is None:
            dev = resolve_device(torch.device("cuda", topo[0]))
            torch.cuda.set_device(dev)
    kwargs["store"] = pg_store
    dist.init_process_group(**kwargs)
    from horovod_tpu_torch.run import rendezvous
    rendezvous.release_held_ports()
    local_rank, local_size, cross_rank, cross_size, homogeneous = topo
    _state.update(device=dev, group=dist.group.WORLD, mesh=None,
                  store=pg_store,
                  rank=rank_, size=size_, local_rank=local_rank,
                  local_size=local_size, cross_rank=cross_rank,
                  cross_size=cross_size, homogeneous=homogeneous,
                  init_args=dict(device=device,
                                 model_parallel=model_parallel))
    from horovod_tpu_torch import divergence, groups
    groups.reset()
    divergence.reset()
    from horovod_tpu_torch.common import core
    if core.is_initialized():
        # the core runs already: its executor of CUDA tensors joins the
        # new group
        from horovod_tpu_torch.common import device_plane
        device_plane.attach()
    for cb in _init_callbacks:
        cb()
    # The env is persisted only after the mesh formed against the live
    # world size, so an invalid model_parallel= leaves later inits alone.
    k = (int(model_parallel) if model_parallel is not None
         else _env_int("HVD_TPU_MODEL_PARALLEL", 1))
    if k > 1:
        _state["mesh"] = _form_mesh(k, explicit=model_parallel is not None)
    if model_parallel is not None:
        os.environ["HVD_TPU_MODEL_PARALLEL"] = str(k)


def _form_mesh(k, explicit=True):
    """Creates the (batch, model) mesh groups on this rank; every rank
    runs the same sequence, so the ids agree. Model groups are k
    consecutive ranks, batch groups the strided columns {j, j + k, ...};
    all k batch groups are created first (column 0..k-1), then the N/k
    model groups (row 0..N/k-1)."""
    from horovod_tpu_torch.groups import new_group
    n = size()
    if n % k != 0:
        if explicit:
            raise ValueError("model_parallel=%d does not divide world size "
                             "%d" % (k, n))
        raise RuntimeError(
            "elastic membership of size %d cannot resume the "
            "model_parallel=%d mesh (size must be a multiple of k — the "
            "model is sharded k ways); resize to a multiple of %d, or "
            "unset HVD_TPU_MODEL_PARALLEL for a fresh pure-DP job"
            % (n, k, k))
    batch_groups = [new_group(range(j, n, k)) for j in range(k)]
    model_groups = [new_group(range(i * k, (i + 1) * k))
                    for i in range(n // k)]
    r = rank()
    return {"k": k, "batch": batch_groups[r % k],
            "model": model_groups[r // k], "batch_groups": batch_groups,
            "model_groups": model_groups}


def model_parallel_size():
    """The mesh's model-parallel width k (1: pure data-parallel)."""
    mesh = _state["mesh"]
    return mesh["k"] if mesh is not None else 1


def batch_group():
    """This rank's batch-axis (data-parallel) group: the N/k ranks that
    hold the same model shard. ``DistributedOptimizer`` reduces over it
    by default. None without ``init(model_parallel=k)``."""
    mesh = _state["mesh"]
    return mesh["batch"] if mesh is not None else None


def model_group():
    """This rank's model-axis group: the k ranks that form one model
    replica. None without ``init(model_parallel=k)``."""
    mesh = _state["mesh"]
    return mesh["model"] if mesh is not None else None


def mesh_groups():
    """(batch_group, model_group) of this rank, or (None, None)."""
    return batch_group(), model_group()


def init_distributed(local_device_ids=None):
    """The counterpart of ``horovod_tpu.jax.init_distributed``, which
    bootstraps ``jax.distributed`` so that one jit program spans every
    host's chips. ``init()`` already forms one NCCL group over every rank,
    which the device collectives use across hosts, so after ``init()``
    there is nothing left to do. ``local_device_ids`` is taken for the
    same signature and not used."""
    if not is_initialized():
        raise RuntimeError("call hvd.init() before init_distributed()")


def shutdown():
    """Destroys the process group (also one whose peer was lost), and
    with it the negotiation core's executor of CUDA tensors. Where that
    executor runs, the core stops first, as at exit: its shutdown runs
    what every rank negotiated while the executor is there to run it, and
    fails every other handle, so no handle waits on a response that
    nothing would take."""
    from horovod_tpu_torch.common import core, device_plane
    if device_plane.current() is not None:
        core.shutdown()
    device_plane.detach()
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(device=None, group=None, mesh=None, store=None)


def last_init_args():
    """The ``device`` and ``model_parallel`` of the last ``init()``, which
    an elastic re-init passes again; None before any."""
    args = _state["init_args"]
    return dict(args) if args is not None else None


def is_initialized():
    return _state["device"] is not None and dist.is_initialized()


def _require():
    if not is_initialized():
        raise RuntimeError("horovod_tpu_torch is not initialized; call "
                           "hvd.init() first")


def rank():
    _require()
    return _state["rank"]


def size():
    _require()
    return _state["size"]


def local_rank():
    _require()
    return _state["local_rank"]


def local_size():
    _require()
    return _state["local_size"]


def cross_rank():
    """This rank's index among the ranks with its local rank, one a
    host."""
    _require()
    return _state["cross_rank"]


def cross_size():
    """The number of hosts that hold a rank at this local rank."""
    _require()
    return _state["cross_size"]


def is_homogeneous():
    """True when every host holds the same number of ranks."""
    _require()
    return _state["homogeneous"]


def device():
    """The device this rank's collectives and model live on."""
    _require()
    return _state["device"]


def process_group_store():
    """The store the process group was formed on."""
    _require()
    return _state["store"]


def process_group():
    """The world process group."""
    _require()
    return _state["group"]


# The reference's build queries (horovod_tpu/__init__.py:350-394), as the
# port answers them: the TCP and CPU data plane and the gloo role come
# from the port's build of the negotiation core (built at first use),
# NCCL is the core's device op with torch.distributed's NCCL, and the
# MPI, DDL and MLSL backends do not exist.

def _core_query(fn):
    from horovod_tpu_torch.common import core
    return bool(getattr(core.get_core().lib, fn)())


def tcp_built():
    return _core_query("horovod_tpu_tcp_built")


def cpu_ops_built():
    return _core_query("horovod_tpu_cpu_ops_built")


def gloo_built():
    """True: the core's TCP data plane fills the gloo role."""
    return tcp_built()


def gloo_enabled():
    return tcp_built()


def nccl_built():
    """True when the core's device op is built and torch.distributed has
    NCCL: CUDA tensors of the asynchronous API then run on NCCL."""
    return _core_query("horovod_tpu_device_op_built") and \
        dist.is_nccl_available()


def mpi_threads_supported():
    return False


def mpi_enabled():
    return False


def mpi_built():
    return False


def ddl_built():
    return False


def mlsl_built():
    return False
