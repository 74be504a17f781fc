"""Process-group state of the port: init, shutdown and the topology.

Counterpart of ``horovod_tpu/__init__.py`` (init and the topology
queries) and ``horovod_tpu/common/basics.py``. Where the JAX package
starts its native core, the port starts a ``torch.distributed`` process
group: NCCL for CUDA tensors, gloo when ``device="cpu"``.

The topology comes from the same variables the launcher sets for the
JAX package (``HVD_TPU_RANK``, ``HVD_TPU_SIZE``, ``HVD_TPU_LOCAL_RANK``,
``HVD_TPU_LOCAL_SIZE``). With none of them set, the world is one rank,
rendezvoused through an in-process ``HashStore``, so no network is
needed. A larger world rendezvouses through the ``store`` argument or,
without one, through ``MASTER_ADDR``/``MASTER_PORT`` (``env://``).

``init(model_parallel=k)`` lays the world out as a (N/k, k) (batch,
model) mesh of process groups, as ``horovod_tpu``'s ``init`` does.
"""

import os

import torch
import torch.distributed as dist


class CudaUnavailableError(RuntimeError):
    """An entry point was asked for the GPU (the default) on a machine
    where ``torch.cuda.is_available()`` is false."""


_state = {"device": None, "rank": 0, "size": 1, "local_rank": 0,
          "local_size": 1, "group": None, "mesh": None}


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


def init(device=None, store=None, rank=None, size=None, model_parallel=None,
         ranks=None):
    """Starts the process group. ``rank``/``size`` default to the
    launcher's ``HVD_TPU_RANK``/``HVD_TPU_SIZE`` (0 and 1 without them).
    NCCL on the GPU (the default), gloo for ``device="cpu"``.

    ``model_parallel=k`` (or ``HVD_TPU_MODEL_PARALLEL``) lays the N ranks
    out as a (N/k, k) (batch, model) mesh: rank r sits at batch row r // k
    and model column r % k; ``batch_group()`` is its model column (N/k
    members: the gradient reduction runs over it) and ``model_group()``
    its row of k consecutive ranks. ``ranks=`` (the rank-subset form of
    the reference) is not ported."""
    if ranks:
        raise NotImplementedError(
            "init(ranks=), the rank-subset communicator, comes with the "
            "rendezvous of ROADMAP A8")
    if is_initialized():
        return
    rank = _env_int("HVD_TPU_RANK", 0) if rank is None else rank
    size = _env_int("HVD_TPU_SIZE", 1) if size is None else size
    local_rank = _env_int("HVD_TPU_LOCAL_RANK", rank)
    local_size = _env_int("HVD_TPU_LOCAL_SIZE", size)
    _state.update(rank=rank, size=size, local_rank=local_rank,
                  local_size=local_size)
    dev = resolve_device(torch.device("cuda", local_rank) if device is None
                         else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {"backend": backend, "rank": rank, "world_size": size}
    if store is not None:
        kwargs["store"] = store
    elif size == 1:
        kwargs["store"] = dist.HashStore()
    else:
        kwargs["init_method"] = "env://"
    dist.init_process_group(**kwargs)
    _state.update(device=dev, group=dist.group.WORLD, mesh=None)
    from horovod_tpu_torch import divergence, groups
    groups.reset()
    divergence.reset()
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
    if is_initialized():
        dist.destroy_process_group()
    _state.update(device=None, group=None, mesh=None)


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


def device():
    """The device this rank's collectives and model live on."""
    _require()
    return _state["device"]


def process_group():
    """The world process group."""
    _require()
    return _state["group"]
