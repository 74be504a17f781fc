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
"""

import os

import torch
import torch.distributed as dist


class CudaUnavailableError(RuntimeError):
    """An entry point was asked for the GPU (the default) on a machine
    where ``torch.cuda.is_available()`` is false."""


_state = {"device": None, "rank": 0, "size": 1, "local_rank": 0,
          "local_size": 1, "group": None}


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


def init(device=None, store=None, rank=None, size=None):
    """Starts the process group. ``rank``/``size`` default to the
    launcher's ``HVD_TPU_RANK``/``HVD_TPU_SIZE`` (0 and 1 without them).
    NCCL on the GPU (the default), gloo for ``device="cpu"``."""
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
    _state.update(device=dev, group=dist.group.WORLD)


def shutdown():
    if is_initialized():
        dist.destroy_process_group()
    _state.update(device=None, group=None)


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
