"""horovod_tpu_torch — the PyTorch and CUDA port of horovod_tpu.

Horovod's synchronous data-parallel training on NVIDIA GPUs: ``init()``
starts an NCCL process group (optionally laid out as a (batch, model)
mesh), the collectives run over it or over groups of it,
``DistributedOptimizer`` averages the gradients over it, overlapped with
the backward pass, before every update (or, with ``sharded_update=True``,
runs the ZeRO-1 sharded update), wire compression re-encodes each hop of
an explicit ring in bf16 or block-int8, and the models' hot kernels and the
wire codec are written by hand for Hopper (``ops/csrc``). ``parallel``
holds the other strategies over a mesh of process groups: sequence
(ring, Ulysses), tensor, pipeline and expert parallelism. ``sparse`` is the
embedding-row gradient plane (``allreduce_sparse``), ``checkpoint`` the
root-saves, every-rank-restores checkpoint, ``ops.agc`` adaptive gradient
clipping (``DistributedOptimizer(agc=)``), and ``models`` the model zoo. It
imports ``torch`` and numpy, never JAX or the ``horovod_tpu`` package.

The asynchronous collectives (``allreduce_async``, ``reduce_scatter_async``,
``allgather_async``, ``broadcast_async``, ``poll``, ``synchronize``) run on
the port's own build of the negotiation core (``common/core.py``,
``native/``): named collectives that the ranks may enqueue in any order,
fused and negotiated by the core's coordinator, over ``group=`` (a
``new_group`` group, registered in the core's table too). They take CPU
tensors and numpy arrays, moved by the core's TCP data plane, and CUDA
tensors on this rank's GPU, which the core's device op hands to the
executor of ``common/device_plane.py``: NCCL on the card, no copy through
the host. ``DistributedOptimizer(negotiated=True)`` and
``allreduce_gradients(negotiated=True)`` send the gradients through them;
the default stays ``torch.distributed``. ``nccl_built()``, ``gloo_built()``
and the reference's other build queries answer for the port.

``run`` is the launcher (``python -m horovod_tpu_torch.run -np N cmd``),
``elastic`` the elastic state, the ``@elastic.run`` decorator, its driver
and durable checkpoints, and ``spark`` the Spark barrier-task runner.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
without a GPU they raise ``CudaUnavailableError``.

The names below load on first use (PEP 562), so that the launcher, the
elastic driver and the process-tree middleman, which import
``horovod_tpu_torch.run``, start without importing torch.
"""

import importlib

# name -> the module that defines it
_EXPORTS = {
    "horovod_tpu_torch.common.basics": (
        "CudaUnavailableError", "batch_group", "cpu_ops_built",
        "cross_rank", "cross_size", "ddl_built", "device", "gloo_built",
        "gloo_enabled", "init", "init_distributed", "is_homogeneous",
        "is_initialized", "local_rank", "local_size", "mesh_groups",
        "mlsl_built", "model_group", "model_parallel_size", "mpi_built",
        "mpi_enabled", "mpi_threads_supported", "nccl_built",
        "process_group", "rank", "register_init_callback", "shutdown",
        "size", "tcp_built"),
    "horovod_tpu_torch.common.async_ops": (
        "DeviceTensorError", "allgather_async", "allreduce_async",
        "broadcast_async", "poll", "reduce_scatter_async", "synchronize"),
    "horovod_tpu_torch.common.ops": (
        "HorovodInternalError", "allgather", "allreduce", "broadcast",
        "reduce_scatter", "shard_partition", "sync_batch_norm_stats"),
    "horovod_tpu_torch.compression": ("Compression",),
    "horovod_tpu_torch.divergence": (
        "DivergenceError", "assert_synchronized", "collective_digest",
        "metric_average"),
    "horovod_tpu_torch.groups": (
        "WORLD", "ProcessGroup", "group_rank", "group_size", "new_group"),
    "horovod_tpu_torch.optimizer": (
        "DistributedOptimizer", "NegotiatedElasticError",
        "ReplicatedDistributedOptimizer",
        "ShardedDistributedOptimizer", "allreduce_gradients",
        "broadcast_optimizer_state", "broadcast_parameters",
        "sharded_state_full", "sharded_state_shard"),
    "horovod_tpu_torch.parallel": (
        "make_fsdp_train_step", "ring_allgather", "ring_allreduce",
        "ring_reduce_scatter"),
    "horovod_tpu_torch.sparse": (
        "allreduce_sparse", "apply_sparse", "apply_sparse_", "densify"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
_SUBMODULES = ("checkpoint", "elastic", "spark", "run")

__all__ = sorted(_WHERE) + list(_SUBMODULES)
__version__ = "0.1.0"


def __getattr__(name):
    if name in _WHERE:
        value = getattr(importlib.import_module(_WHERE[name]), name)
    elif name in _SUBMODULES:
        value = importlib.import_module(__name__ + "." + name)
    else:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name))
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
