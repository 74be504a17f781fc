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

Entry points run on the GPU unless the caller passes ``device="cpu"``;
without a GPU they raise ``CudaUnavailableError``.
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    CudaUnavailableError,
    batch_group,
    device,
    init,
    init_distributed,
    is_initialized,
    local_rank,
    local_size,
    mesh_groups,
    model_group,
    model_parallel_size,
    process_group,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.common.ops import (  # noqa: F401
    allgather,
    allreduce,
    broadcast,
    reduce_scatter,
    shard_partition,
    sync_batch_norm_stats,
)
from horovod_tpu_torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.divergence import (  # noqa: F401
    DivergenceError,
    assert_synchronized,
    collective_digest,
    metric_average,
)
from horovod_tpu_torch.groups import (  # noqa: F401
    WORLD,
    ProcessGroup,
    group_rank,
    group_size,
    new_group,
)
from horovod_tpu_torch.optimizer import (  # noqa: F401
    DistributedOptimizer,
    ReplicatedDistributedOptimizer,
    ShardedDistributedOptimizer,
    allreduce_gradients,
    broadcast_optimizer_state,
    broadcast_parameters,
    sharded_state_full,
    sharded_state_shard,
)
from horovod_tpu_torch.parallel import (  # noqa: F401
    make_fsdp_train_step,
    ring_allgather,
    ring_allreduce,
    ring_reduce_scatter,
)
from horovod_tpu_torch.sparse import (  # noqa: F401
    allreduce_sparse,
    apply_sparse,
    apply_sparse_,
    densify,
)
from horovod_tpu_torch import checkpoint  # noqa: F401

__version__ = "0.1.0"
