"""horovod_tpu_torch — the PyTorch and CUDA port of horovod_tpu.

Horovod's synchronous data-parallel training on NVIDIA GPUs: ``init()``
starts an NCCL process group, ``DistributedOptimizer`` averages the
gradients over it before every update, and the models' hot kernels are
written by hand for Hopper (``ops/csrc``). It imports ``torch`` and
numpy, never JAX or the ``horovod_tpu`` package.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
without a GPU they raise ``CudaUnavailableError``.
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    CudaUnavailableError,
    device,
    init,
    is_initialized,
    local_rank,
    local_size,
    process_group,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.common.ops import (  # noqa: F401
    allgather,
    allreduce,
    broadcast,
)
from horovod_tpu_torch.optimizer import (  # noqa: F401
    DistributedOptimizer,
    allreduce_gradients,
    broadcast_optimizer_state,
    broadcast_parameters,
)

__version__ = "0.1.0"
