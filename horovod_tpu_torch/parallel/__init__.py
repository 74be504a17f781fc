"""Parallel training of the port: the data-parallel step (replicated,
ZeRO-1 and FSDP), mesh axes as process groups, sequence parallelism (ring
attention, Ulysses), tensor, pipeline and expert parallelism, and the ring
collectives of the wire compression."""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    ProcessMesh,
    axis_group,
    data_parallel_group,
    hybrid_mesh,
)
from horovod_tpu_torch.optimizer import (  # noqa: F401
    sharded_state_full,
    sharded_state_shard,
)
from horovod_tpu_torch.parallel.expert import (  # noqa: F401
    MoeMlp,
    ep_grad_sync,
    ep_param_specs,
    moe_aux_loss,
    moe_ffn,
    switch_dispatch,
)
from horovod_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    stack_block_params,
)
from horovod_tpu_torch.parallel.ring import (  # noqa: F401
    ring_allgather,
    ring_allreduce,
    ring_attention,
    ring_reduce_scatter,
    ulysses_attention,
    zigzag_shard,
    zigzag_unshard,
)
from horovod_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    tp_grad_sync,
    tp_param_specs,
)
from horovod_tpu_torch.parallel.train import (  # noqa: F401
    classification_loss,
    cross_entropy_loss,
    lm_loss,
    lm_loss_streaming,
    make_fsdp_train_step,
    make_train_step,
    shard_lm_loss,
)
