"""Parallel training of the port: the data-parallel step, mesh axes as
process groups, and sequence-parallel ring attention."""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    ProcessMesh,
    axis_group,
    data_parallel_group,
    hybrid_mesh,
)
from horovod_tpu_torch.parallel.ring import (  # noqa: F401
    ring_attention,
    zigzag_shard,
    zigzag_unshard,
)
from horovod_tpu_torch.parallel.train import (  # noqa: F401
    classification_loss,
    cross_entropy_loss,
    lm_loss,
    lm_loss_streaming,
    make_train_step,
    shard_lm_loss,
)
