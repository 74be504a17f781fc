"""Parallel training of the port: the data-parallel step and its group."""

from horovod_tpu_torch.parallel.mesh import data_parallel_group  # noqa: F401
from horovod_tpu_torch.parallel.train import (  # noqa: F401
    classification_loss,
    cross_entropy_loss,
    lm_loss,
    make_train_step,
)
