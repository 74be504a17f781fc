"""The data-parallel world as a process group.

Counterpart of ``horovod_tpu/parallel/mesh.py::data_parallel_mesh``: on
the TPU a 1-D device mesh over every chip; here the process group that
``hvd.init()`` started, one rank per GPU.
"""

import collections

import torch.distributed as dist

from horovod_tpu_torch.common import basics

DataParallelGroup = collections.namedtuple("DataParallelGroup",
                                           ["group", "size"])


def data_parallel_group():
    """(process group, its size) of the data-parallel world."""
    group = basics.process_group()
    return DataParallelGroup(group, dist.get_world_size(group))
