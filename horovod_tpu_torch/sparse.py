"""Sparse (embedding-row) gradient collectives.

Counterpart of ``horovod_tpu/jax/sparse.py``. The reference Horovod
allreduces a ``tf.IndexedSlices`` by allgathering its values and indices
instead of densifying it: the traffic is the rows touched, not the
vocabulary. As in the JAX package, the sparse gradient is an explicit
(indices, values) pair, which a model gets by differentiating with
respect to the rows it gathered (``models/word2vec.py``).
``allreduce_sparse`` rides on ``allgather``, which takes a different row
count on each rank.
"""

import torch

from horovod_tpu_torch.common.ops import allgather
from horovod_tpu_torch.groups import group_size


def allreduce_sparse(indices, values, name=None, average=True, group=None):
    """Every rank's (indices, values) of the group, gathered in rank order:
    returns (all_indices, all_values), the values divided by the group's
    size when averaging. Rows repeated across ranks stay repeated: apply
    them with a scatter-add (``apply_sparse``), which sums them, as
    IndexedSlices are applied."""
    name = name or "sparse"
    all_indices = allgather(indices, name=name + ".i", group=group)
    all_values = allgather(values, name=name + ".v", group=group)
    if average:
        all_values = all_values / group_size(group)
    return all_indices, all_values


def apply_sparse(param, indices, values, scale=1.0):
    """``param`` with ``scale * values`` added to its rows at ``indices``
    (repeated indices accumulate), as a new tensor."""
    return param.index_add(0, indices, values, alpha=scale)


def apply_sparse_(param, indices, values, scale=1.0):
    """``apply_sparse`` in place: ``param``'s rows at ``indices`` gain
    ``scale * values``; returns ``param``. On the GPU ``index_add_``
    accumulates repeated rows with atomics, in no fixed order."""
    with torch.no_grad():
        return param.index_add_(0, indices, values, alpha=scale)


def densify(indices, values, num_rows):
    """(indices, values) -> the dense [num_rows, ...] accumulation (the
    reference's ``sparse_as_dense``)."""
    out = values.new_zeros((num_rows,) + tuple(values.shape[1:]))
    return out.index_add_(0, indices, values)
