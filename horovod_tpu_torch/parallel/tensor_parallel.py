"""Tensor parallelism for the transformer (Megatron-style sharding).

Counterpart of ``horovod_tpu/parallel/tensor_parallel.py``. Parameters are
made full-size once, sliced to each rank's shard along the dims
``tp_param_specs`` names (``convert.shard_state_dict``), and applied by a
model built from ``cfg.local(tp_size)`` with ``tp_axis`` set: its
attention-out and mlp-out projections sum their partial products over the
axis (``_axis.psum``, whose backward sums too, as ``lax.psum``'s transpose
does under ``shard_map(check_vma=False)``).

So with the loss computed on every tp rank, the raw gradients carry the
reference's factors: a sharded weight's gradient is tp_size times its slice
of the true one, a replicated weight before the first psum tp_size times a
rank-dependent part, one after the last psum exact. ``tp_grad_sync``
undoes them as the reference does: sharded leaves g / n, replicated leaves
the mean over the axis.

Layouts: PyTorch's ``Linear.weight`` is [out, in], so the sharded dims are
those of flax's kernels transposed: query, key and value [H*D, E] on dim 0
(whole heads, contiguous), out [E, H*D] on dim 1, mlp_in [M, E] on dim 0,
mlp_out [E, M] on dim 1.
"""

import torch

from horovod_tpu_torch.common.ops import allreduce
from horovod_tpu_torch.parallel import _axis
from horovod_tpu_torch.parallel.expert import _names

# parameter (module) name -> the dim of its weight sharded over tp
_TP_DIMS = {"query": 0, "key": 0, "value": 0, "out": 1,
            "mlp_in": 0, "mlp_out": 1}


def _tp_dim(name):
    for part in name.split("."):
        if part in _TP_DIMS:
            return _TP_DIMS[part]
    return None


def tp_param_specs(params):
    """{name: sharded dim or None} for a full-size transformer's parameters
    (a module, or a dict keyed by parameter name): the head or hidden dim
    of the projections above, None (replicated) for everything else."""
    return {name: _tp_dim(name) for name in _names(params)}


def is_tp_sharded(name):
    """True when the parameter ``name`` is sharded by ``tp_param_specs``."""
    return _tp_dim(name) is not None


# ---------------------------------------------------------------------------
# Host-plane Megatron f and g over a process group (the model axis of
# hvd.init(model_parallel=k)): with a column-parallel layer then a
# row-parallel one,
#   x = f(input)                  f: identity forward, allreduce backward
#   y = g(x_colparallel @ W2)     g: allreduce forward, identity backward


class _CopyToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, name):
        ctx.group, ctx.name = group, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return allreduce(g, average=False, group=ctx.group,
                         name=ctx.name and ctx.name + ".bwd"), None, None


class _ReduceFromModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, name):
        return allreduce(x, average=False, group=group, name=name)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_model_parallel(x, group, name=None):
    """Megatron's f: identity forward, allreduce (sum) over ``group`` in
    the backward. Put it at the input of a column-parallel layer: each
    shard's input gradient is partial, and the sum completes it."""
    return _CopyToModelParallel.apply(x, group, name)


def reduce_from_model_parallel(x, group, name=None):
    """Megatron's g: allreduce (sum) over ``group`` forward, identity
    backward. Put it at the output of a row-parallel layer: the sum
    completes the activation, and d partial = d out."""
    return _ReduceFromModelParallel.apply(x, group, name)


def tp_grad_sync(grads, tp_axis="tp", dp_axis=None):
    """Synchronizes raw per-shard gradients ({name: tensor}) under tensor
    parallelism; returns new ones: sharded weights g / tp_size, replicated
    ones their mean over ``tp_axis`` (see the module docstring), and with
    ``dp_axis`` every gradient's mean over data parallelism too."""
    n = _axis.axis_size(tp_axis)
    out = {}
    for name, g in grads.items():
        if is_tp_sharded(name):
            g = g / n
        else:
            g = _axis.psum(g, tp_axis) / n
        if dp_axis is not None:
            g = _axis.psum(g, dp_axis) / _axis.axis_size(dp_axis)
        out[name] = g
    return out
