"""Collectives over a mesh axis inside the model, with their transposes.

The JAX package runs its parallel strategies inside ``shard_map``, where a
model calls ``lax.psum``, ``lax.all_to_all`` and ``lax.ppermute`` on an
axis name and autodiff transposes each one: psum to psum (under
``check_vma=False``, so a raw per-shard gradient carries the factors that
``tp_grad_sync`` and the pipeline's contract undo), a tiled all-to-all to
the inverse all-to-all, a permute to the reverse permute. Here each is an
``autograd.Function`` over the process group ``axis_group(axis)`` of the
last ``hybrid_mesh``, whose backward is that transpose, so the port's raw
gradients are the reference's.

Every rank of the axis must make the same calls in the same order, in the
forward and in the backward: a caller masks with ``torch.where`` where the
reference masks with ``jnp.where``, so every output stays in the graph on
every rank. The sum and the all-to-all run at one rank too (NCCL copies
the tensor); the permute of one rank is the identity, a copy.
"""

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.ops import raise_peer_loss
from horovod_tpu_torch.parallel.mesh import axis_group


def axis_size(axis):
    """The number of ranks along ``axis`` (``lax.psum(1, axis)``)."""
    return dist.get_world_size(axis_group(axis))


def axis_index(axis):
    """This rank's index along ``axis`` (``lax.axis_index``)."""
    return dist.get_rank(axis_group(axis))


@raise_peer_loss
def _sum(x, group):
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def psum(x, axis):
    """Sum of ``x`` over the ranks of ``axis``; its backward sums the
    cotangents over the same ranks (``lax.psum``'s transpose)."""
    return _Psum.apply(x, axis_group(axis))


@raise_peer_loss
def _all_to_all(x, group, split_dim, concat_dim):
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError("all_to_all: dim %d of %s does not split into %d "
                         "chunks" % (split_dim, tuple(x.shape), n))
    send = torch.stack(torch.chunk(x, n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


def all_to_all(x, axis, split_dim, concat_dim):
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``: ``x``
    split along ``split_dim`` into one contiguous chunk per rank of
    ``axis``, chunk j sent to rank j, and the chunks received concatenated
    along ``concat_dim`` in source-rank order. The backward is the inverse
    exchange (split on ``concat_dim``, concatenate on ``split_dim``)."""
    return _AllToAll.apply(x, axis_group(axis), split_dim, concat_dim)


@raise_peer_loss
def _shift(x, group, step):
    """``x`` sent to rank (r + step) % n of ``group``; returns what rank
    (r - step) % n sent."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:  # the permute of one rank is the identity (no p2p to self)
        return x.clone()
    x = x.contiguous()
    recv = torch.empty_like(x)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                    dist.P2POp(dist.irecv, recv, src, group)])
    for w in works:
        w.wait()
    return recv


class _ShiftNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def shift_next(x, axis):
    """``lax.ppermute(x, axis, [(i, (i + 1) % n)])``: ``x`` to the next rank
    of ``axis``, what the previous rank sent in return; the backward sends
    the cotangent back to the previous rank."""
    return _ShiftNext.apply(x, axis_group(axis))
