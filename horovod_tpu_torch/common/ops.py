"""Collectives over a process group.

Counterpart of the collectives of ``horovod_tpu/jax/__init__.py``
(``allreduce``, ``reduce_scatter``, ``allgather``, ``broadcast``) and of
``shard_partition`` in ``horovod_tpu/common/ops.py``: there a ``psum``
inside the step or a call into the native core, here a
``torch.distributed`` call on the device tensors (NCCL on the GPU, gloo
on the CPU). Each returns new tensors and leaves its input as it was, and
records itself in the call tracker (``divergence.py``).

``group=`` takes None or ``WORLD`` (the world), a ``ProcessGroup`` from
``new_group`` or the mesh, or a ``torch.distributed`` process group.
``compression=`` takes a tensor codec (``Compression.fp16``, ``.bf16``),
which casts the tensor around the collective, or a wire mode ('bf16',
'int8', ``Compression.wire_bf16``, ``.wire_int8``, or None for
``HVD_TPU_COMPRESSION``), under which ``allreduce`` and ``reduce_scatter``
of a float32 tensor run the explicit ring of ``parallel.ring`` with the
codec on each hop and an f32 accumulator (the reference's in-jit routing,
``horovod_tpu/jax/__init__.py:185-208`` and ``:260-272``).
"""

import torch
import torch.distributed as dist

from horovod_tpu_torch import divergence
from horovod_tpu_torch.compression import NONE, codec, wire_mode
from horovod_tpu_torch.groups import group_rank, group_size, resolve_group


def shard_partition(count, n):
    """(counts, offsets) of the reduce-scatter partition: ``count``
    elements in ``n`` near-equal chunks, chunk i to group rank i, the
    first ``count % n`` one element longer."""
    base, rem = divmod(int(count), int(n))
    counts = [base + (1 if i < rem else 0) for i in range(n)]
    offsets = [0] * n
    for i in range(1, n):
        offsets[i] = offsets[i - 1] + counts[i - 1]
    return counts, offsets


def _group(group):
    """The torch process group behind ``group=``; raises on a rank that is
    not a member (torch.distributed would skip the call with a warning,
    and the caller would take its own tensor for the result)."""
    if group_rank(group) < 0:
        raise ValueError("this rank is not a member of %r: a non-member "
                         "must not submit the group's collectives" % (group,))
    return resolve_group(group)


def _scale(t, factor):
    """``t * factor``, in place for floating tensors; an integer tensor
    comes back in its own dtype, truncated."""
    if t.is_floating_point():
        return t.mul_(factor)
    return (t * factor).to(t.dtype)


def _average(t, n):
    if t.is_floating_point():
        return t.div_(n)
    return (t / n).to(t.dtype)


def _ring():
    # imported here: parallel/ imports this module
    from horovod_tpu_torch.parallel import ring
    return ring


def allreduce(tensor, average=True, name=None, compression=None,
              prescale_factor=1.0, postscale_factor=1.0, group=None):
    """Sum (or mean, ``average=True``) of ``tensor`` over the group's
    ranks, in the reference's order: compress, scale by
    ``prescale_factor``, sum, divide by the group's size, scale by
    ``postscale_factor``, decompress. Under a wire mode a float32 tensor is
    summed by ``ring_allreduce`` with the codec on each hop; any other
    dtype by the plain collective."""
    comp, mode = codec(compression), wire_mode(compression)
    out, ctx = comp.compress(tensor)
    out = out.clone() if prescale_factor == 1.0 else out * prescale_factor
    divergence.record("allreduce", out,
                      name or divergence.auto_name("allreduce"))
    if mode.mode != NONE and out.dtype == torch.float32:
        _group(group)
        out = _ring().ring_allreduce(out, group=group, compression=mode)
    else:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group(group))
    if average:
        out = _average(out, group_size(group))
    if postscale_factor != 1.0:
        out = _scale(out, postscale_factor)
    return comp.decompress(out, ctx)


def reduce_scatter(tensor, average=True, name=None, compression=None,
                   prescale_factor=1.0, postscale_factor=1.0, group=None):
    """The flattened ``tensor`` summed (or averaged) over the group's ranks,
    of which this rank keeps its 1-D shard under ``shard_partition`` (sizes
    need not divide: the first ``count % n`` ranks get one element more).
    Scales and tensor codec as in ``allreduce``.

    Under a wire mode ('bf16' or 'int8') the sum runs the ring's
    reduce-scatter leg (``ring_reduce_scatter``) and this rank keeps the
    ring's chunk instead: ``chunk_length(count, n)`` elements, block-aligned,
    the vector zero-padded to n of them, chunk r to group rank r, as the
    reference's in-jit ``reduce_scatter`` returns it. Mode none keeps the
    ``shard_partition`` shards."""
    mode = wire_mode(compression)
    if mode.mode != NONE:
        flat = tensor.reshape(-1)
        if prescale_factor != 1.0:
            flat = flat * prescale_factor
        _group(group)
        divergence.record("reduce_scatter", tensor,
                          name or divergence.auto_name("reduce_scatter"))
        out = _ring().ring_reduce_scatter(flat, group=group,
                                          compression=mode)
        if average:
            out = _average(out, group_size(group))
        if postscale_factor != 1.0:
            out = _scale(out, postscale_factor)
        return out.to(tensor.dtype)
    comp = codec(compression)
    flat, ctx = comp.compress(tensor.reshape(-1))
    if prescale_factor != 1.0:
        flat = flat * prescale_factor
    pg = _group(group)
    n, me = group_size(group), group_rank(group)
    counts, offsets = shard_partition(flat.numel(), n)
    width = counts[0]
    # Equal chunks for the collective: each padded to the longest with
    # zeros, which the sum leaves zero and the shard drops.
    if counts[-1] == width:
        chunks = flat.view(n, width)
    else:
        chunks = flat.new_zeros((n, width))
        for i, (c, o) in enumerate(zip(counts, offsets)):
            chunks[i, :c] = flat[o:o + c]
    out = flat.new_empty(width)
    divergence.record("reduce_scatter", tensor,
                      name or divergence.auto_name("reduce_scatter"))
    dist.reduce_scatter(out, list(chunks.unbind(0)), op=dist.ReduceOp.SUM,
                        group=pg)
    out = out[:counts[me]]
    if average:
        out = _average(out, n)
    if postscale_factor != 1.0:
        out = _scale(out, postscale_factor)
    return comp.decompress(out, ctx)


def allgather(tensor, name=None, group=None):
    """Concatenation along dim 0 of every group rank's ``tensor`` (a 0-d
    tensor counts as one row); the ranks may differ in dim 0 only."""
    if tensor.dim() == 0:
        tensor = tensor.reshape(1)
    pg = _group(group)
    n = group_size(group)
    divergence.record("allgather", tensor,
                      name or divergence.auto_name("allgather"))
    rows = torch.tensor([tensor.shape[0]], device=tensor.device)
    counts = [torch.empty_like(rows) for _ in range(n)]
    dist.all_gather(counts, rows, group=pg)
    counts = [int(c.item()) for c in counts]
    padded = tensor.new_zeros((max(counts),) + tuple(tensor.shape[1:]))
    padded[:tensor.shape[0]] = tensor
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded, group=pg)
    return torch.cat([p[:c] for p, c in zip(parts, counts)], dim=0)


def broadcast(tensor, root_rank=0, name=None, group=None):
    """``tensor`` as it is on ``root_rank`` (a WORLD rank, also under
    ``group=``), on every rank of the group. ``tensor`` may be a tuple,
    list or dict of tensors: each leaf goes on its own, named ``base.i``
    in the order of the leaves (a dict's in sorted key order)."""
    if torch.is_tensor(tensor):
        return _broadcast_one(tensor, root_rank, name, group)
    base = name or divergence.auto_name("broadcast")
    index = iter(range(1 << 62))
    return tree_map(lambda t: _broadcast_one(
        t, root_rank, "%s.%d" % (base, next(index)), group), tensor)


def _broadcast_one(tensor, root_rank, name, group):
    pg = _group(group)
    out = tensor.clone()
    divergence.record("broadcast", out,
                      name or divergence.auto_name("broadcast"))
    dist.broadcast(out, src=root_rank, group=pg)
    return out


def tree_map(fn, tree):
    """``fn`` over every tensor of a tensor, tuple, list or dict (the JAX
    pytree of a batch or of a broadcast), in the order of
    ``jax.tree_util``'s leaves: a dict's values in sorted key order. The
    result keeps the tree's structure and its dicts' key order."""
    if isinstance(tree, dict):
        done = {k: tree_map(fn, tree[k]) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _items(tree):
    """(key, subtree) of a dict, namedtuple, tuple or list; None for a
    leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_flatten(tree, path=()):
    """[(path, leaf)] of a tree of dicts, namedtuples, tuples and lists, in
    the tree's own order; a path is the tuple of ``repr`` of the keys from
    the root (a namedtuple's keys are its field names)."""
    items = _items(tree)
    if items is None:
        return [(path, tree)]
    return [pl for key, sub in items
            for pl in tree_flatten(sub, path + (repr(key),))]


def tree_unflatten(template, leaves, path=()):
    """The structure of ``template`` (its containers' types and order) with
    ``leaves[path]`` at each leaf, ``leaves`` a {path: leaf} as
    ``tree_flatten`` gives the paths."""
    items = _items(template)
    if items is None:
        return leaves[path]
    built = [(k, tree_unflatten(sub, leaves, path + (repr(k),)))
             for k, sub in items]
    if isinstance(template, dict):
        out = type(template)()
        for k, v in built:
            out[k] = v
        return out
    if hasattr(template, "_fields"):
        return type(template)(*(v for _, v in built))
    return type(template)(v for _, v in built)


def sync_batch_norm_stats(stat_sum, stat_sumsq, count, group=None,
                          name="sync_bn"):
    """Sync BN's statistics from partial sums: sums this rank's per-channel
    (sum, sum of squares) over the group's ranks and returns ``(mean, var,
    global_count)`` in f32, the biased variance E[x^2] - E[x]^2 clamped at
    0. ``count`` is this rank's element count behind the sums (every rank
    the same)."""
    stacked = torch.stack([stat_sum.float(), stat_sumsq.float()])
    total = allreduce(stacked, average=False, name=name, group=group)
    global_count = count * group_size(group)
    mean = total[0] / global_count
    var = torch.clamp(total[1] / global_count - mean * mean, min=0.0)
    return mean, var, global_count
