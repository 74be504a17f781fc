"""Gradient averaging around a torch optimizer.

Counterpart of ``horovod_tpu/jax/__init__.py``'s ``allreduce_gradients``,
``broadcast_parameters``, ``broadcast_optimizer_state`` and
``DistributedOptimizer``, with the reduction overlapped with the backward
pass as the reference Horovod's torch binding does it:
``DistributedOptimizer`` puts the gradients in buckets when it is built
and reduces each bucket asynchronously as soon as the backward has
produced every gradient in it, in a fixed bucket order, so the last
layers' gradients travel while the first layers' are still being
computed. ``allreduce_gradients`` is the same reduction done at once, one
flat buffer per dtype (the counterpart of the core's tensor fusion).

Under a wire mode (``compression='bf16'`` or ``'int8'``) each float32
buffer is summed by ``parallel.ring.ring_allreduce`` with the codec on
each hop, still from the hooks and in bucket order.

``DistributedOptimizer`` is a function, as the reference's is: it builds
a ``ReplicatedDistributedOptimizer`` or, with ``sharded_update=True`` (or
``HVD_TPU_SHARDED_UPDATE=1``), a ``ShardedDistributedOptimizer``: the
ZeRO-1 sharded weight update of the reference's
``_sharded_distributed_optimizer`` (``horovod_tpu/jax/__init__.py:527-627``),
whose optimizer state is 1/N of the replicated one's.
``sharded_state_full`` and ``sharded_state_shard`` move its state between
world sizes and shard layouts.

``negotiated=True`` (on ``allreduce_gradients`` and both optimizers) sends
the gradients through the port's negotiation core instead, as the
reference's eager plane does (``horovod_tpu/jax/__init__.py:380-412``):
each bucket (or, in ``allreduce_gradients``, each gradient, all enqueued
before any is waited on) is an ``allreduce_async`` named
``<prefix>.<i>``, and the sharded update's reduce-scatter and allgather are
``reduce_scatter_async`` and ``allgather_async``, in the core's partition
layout under every wire mode. Rank 0's coordinator then validates every
gradient across the ranks, so a sharded rank meeting a replicated one, or
a mismatched compression mode, fails at negotiation on every rank with
both ranks named. CUDA gradients run on the core's device plane (NCCL on
the card). The default, ``False``, issues the ``torch.distributed`` calls
above; which route should be the default is open (ROADMAP). The
negotiated route raises :class:`NegotiatedElasticError` under
``@elastic.run``: the core does not re-form across elastic generations
yet (ROADMAP A8c4).
"""

import contextlib
import copy
import os
import weakref

import torch
import torch.distributed as dist

from horovod_tpu_torch import divergence
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.ops import (allgather, raise_peer_loss,
                                          reduce_scatter, shard_partition)
from horovod_tpu_torch.compression import (NONE, chunk_length, codec,
                                           resolve_wire_arg, wire_mode)
from horovod_tpu_torch.groups import (assert_sharded_update_world_scope,
                                      group_size, resolve_group)
from horovod_tpu_torch.ops.agc import adaptive_grad_clip

# HVD_TPU_FUSION_THRESHOLD's default in native/operations.cc
FUSION_THRESHOLD = 64 * 1024 * 1024


class NegotiatedElasticError(NotImplementedError):
    """``negotiated=True`` inside ``@elastic.run``: the negotiation core
    does not re-form across elastic generations yet (ROADMAP A8c4)."""


def _check_negotiated():
    from horovod_tpu_torch.elastic.run import running
    if running():
        raise NegotiatedElasticError(
            "negotiated=True does not run under @elastic.run: the "
            "negotiation core does not re-form across elastic generations "
            "yet (ROADMAP A8c4); use the default negotiated=False there")


def _negotiated_flat(flat, comp, mode, average, group, name):
    """Starts the sum of a flat buffer through the negotiation core (an
    ``allreduce_async`` named ``name``, averaged by the postscale as the
    reference's host plane does); returns ``finish() -> the reduced
    buffer in flat's dtype``."""
    from horovod_tpu_torch.common import async_ops
    _check_negotiated()
    wire, ctx = comp.compress(flat)
    divergence.record("allreduce", wire, name)
    handle = async_ops.allreduce_async(
        wire, name, postscale_factor=1.0 / group_size(group) if average
        else 1.0, compression=mode, group=group)

    def finish():
        return comp.decompress(async_ops.synchronize(handle), ctx)

    return finish


def _reduce_flat(flat, comp, mode, average, group, name):
    """Starts the sum of a flat buffer over ``group`` under codec ``comp``
    or, for a float32 buffer, wire mode ``mode`` (the ring, which runs to
    its end here); returns ``finish() -> the reduced buffer in flat's
    dtype``."""
    wire, ctx = comp.compress(flat)
    divergence.record("allreduce", wire, name)
    n = group_size(group)
    if mode.mode != NONE and wire.dtype == torch.float32:
        # imported here: parallel/ imports this module
        from horovod_tpu_torch.parallel.ring import ring_allreduce
        wire = ring_allreduce(wire, group=group, compression=mode)
        work = None
    else:
        work = dist.all_reduce(wire, op=dist.ReduceOp.SUM,
                               group=resolve_group(group), async_op=True)

    @raise_peer_loss
    def finish():
        if work is not None:
            work.wait()
        if average:
            wire.div_(n)
        return comp.decompress(wire, ctx)

    return finish


def _scatter(flat, grads):
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def allreduce_gradients(parameters, average=True, name_prefix="grad",
                        compression=None, group=None, negotiated=False):
    """Averages (or sums) the ``.grad`` of every parameter over the ranks
    of ``group`` (the world for None), in place, one flat buffer per dtype
    named ``name_prefix.i``. Parameters without a gradient are skipped:
    every rank must produce gradients for the same parameters.

    ``negotiated=True``: through the negotiation core, as the reference's
    host plane (``horovod_tpu/jax/__init__.py:398-412``): every gradient
    enqueued as ``name_prefix.i`` (i counting the gradients) before any is
    waited on, so the core fuses them, then each synchronized in
    order."""
    comp, mode = codec(compression), wire_mode(compression)
    if negotiated:
        with torch.no_grad():
            grads = [p.grad for p in parameters if p.grad is not None]
            pending = [_negotiated_flat(g.reshape(-1), comp, mode, average,
                                        group, "%s.%d" % (name_prefix, i))
                       for i, g in enumerate(grads)]
            for g, finish in zip(grads, pending):
                g.copy_(finish().view_as(g))
        return
    by_dtype = {}
    for p in parameters:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for i, grads in enumerate(by_dtype.values()):
        flat = torch.cat([g.reshape(-1) for g in grads])
        _scatter(_reduce_flat(flat, comp, mode, average, group,
                              "%s.%d" % (name_prefix, i))(), grads)


def _tensors(params):
    if isinstance(params, dict):
        return list(params.values())
    return [p[1] if isinstance(p, tuple) else p for p in params]


@raise_peer_loss
def broadcast_parameters(params, root_rank=0, name_prefix="param"):
    """Overwrites ``params`` (a state_dict, named_parameters() or
    tensors) with their values on ``root_rank``, in place, each named
    ``name_prefix.i``."""
    with torch.no_grad():
        for i, t in enumerate(_tensors(params)):
            divergence.record("broadcast", t, "%s.%d" % (name_prefix, i))
            dist.broadcast(t.data, src=root_rank,
                           group=basics.process_group())


@raise_peer_loss
def broadcast_optimizer_state(optimizer, root_rank=0,
                              name_prefix="opt_state"):
    """Overwrites the tensors of the optimizer's state (moments, step
    counts) with root's, in place. State the optimizer has not created
    yet (before its first step) has nothing to send."""
    opt = getattr(optimizer, "optimizer", optimizer)
    i = 0
    with torch.no_grad():
        for state in opt.state.values():
            for key, t in state.items():
                if torch.is_tensor(t):
                    # Adam keeps its step count on the CPU; NCCL sends
                    # device tensors only.
                    buf = t.to(basics.device())
                    divergence.record("broadcast", buf,
                                      "%s.%d" % (name_prefix, i))
                    i += 1
                    dist.broadcast(buf, src=root_rank,
                                   group=basics.process_group())
                    state[key] = buf.to(t.device)


def _sharded_update_default():
    """``HVD_TPU_SHARDED_UPDATE`` as the native helper reads it: any
    nonzero integer enables."""
    value = os.environ.get("HVD_TPU_SHARDED_UPDATE", "").strip()
    try:
        return int(value or "0", 0) != 0
    except ValueError:
        return False


def plan_buckets(params, threshold):
    """Buckets of ``params`` for the overlapped reduction: the parameters
    in reverse (the order the backward produces their gradients), by
    dtype, each bucket up to ``threshold`` bytes (a larger parameter gets a
    bucket of its own). Bucket i is the i-th one opened, so the plan, and
    the order the buckets go out in, is the same on every rank."""
    buckets, open_ = [], {}
    for p in reversed(params):
        nbytes = p.numel() * p.element_size()
        b = open_.get(p.dtype)
        if b is None or (b[1] and b[1] + nbytes > threshold):
            b = open_[p.dtype] = [[], 0]
            buckets.append(b[0])
        b[0].append(p)
        b[1] += nbytes
    return buckets


def DistributedOptimizer(optimizer, named_parameters=None, compression=None,
                         average=True, name_prefix="grad", group=None,
                         sharded_update=None, agc=None, negotiated=False):
    """Wraps a torch optimizer so that ``step()`` applies the gradients
    averaged (or, with ``average=False``, summed) over the ranks: a
    ``ReplicatedDistributedOptimizer``, or, with ``sharded_update=True``
    (None: ``HVD_TPU_SHARDED_UPDATE``), a ``ShardedDistributedOptimizer``
    (the reference's ``DistributedOptimizer`` is a function that picks the
    same way). ``compression`` takes a tensor codec or a wire mode, and
    ``negotiated=True`` sends the gradients through the negotiation core
    (module docstring)."""
    if sharded_update is None:
        sharded_update = _sharded_update_default()
    if sharded_update:
        return ShardedDistributedOptimizer(
            optimizer, compression=compression, average=average,
            name_prefix=name_prefix, group=group, agc=agc,
            negotiated=negotiated)
    return ReplicatedDistributedOptimizer(
        optimizer, named_parameters, compression=compression,
        average=average, name_prefix=name_prefix, group=group, agc=agc,
        negotiated=negotiated)


class ReplicatedDistributedOptimizer:
    """``DistributedOptimizer`` without the sharded update: every rank
    holds the whole optimizer state and applies the reduced gradients.

    The reduction overlaps the backward pass. At construction the
    parameters (``named_parameters``' order, else the optimizer's; the same
    on every rank that built the same model) go into buckets
    (``plan_buckets``, ``HVD_TPU_FUSION_THRESHOLD`` bytes, 64 MiB by
    default), and each gets a post-accumulate-grad hook. Once every
    gradient of a bucket has arrived, the bucket is flattened, compressed
    by the codec and reduced with an asynchronous collective named
    ``name_prefix.<bucket>``; bucket i goes out only after buckets 0 to
    i - 1, so every rank issues the collectives in the same order.
    ``synchronize()`` (``step()`` calls it) sends what has not gone out,
    in its turn (also a bucket whose gradients never all arrived), waits
    for every bucket and writes the results into the gradients.
    Parameters without a gradient are skipped.

    ``group=None`` is the mesh's ``batch_group()``, looked up at every
    reduction, or the world without a mesh.

    ``agc`` (a clipping factor, e.g. 0.01) is adaptive gradient clipping
    (``ops/agc.py``): ``step()`` clips each reduced gradient unit-wise
    against its parameter after ``synchronize()`` and before the inner
    step, as the reference clips the averaged gradient
    (``horovod_tpu/jax/__init__.py:512-521``).

    ``negotiated=True``: each bucket goes out from the hooks, in the same
    order, as an ``allreduce_async`` of the negotiation core named
    ``name_prefix.<bucket>``."""

    def __init__(self, optimizer, named_parameters=None, compression=None,
                 average=True, name_prefix="grad", group=None, agc=None,
                 negotiated=False):
        if negotiated:
            _check_negotiated()
        self.optimizer = optimizer
        self._reduce = _negotiated_flat if negotiated else _reduce_flat
        self.agc = agc
        self._clip = None if agc is None else adaptive_grad_clip(agc)
        self._codec = codec(compression)
        self._mode = wire_mode(compression)
        self._average = average
        self._prefix = name_prefix
        self._group = group
        if named_parameters is not None:
            params = [p for _, p in named_parameters]
        else:
            params = [p for g in optimizer.param_groups for p in g["params"]]
        params = [p for p in dict.fromkeys(params) if p.requires_grad]
        threshold = int(os.environ.get("HVD_TPU_FUSION_THRESHOLD", "")
                        or FUSION_THRESHOLD)
        self.buckets = plan_buckets(params, threshold)
        self._bucket_of = {p: i for i, bucket in enumerate(self.buckets)
                           for p in bucket}
        # The hooks hold the optimizer weakly, so one that is dropped stops
        # reducing, and its hooks go with it.
        ref = weakref.ref(self)

        def hook(p):
            opt = ref()
            if opt is not None:
                opt._hook(p)

        self._hooks = [p.register_post_accumulate_grad_hook(hook)
                       for p in self._bucket_of]
        self._sync = True
        # the bucket ids in the order the last synchronize() sent them
        self.launch_order = []
        self._reset()

    def __del__(self):
        for handle in getattr(self, "_hooks", ()):
            handle.remove()

    def _reset(self):
        """Starts a new reduction window: no gradient arrived, no bucket
        out."""
        self._arrived = [set() for _ in self.buckets]
        self._pending = []
        self._order = []
        self._next = 0

    def _hook(self, p):
        if not self._sync:
            return
        i = self._bucket_of[p]
        if i < self._next or p in self._arrived[i]:
            # A gradient arrived again after its bucket went out: a new
            # backward pass without a step in between. Drop the stale
            # window (each rank drops the same one) and start over.
            self._drain()
        self._arrived[i].add(p)
        while (self._next < len(self.buckets) and
               len(self._arrived[self._next]) ==
               len(self.buckets[self._next])):
            self._launch(self._next)

    def _launch(self, i):
        """Sends bucket i; it must be the next one."""
        grads = [p.grad for p in self.buckets[i] if p.grad is not None]
        if grads:
            group = self._group if self._group is not None else \
                basics.batch_group()
            flat = torch.cat([g.reshape(-1) for g in grads])
            self._pending.append((grads, self._reduce(
                flat, self._codec, self._mode, self._average, group,
                "%s.%d" % (self._prefix, i))))
        self._order.append(i)
        self._next = i + 1

    def _drain(self):
        try:
            for _, finish in self._pending:
                finish()
        finally:
            self._reset()

    def synchronize(self):
        """Reduces the gradients over the ranks now: sends every bucket
        that has not gone out, in order, waits for all of them and writes
        the results into the gradients."""
        try:
            while self._next < len(self.buckets):
                self._launch(self._next)
            with torch.no_grad():
                for grads, finish in self._pending:
                    _scatter(finish(), grads)
        except Exception:
            # a lost peer: drop the window, so that the backward after an
            # elastic re-init starts a fresh one
            self._reset()
            raise
        self.launch_order = self._order
        self._reset()

    @contextlib.contextmanager
    def _no_sync(self):
        """Backward passes inside accumulate gradients without reducing
        them (the microbatches of ``make_train_step(accum_steps=n)`` but
        the last)."""
        self._sync = False
        try:
            yield
        finally:
            self._sync = True

    def step(self):
        self.synchronize()
        if self._clip is not None:
            self._clip(self._bucket_of)
        self.optimizer.step()

    def zero_grad(self, set_to_none=True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @property
    def param_groups(self):
        """The wrapped optimizer's groups (an LR scheduler is built on the
        wrapped optimizer and changes them)."""
        return self.optimizer.param_groups


def _shard_of(flat, layout, n, r):
    """Rank r's shard (a new tensor) of a flat vector: its
    ``shard_partition`` slice, or (layout "ring") its ``chunk_length``
    chunk of the vector zero-padded to n of them."""
    if layout == "ring":
        c = chunk_length(flat.numel(), n)
        out = flat.new_zeros(c)
        lo, hi = r * c, min((r + 1) * c, flat.numel())
        if hi > lo:
            out[:hi - lo] = flat[lo:hi]
        return out
    counts, offsets = shard_partition(flat.numel(), n)
    return flat[offsets[r]:offsets[r] + counts[r]].clone()


def _shard_length(total, layout, n, r):
    if layout == "ring":
        return chunk_length(total, n)
    return shard_partition(total, n)[0][r]


def _flat_f32(tensors):
    if not tensors:
        return torch.zeros(0)
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _state_bytes(optimizer):
    return sum(v.numel() * v.element_size()
               for st in optimizer.state.values() for v in st.values()
               if torch.is_tensor(v))


class ShardedDistributedOptimizer:
    """The ZeRO-1 sharded weight update: ``DistributedOptimizer(opt,
    sharded_update=True)`` (the reference's ``_sharded_distributed_optimizer``
    and the old torch binding's ``_ShardedOptimizer``).

    At every ``step()``, for each param group of the wrapped optimizer: the
    gradients of its parameters that require one, in the group's order,
    flattened into one f32 vector (a missing gradient rides as zeros), are
    reduce-scattered over the world (named ``<prefix>.<group>``, so group 0
    is ``"<prefix>.0"``) and averaged; an inner optimizer of the wrapped
    class, with the group's hyperparameters, updates this rank's flat f32
    shard of the parameters, so its state (Adam's moments) holds 1/N of the
    elements; the updated shards are allgathered (``"<prefix>.param_ag"``,
    later groups ``.param_ag.<group>``) and copied back into the
    parameters. The reduction runs in ``step()``, not from hooks.

    Shards: in wire mode none the ``shard_partition`` slices (layout
    "partition", as the reference's host plane); under 'bf16' or 'int8' the
    ring's block-aligned ``chunk_length`` chunks (layout "ring", as the
    in-jit ``_flat_pad``), reduce-scattered by ``ring_reduce_scatter`` with
    the codec on each hop; the parameter allgather is exact in both.

    The hyperparameters of the wrapped optimizer's ``param_groups`` are
    copied onto the inner groups at every step, so an LR scheduler on the
    wrapped optimizer works. The inner state and the f32 shards (the
    master copy after the first step: each step overwrites the parameters
    from them) are built at the first ``step()`` or ``state_dict()``, from
    the parameters' values then. ``opt_state_bytes`` is this rank's
    optimizer-state bytes after the last step. Numerically the replicated
    update for elementwise optimizers (SGD, momentum, Adam, AdamW); one that
    mixes the elements of a tensor sees flat shards instead. The wrapped
    optimizer's own ``state`` stays empty. World scope only
    (``assert_sharded_update_world_scope``, at construction and every
    step).

    ``negotiated=True``: the reduce-scatter and the allgather go through
    the negotiation core (``reduce_scatter_async``, ``allgather_async``,
    the same names), in layout "partition" under every wire mode, as the
    reference's host plane."""

    def __init__(self, optimizer, compression=None, average=True,
                 name_prefix="grad", group=None, agc=None, negotiated=False):
        if agc is not None:
            raise ValueError(
                "agc= does not compose with sharded_update: the sharded "
                "path updates 1/N flat shards, which destroys the "
                "per-unit (output-row) norm structure AGC clips against "
                "— every rank would clip a different slice of each "
                "filter. Use replicated updates with AGC, or chain "
                "optax.adaptive_grad_clip equivalents before a "
                "replicated optimizer")
        assert_sharded_update_world_scope(group)
        if negotiated:
            _check_negotiated()
        self.optimizer = optimizer
        self._negotiated = negotiated
        self._mode = resolve_wire_arg(compression)
        self.layout = "partition" if self._mode.mode == NONE or negotiated \
            else "ring"
        self._average = average
        self._prefix = name_prefix
        self._params = [[p for p in g["params"] if p.requires_grad]
                        for g in optimizer.param_groups]
        if not any(self._params):
            raise ValueError(
                "sharded_update needs params: the optimizer holds no "
                "parameter that requires a gradient")
        self.totals = [sum(p.numel() for p in ps) for ps in self._params]
        self.inner = None
        self._built_for = None
        self.opt_state_bytes = 0

    def _build(self):
        n, r = basics.size(), basics.rank()
        self.shards = [_shard_of(_flat_f32(ps), self.layout, n, r)
                       for ps in self._params]
        groups = []
        for g, sp in zip(self.optimizer.param_groups, self.shards):
            inner = {k: v for k, v in g.items() if k != "params"}
            inner["params"] = [sp]
            groups.append(inner)
        self.inner = type(self.optimizer)(groups)
        self._built_for = (r, n)

    def _ensure_built(self):
        if self.inner is None:
            self._build()
        r, n = self._built_for
        if (r, n) != (basics.rank(), basics.size()):
            raise RuntimeError(
                "sharded optimizer state was built for rank %d of %d but "
                "this process is rank %d of %d; after an elastic resize "
                "restore the last COMMITTED full-form state (the old "
                "membership's shards are gone) and re-shard it via "
                "sharded_state_shard() (docs/ZERO.md)"
                % (r, n, basics.rank(), basics.size()))

    def synchronize(self):
        """Nothing: the sharded update reduces in ``step()``."""

    @contextlib.contextmanager
    def _no_sync(self):
        """Nothing to hold back: gradients accumulate until ``step()``."""
        yield

    def step(self, closure=None):
        assert_sharded_update_world_scope()
        loss = closure() if closure is not None else None
        self._ensure_built()
        for g, inner in zip(self.optimizer.param_groups,
                            self.inner.param_groups):
            inner.update((k, v) for k, v in g.items() if k != "params")
        for i, (ps, sp) in enumerate(zip(self._params, self.shards)):
            if not ps:
                continue
            flat_g = _flat_f32([p.grad if p.grad is not None
                                else torch.zeros_like(p) for p in ps])
            sp.grad = self._reduce_scatter(
                flat_g, "%s.%d" % (self._prefix, i)).to(sp.dtype)
        self.inner.step()
        with torch.no_grad():
            for i, (ps, sp, total) in enumerate(zip(self._params,
                                                    self.shards,
                                                    self.totals)):
                if not ps:
                    continue
                full = self._allgather(sp.detach(), "%s.param_ag%s" % (
                    self._prefix, "" if i == 0 else ".%d" % i))[:total]
                for p, part in zip(ps, full.split([p.numel() for p in ps])):
                    p.copy_(part.view_as(p))
        self.opt_state_bytes = _state_bytes(self.inner)
        return loss

    def _reduce_scatter(self, flat_g, name):
        if not self._negotiated:
            return reduce_scatter(flat_g, average=self._average, name=name,
                                  compression=self._mode)
        from horovod_tpu_torch.common import async_ops
        _check_negotiated()
        divergence.record("reduce_scatter", flat_g, name)
        return async_ops.synchronize(async_ops.reduce_scatter_async(
            flat_g, name, postscale_factor=1.0 / basics.size()
            if self._average else 1.0, compression=self._mode))

    def _allgather(self, shard, name):
        if not self._negotiated:
            return allgather(shard, name=name)
        from horovod_tpu_torch.common import async_ops
        divergence.record("allgather", shard, name)
        return async_ops.synchronize(async_ops.allgather_async(shard, name))

    def zero_grad(self, set_to_none=True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @property
    def param_groups(self):
        """The wrapped optimizer's groups, mirrored onto the inner ones at
        every step."""
        return self.optimizer.param_groups

    def state_dict(self):
        """The inner optimizer's state, this rank's f32 shards and the
        (rank, world) and layout they were built for."""
        self._ensure_built()
        return {"inner": copy.deepcopy(self.inner.state_dict()),
                "shards": [sp.detach().clone() for sp in self.shards],
                "totals": list(self.totals), "layout": self.layout,
                "world": basics.size(), "rank": basics.rank()}

    def load_state_dict(self, state_dict):
        """Restores ``state_dict()``'s output of this rank at this world
        size in this optimizer's layout, or a full form
        (``sharded_state_full``, saved at any world size and under any wire
        mode), which is first sharded for this rank in this optimizer's
        layout (``sharded_state_shard``)."""
        if "inner" not in state_dict or "shards" not in state_dict:
            raise ValueError(
                "this state_dict has no sharded-optimizer state (saved "
                "by a replicated optimizer?); sharded_update cannot "
                "restore it (docs/ZERO.md)")
        if state_dict["world"] == -1:
            state_dict = sharded_state_shard(state_dict, layout=self.layout)
        if (state_dict["world"], state_dict["rank"]) != (basics.size(),
                                                          basics.rank()):
            raise RuntimeError(
                "sharded optimizer state_dict was saved by rank %d of "
                "%d but this process is rank %d of %d; shard state is "
                "rank-local — restore at the same membership, or go "
                "through sharded_state_full/sharded_state_shard "
                "(docs/ZERO.md)"
                % (state_dict["rank"], state_dict["world"], basics.rank(),
                   basics.size()))
        if (list(state_dict["totals"]) != self.totals or
                state_dict["layout"] != self.layout):
            raise ValueError(
                "sharded state of %s elements in layout %r; this optimizer "
                "holds %s in layout %r; go through sharded_state_full to "
                "change the layout" % (state_dict["totals"],
                                       state_dict["layout"], self.totals,
                                       self.layout))
        self._ensure_built()
        self.inner.load_state_dict(copy.deepcopy(state_dict["inner"]))
        with torch.no_grad():
            for sp, saved in zip(self.shards, state_dict["shards"]):
                sp.copy_(saved)


def _leaf_lengths(state, n, r):
    """Shard length of each inner param (one a group)."""
    return [_shard_length(t, state["layout"], n, r) for t in state["totals"]]


def _map_leaves(state, fn):
    """``state`` with ``fn(tensor, group)`` applied to every shard-shaped
    tensor (dim >= 1) of the inner state and to the shards; the inner
    param groups and scalars (a step count) as they are."""
    inner = state["inner"]
    out_state = {}
    for key, st in inner["state"].items():
        out_state[key] = {k: fn(v, int(key)) if torch.is_tensor(v) and
                          v.dim() >= 1 else v for k, v in st.items()}
    return ({"state": out_state, "param_groups": inner["param_groups"]},
            [fn(t, i) for i, t in enumerate(state["shards"])])


def sharded_state_full(state, name_prefix="shard_state"):
    """The full form of a ``ShardedDistributedOptimizer``'s
    ``state_dict()``, free of world size and shard layout: every shard of
    the inner state and every parameter shard allgathered and cut to its
    group's element count; scalars pass through; ``world`` and ``rank`` -1,
    and no ``layout``. A COLLECTIVE: call it on every rank
    at the same point. A state already full is returned as it is. Only the
    membership that built the shards can gather them (``RuntimeError``
    otherwise)."""
    if state["world"] == -1:
        return state
    n, r = basics.size(), basics.rank()
    if state["world"] != n or state["rank"] != r:
        raise RuntimeError(
            "sharded optimizer state was built for rank %d of %d but "
            "this process is rank %d of %d; the full form can only be "
            "materialized by the membership that built the shards — "
            "restore the last COMMITTED full-form state instead "
            "(docs/ZERO.md)" % (state["rank"], state["world"], r, n))
    lengths = _leaf_lengths(state, n, r)
    index = iter(range(1 << 62))

    def full(t, group):
        if t.shape[0] != lengths[group]:
            return t
        return allgather(t, name="%s.%d" % (name_prefix, next(index)))[
            :state["totals"][group]]

    inner, shards = _map_leaves(state, full)
    return {"inner": inner, "shards": shards,
            "totals": list(state["totals"]), "world": -1, "rank": -1}


def sharded_state_shard(full_state, layout="partition"):
    """Inverse of ``sharded_state_full`` for this rank and world size: each
    full-length tensor cut to this rank's shard in ``layout`` ("partition",
    the sharded optimizer's in wire mode none, or "ring", its layout under
    'bf16' and 'int8'). No collective. A state already sharded for this rank and world passes
    through; one sharded for another (rank, world) raises ``ValueError``."""
    n, r = basics.size(), basics.rank()
    if full_state["world"] != -1:
        if (full_state["world"], full_state["rank"]) == (n, r):
            return full_state
        raise ValueError(
            "sharded_state_shard needs the full form (world=-1) or a "
            "state already sharded for this rank; got one sharded for "
            "rank %d of %d on rank %d of %d — call sharded_state_full() "
            "before the membership changes"
            % (full_state["rank"], full_state["world"], r, n))
    totals = full_state["totals"]

    def shard(t, group):
        if t.shape[0] != totals[group]:
            return t
        return _shard_of(t, layout, n, r)

    inner, shards = _map_leaves(full_state, shard)
    return {"inner": inner, "shards": shards, "totals": list(totals),
            "layout": layout, "world": n, "rank": r}
