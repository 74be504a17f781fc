"""Sequence-parallel ring attention over a process group, and Ulysses.

Counterpart of the attention half of ``horovod_tpu/parallel/ring.py``
(``ring_attention``, its forward and backward rings, ``zigzag_shard``,
``zigzag_unshard``, ``ulysses_attention``: two tiled all-to-alls around
``flash_attention``, see its docstring). Each rank of the group holds a shard of the sequence;
the k/v shards travel around the ring, one hop a step, and each step runs
one kernel on the rank's q shard and the k/v shard it holds:

- forward: K4 (``ops.flash_attention.flash_ring_step``) carries the
  online-softmax state (o, m, l) across the steps; after the last one the
  ring divides o by l and keeps lse = m + log l for the backward;
- backward: a second ring over the saved lse, with no recompute of the
  forward. K5 adds each step's dQ contribution to a local f32 accumulator;
  K6 adds dK and dV to f32 accumulators that travel with their k/v shard,
  so after n steps each shard's gradient is back on its home rank.

Fused rotary (``rotary_base=``): the forward ring rotates its q shard and
its home k shard once, before the loop, at their global positions
(``rotate_shards``: ``rope_rotate``, one pass each), and the rotated k
travels the ring with v, so every K4 step runs without rotary on rotated
operands. Autograd keeps the rotated q shard and home k shard in place of
q and k, and the backward ring reads them as they are: K5 and K6 run
without rotary too, and nothing is rotated again. K5 and K6 keep dq and dk
in rotated space, since their sums carry across steps; ``_counter_rotate``
turns them back once after the last step, dq by the rank's q positions and
dk by its home shard's positions (it has travelled the whole ring).

On CPU tensors the same loop calls the steps' plain versions (the JAX
package's separate jnp ring is not needed: the kernels take any length and
the scale is never traced).

The exchange sends to rank (idx + 1) % n of the group and receives from
(idx - 1) % n with ``torch.distributed.batch_isend_irecv`` (NCCL on the
GPU, gloo on the CPU). A step posts the transfer of the k/v shard the next
step needs before its kernel and waits after it, so the transfer overlaps
the compute; in the backward the dK/dV accumulators leave after K6 and are
waited for only before the next step's K6, so their transfer overlaps K5.
A buffer being sent is never written again. One rank sends nothing.

The second half of the module holds the ring collectives of the wire
compression (``ring_allreduce``, ``ring_reduce_scatter``, ``ring_allgather``:
the reference's ``parallel/ring.py:447-650``): a flat vector in one chunk
per rank, each hop one exchange with the ring's neighbours, each hop's
chunk encoded by ``ops.wire_codec`` (bf16 or block-int8) and decoded and
added in f32. The per-hop arithmetic lives in schedules (generators that
yield each hop's payload and take the incoming one), apart from the
exchange, so one process can drive n virtual ranks through the same
schedule (``drive_virtual``).

Schedules (``schedule=``): "contiguous" gives rank r the tokens
[r * L, (r + 1) * L); a causal ring then launches nothing for a k/v shard
entirely in the rank's future, so rank r launches r + 1 steps. "zigzag"
splits the global sequence into 2n chunks and gives rank r chunks r and
2n - 1 - r (``zigzag_shard``), so every rank does the same causal work at
every step.
"""

import torch
import torch.distributed as dist

from horovod_tpu_torch.compression import NONE, chunk_length, resolve
from horovod_tpu_torch.groups import group_rank, group_size, resolve_group
from horovod_tpu_torch.ops.flash_attention import (_delta, _kernel_layout,
                                                   apply_rotary,
                                                   flash_attention,
                                                   flash_ring_bwd_dkv,
                                                   flash_ring_bwd_dq,
                                                   flash_ring_step,
                                                   rope_rotate,
                                                   shard_positions)
from horovod_tpu_torch.ops.wire_codec import wire_decode_add, wire_encode
from horovod_tpu_torch.parallel import _axis
from horovod_tpu_torch.parallel.mesh import axis_group


def _schedule_offsets(schedule, rank, n, L):
    """Global chunk offsets of the shard of length L held by ``rank``: one
    chunk at rank * L, or (zigzag) chunks rank and 2n - 1 - rank of L / 2."""
    if schedule == "zigzag":
        c = L // 2
        return (rank * c, (2 * n - 1 - rank) * c)
    return (rank * L,)


def _shard_visible(src, idx, Lq, Lk):
    """Whether the contiguous kv shard of rank ``src`` overlaps the causal
    lower triangle of rank ``idx``'s q rows [idx * Lq, (idx + 1) * Lq)."""
    return src * Lk <= idx * Lq + (Lq - 1)


def _step_runs(causal, schedule, src, idx, Lq, Lk):
    """Whether a ring step launches its kernels: always, except on a
    contiguous causal ring for a kv shard entirely in this rank's future
    (zigzag gives every step work on every rank by construction)."""
    return (not causal or schedule == "zigzag" or
            _shard_visible(src, idx, Lq, Lk))


class _Exchange:
    """One hop of the ring: sends tensors to the next rank and receives
    same-shaped ones from the previous rank, posted now and waited for in
    ``wait()``."""

    def __init__(self, tensors, group, n, idx):
        self.recv = [torch.empty_like(t) for t in tensors]
        nxt = dist.get_global_rank(group, (idx + 1) % n)
        prv = dist.get_global_rank(group, (idx - 1) % n)
        ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in tensors] +
               [dist.P2POp(dist.irecv, t, prv, group) for t in self.recv])
        self.works = dist.batch_isend_irecv(ops)

    def wait(self):
        for w in self.works:
            w.wait()
        return self.recv


def rotate_shards(q, k, q_offset, kv_offset, rotary_base):
    """A rotary ring's q shard and home k shard, each rotated once at its
    global positions (``shard_chunks`` offsets; ``rope_rotate``: the pass on
    the card): the operands every K4, K5 and K6 step of the ring reads."""
    return (rope_rotate(q, q_offset, rotary_base),
            rope_rotate(k, kv_offset, rotary_base))


def _counter_rotate(dq, dk, q_offset, kv_offset, rotary_base):
    """The rotary ring's f32 dq and dk back from rotated space, after the
    last step: dq by the positions of the rank's q shard, dk by those of
    its home k/v shard (``shard_chunks`` offsets), each with the transpose
    rotation (``horovod_tpu/parallel/ring.py:336-346``)."""
    q_pos = shard_positions(q_offset, dq.shape[2], dq.device)
    k_pos = shard_positions(kv_offset, dk.shape[2], dk.device)
    return (apply_rotary(dq, q_pos, rotary_base, neg=True),
            apply_rotary(dk, k_pos, rotary_base, neg=True))


def _ring_forward(q, k, v, group, causal, scale, schedule,
                  rotary_base=None):
    """q [B, H, Lq, D], k/v [B, G, Lk, D]: (out [B, H, Lq, D] in q's dtype,
    lse f32 [B, H, Lq], the q shard and the home k shard that the steps
    read: rotated once under rotary, k as it was sent)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    o = torch.zeros(B, H, Lq, D, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Lq), float("-inf"), device=q.device)
    l = torch.zeros(B, H, Lq, device=q.device)
    q_off = _schedule_offsets(schedule, idx, n, Lq)
    if rotary_base is not None:  # once: every step reads the same rotation
        q, k = rotate_shards(q, k, q_off,
                             _schedule_offsets(schedule, idx, n, Lk),
                             rotary_base)
    if n > 1:  # what is sent goes as a contiguous buffer
        k, v = k.contiguous(), v.contiguous()
    home_k = k
    for i in range(n):
        src = (idx - i) % n
        hop = _Exchange((k, v), group, n, idx) if i + 1 < n else None
        if _step_runs(causal, schedule, src, idx, Lq, Lk):
            flash_ring_step(q, k, v, o, m, l, q_off,
                            _schedule_offsets(schedule, src, n, Lk), scale,
                            causal)
        if hop is not None:
            k, v = hop.wait()
    l1 = torch.where(l == 0.0, 1.0, l)  # rows that saw no key: out 0
    out = (o / l1[..., None]).to(q.dtype)
    return out, m + torch.log(l1), q, home_k  # such rows keep lse = -inf


def _ring_backward(q, k, v, out, lse, dout, group, causal, scale, schedule,
                   rotary_base=None):
    """The second ring, over the q shard and home k shard the forward
    read (rotated under rotary: nothing is rotated here): (dq, dk, dv) in
    q's, k's and v's dtypes."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    Lq, Lk = q.shape[2], k.shape[2]
    delta = _delta(out, dout)  # once per shard, read by every step
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    q_off = _schedule_offsets(schedule, idx, n, Lq)
    home = _schedule_offsets(schedule, idx, n, Lk)
    q_dtype, k_dtype, v_dtype = q.dtype, k.dtype, v.dtype
    if n > 1:
        k, v = k.contiguous(), v.contiguous()
    grads = None  # the dk/dv hop in flight
    for i in range(n):
        src = (idx - i) % n
        hop = _Exchange((k, v), group, n, idx) if i + 1 < n else None
        runs = _step_runs(causal, schedule, src, idx, Lq, Lk)
        kv_off = _schedule_offsets(schedule, src, n, Lk)
        if runs:
            flash_ring_bwd_dq(q, k, v, dout, lse, delta, dq, q_off, kv_off,
                              scale, causal)
        if grads is not None:
            dk, dv = grads.wait()
        if runs:
            flash_ring_bwd_dkv(q, k, v, dout, lse, delta, dk, dv, q_off,
                               kv_off, scale, causal)
        # dk/dv ride the ring with their k/v shard; the n-th hop takes them
        # home.
        grads = _Exchange((dk, dv), group, n, idx) if n > 1 else None
        if hop is not None:
            k, v = hop.wait()
    if grads is not None:
        dk, dv = grads.wait()
    if rotary_base is not None:
        dq, dk = _counter_rotate(dq, dk, q_off, home, rotary_base)
    return dq.to(q_dtype), dk.to(k_dtype), dv.to(v_dtype)


class _RingFn(torch.autograd.Function):
    """Ring attention over [B, H, L, D] shards; saves (q, k, v, out, lse)
    for the backward ring, q and k as the forward's steps read them (under
    rotary the rotated q shard and home k shard)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, schedule, rotary_base):
        out, lse, q, k = _ring_forward(q, k, v, group, causal, scale,
                                       schedule, rotary_base)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, scale, schedule, rotary_base)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if g.is_cuda:
            g = _kernel_layout(g)
        return _ring_backward(q, k, v, out, lse, g, *ctx.args) + (
            None, None, None, None, None)


def ring_attention(q, k, v, axis_name, causal=True, scale=None,
                   schedule="contiguous", rotary_base=None):
    """Exact multi-head attention over a sequence sharded on ``axis_name``.

    q [B, L_local, H, D], k/v [B, L_local, G, D] with G | H (query head h
    reads kv head h // (H // G)): this rank's shard, equal L_local on every
    rank of the axis. ``axis_name`` names an axis of the last
    ``hybrid_mesh``. Returns [B, L_local, H, D] in q's dtype; differentiable.
    ``schedule`` is "contiguous" or "zigzag" (see the module docstring; lay
    the sequence out with ``zigzag_shard`` first). On CUDA tensors the
    products take bf16 inputs, as in ``flash_attention``. ``rotary_base``
    fuses rotary embedding into the kernels at the shards' global
    positions under ``schedule`` (do not also rotate outside)."""
    if schedule not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring schedule: {schedule!r}")
    B, Lq, H, D = q.shape
    Lk, G = k.shape[1], k.shape[2]
    if H % G:
        raise ValueError(
            f"num_heads={H} must be a multiple of num_kv_heads={G}")
    if scale is None:
        scale = D ** -0.5
    if schedule == "zigzag":
        if not causal:
            raise ValueError("schedule='zigzag' is a causal load-"
                             "balancing layout; use contiguous for "
                             "non-causal attention")
        if Lq % 256 or Lk % 256:
            raise ValueError(
                f"zigzag needs 256-multiple shard lengths (two "
                f"128-aligned chunks per rank); got Lq={Lq}, Lk={Lk}")
    group = axis_group(axis_name)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.is_cuda:
        qt, kt, vt = (_kernel_layout(x) for x in (qt, kt, vt))
    return _RingFn.apply(qt, kt, vt, group, causal, scale, schedule,
                         rotary_base).transpose(1, 2)


def zigzag_shard(x, n, axis=1):
    """Lays a GLOBAL sequence axis out in zigzag rank order: split into 2n
    chunks, rank r's shard = chunk r then chunk 2n - 1 - r. Sharded
    contiguously over n ranks, that is the layout
    ``ring_attention(schedule="zigzag")`` expects. Inverse:
    ``zigzag_unshard``."""
    ch = torch.chunk(x, 2 * n, dim=axis)
    if len(ch) != 2 * n or ch[0].shape[axis] * 2 * n != x.shape[axis]:
        raise ValueError("a length of %d does not split into %d equal chunks"
                         % (x.shape[axis], 2 * n))
    return torch.cat([t for r in range(n) for t in (ch[r], ch[2 * n - 1 - r])],
                     dim=axis)


def zigzag_unshard(x, n, axis=1):
    """Inverse of ``zigzag_shard``: zigzag rank order -> natural order."""
    pairs = torch.chunk(x, 2 * n, dim=axis)  # [r0, r0', r1, r1', ...]
    out = [None] * (2 * n)
    for r in range(n):
        out[r] = pairs[2 * r]
        out[2 * n - 1 - r] = pairs[2 * r + 1]
    return torch.cat(out, dim=axis)


def ulysses_attention(q, k, v, axis_name, causal=True, scale=None,
                      rotary_base=None):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses), the reference's
    ``parallel/ring.py:653``.

    q [B, L_local, H, D] and k, v [B, L_local, G, D] hold this rank's shard
    of the sequence (shards in rank order along ``axis_name``). A tiled
    all-to-all turns each into [B, L, H/n, D] (k, v: G/n heads): the heads
    split into n contiguous chunks, chunk j to rank j, the sequence
    gathered in rank order; ``flash_attention`` (K1-K3) runs over the whole
    sequence on the local heads, and the inverse all-to-all gives each rank
    its shard back. n must divide H and G; the contiguous split keeps each
    kv head with its query heads. ``rotary_base`` fuses rotary in the
    kernels: the gathered sequence starts at position 0, so the positions
    are global. The exchanges run at one rank too."""
    n = _axis.axis_size(axis_name)
    H, G = q.shape[2], k.shape[2]
    if H % G:
        raise ValueError(
            f"num_heads={H} must be a multiple of num_kv_heads={G}")
    if H % n or G % n:
        raise ValueError(
            f"ulysses needs the sp axis size ({n}) to divide both "
            f"num_heads={H} and num_kv_heads={G} (the all_to_all "
            f"splits the head dims)")

    def seq_to_heads(x):
        return _axis.all_to_all(x, axis_name, 2, 1)

    o = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                        causal=causal, scale=scale, rotary_base=rotary_base)
    return _axis.all_to_all(o, axis_name, 1, 2)


# ------------------------------------------------- the ring collectives


class RingCodec:
    """The per-hop arithmetic of a ring under one wire mode: ``encode`` a
    chunk to its payload tuple (``(f32,)``, ``(bf16,)`` or ``(q int8,
    scales f32)``), ``decode_into`` a payload onto a chunk, added
    (``add=True``) or written over it. Mode none moves the chunk as it is
    and adds it in the chunk's dtype; bf16 and int8 run the codec kernels
    (``ops.wire_codec``)."""

    def __init__(self, mode):
        self.mode = resolve(mode)

    def encode(self, chunk):
        if self.mode.mode == NONE:
            return (chunk,)
        return wire_encode(chunk, self.mode)

    def decode_into(self, dst, payload, add):
        if self.mode.mode == NONE:
            return dst.add_(payload[0]) if add else dst.copy_(payload[0])
        return wire_decode_add(dst, payload, self.mode, add)


def allreduce_schedule(chunks, idx, n, codec):
    """One rank's ring allreduce over its ``chunks`` [n, c], updated in
    place: a generator that yields each hop's outgoing payload and takes
    the incoming one, 2 (n - 1) hops. Reduce-scatter: hop s encodes chunk
    (idx - s) % n and adds the decoded incoming chunk into (idx - s - 1) %
    n, so chunk (idx + 1) % n ends with the sum. Allgather: the owner
    encodes that chunk once and decodes its own copy back; the payload
    then travels the ring verbatim, so every rank ends with the same
    values."""
    for s in range(n - 1):
        incoming = yield codec.encode(chunks[(idx - s) % n])
        codec.decode_into(chunks[(idx - s - 1) % n], incoming, add=True)
    owned = (idx + 1) % n
    payload = codec.encode(chunks[owned])
    codec.decode_into(chunks[owned], payload, add=False)
    for s in range(n - 1):
        payload = yield payload
        codec.decode_into(chunks[(idx - s) % n], payload, add=False)
    return chunks


def reduce_scatter_schedule(chunks, idx, n, codec):
    """The allreduce's reduce-scatter leg with every chunk index shifted by
    -1 (n - 1 hops), so rank idx ends owning chunk idx: rank order is
    chunk order. Returns that chunk (a view of ``chunks``)."""
    for s in range(n - 1):
        incoming = yield codec.encode(chunks[(idx - s - 1) % n])
        codec.decode_into(chunks[(idx - s - 2) % n], incoming, add=True)
    return chunks[idx]


def allgather_schedule(shard, chunks, idx, n, codec):
    """The allgather leg (n - 1 hops): the rank encodes its ``shard`` once
    into chunk idx of ``chunks`` [n, c] (decoding its own copy back), and
    every payload travels verbatim, so every rank ends with the same
    values. Returns ``chunks``."""
    payload = codec.encode(shard)
    codec.decode_into(chunks[idx], payload, add=False)
    for s in range(n - 1):
        payload = yield payload
        codec.decode_into(chunks[(idx - s - 1) % n], payload, add=False)
    return chunks


def drive(schedule, group, n, idx):
    """Runs one rank's ``schedule`` over the torch process group ``group``:
    each hop sends the payload to group rank (idx + 1) % n and receives
    the same-shaped one from (idx - 1) % n. Returns the schedule's
    result."""
    try:
        out = next(schedule)
        while True:
            out = schedule.send(_Exchange(out, group, n, idx).wait())
    except StopIteration as stop:
        return stop.value


def drive_virtual(schedules):
    """Runs the schedules of n virtual ranks in this process, hop by hop:
    at each hop rank r receives what rank (r - 1) % n sent. Returns every
    rank's result. The same arithmetic as ``drive`` over n processes."""
    n = len(schedules)
    results = [None] * n

    def advance(r, incoming):
        try:
            return (next(schedules[r]) if incoming is None
                    else schedules[r].send(incoming))
        except StopIteration as stop:
            results[r] = stop.value
            return None

    outs = [advance(r, None) for r in range(n)]
    while any(o is not None for o in outs):
        outs = [advance(r, outs[(r - 1) % n]) for r in range(n)]
    return results


def _ring_group(group):
    """(torch process group, n, this rank's index) of ``group=``."""
    idx = group_rank(group)
    if idx < 0:
        raise ValueError("this rank is not a member of %r: a non-member "
                         "must not submit the group's collectives" % (group,))
    return resolve_group(group), group_size(group), idx


def _wire(x, compression):
    """(mode, flat working copy): only float32 compresses, any other dtype
    rides mode none in its own dtype (exact for integers)."""
    mode = resolve(compression)
    if mode.mode != NONE and x.dtype != torch.float32:
        mode = resolve("none")
    return mode, x.reshape(-1).to(torch.float32 if mode.mode != NONE
                                  else x.dtype)


def _padded(flat, n, c):
    chunks = flat.new_zeros(n * c)
    chunks[:flat.numel()] = flat
    return chunks.view(n, c)


def ring_allreduce(x, group=None, compression="none"):
    """Sum of ``x`` over the ranks of ``group`` (the world for None) through
    an explicit ring with the wire codec on each hop
    (``horovod_tpu.parallel.ring.ring_allreduce``): the flat vector padded
    into one ``chunk_length`` chunk per rank, n - 1 reduce-scatter hops that
    encode the outgoing chunk and add the decoded incoming one in f32, then
    n - 1 allgather hops that forward each owner's payload verbatim, so
    every rank ends with the same values. ``compression``: 'none', 'bf16'
    or 'int8' (or a wire mode; None is ``HVD_TPU_COMPRESSION``). Returns a
    new tensor in x's shape and dtype. One rank: x, no codec."""
    pg, n, idx = _ring_group(group)
    mode, flat = _wire(x, compression)
    if n == 1:
        return flat.reshape(x.shape).to(x.dtype, copy=True)
    chunks = _padded(flat, n, chunk_length(flat.numel(), n))
    drive(allreduce_schedule(chunks, idx, n, RingCodec(mode)), pg, n, idx)
    return chunks.view(-1)[:flat.numel()].reshape(x.shape).to(x.dtype)


def ring_reduce_scatter(x, group=None, compression="none"):
    """This rank's chunk of the sum of the flattened ``x`` over the ranks
    of ``group``: chunk r of ``chunk_length(x.numel(), n)`` elements (the
    vector zero-padded to n of them) to group rank r, after n - 1 hops of
    the ring's reduce-scatter leg under the codec. 1-D, float32 under bf16
    or int8, else x's dtype. One rank: the padded flat vector, no codec."""
    pg, n, idx = _ring_group(group)
    mode, flat = _wire(x, compression)
    c = chunk_length(flat.numel(), n)
    if n == 1:
        return _padded(flat, 1, c).view(-1)
    chunks = _padded(flat, n, c)
    return drive(reduce_scatter_schedule(chunks, idx, n, RingCodec(mode)),
                 pg, n, idx).clone()


def ring_allgather(x, group=None, compression="none"):
    """The concatenation of every group rank's equal-length 1-D shard ``x``
    in rank order (the parameter leg of the sharded update). Under bf16 or
    int8 each owner encodes its shard once (int8 needs a multiple of 256
    elements: ``ring_reduce_scatter``'s chunks are) and every rank ends with
    the same decoded values. One rank: x, flat."""
    pg, n, idx = _ring_group(group)
    mode, flat = _wire(x, compression)
    if n == 1:
        return x.reshape(-1).clone()
    chunks = flat.new_zeros(n, flat.numel())
    return drive(allgather_schedule(flat, chunks, idx, n, RingCodec(mode)),
                 pg, n, idx).view(-1)
