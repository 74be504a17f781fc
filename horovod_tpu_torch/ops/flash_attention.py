"""Flash attention: hand-written CUDA kernels for Hopper and their plain
PyTorch versions.

Counterpart of ``horovod_tpu/ops/flash_attention.py``. Seven kernels in
``csrc/``; the flash attention of one sequence:

- K1 ``flash_fwd`` (``flash_fwd.cu``): O and the per-row log-sum-exp;
- K2 ``flash_bwd_dq`` (``flash_bwd.cu``): dQ;
- K3 ``flash_bwd_dkv`` (``flash_bwd.cu``): dK and dV, the GQA group summed
  inside the kernel.

Each wrapper takes ``[B, H, L, D]`` tensors (k and v with G | H heads) and
dispatches on where they lie: a CPU tensor goes to the plain version, a
CUDA tensor launches the kernel or raises. Nothing falls back. The
kernels mask the ragged end of L themselves, so every L is taken. The
wrappers accept views whose last dim is contiguous (the public function
hands them the model's ``[B, L, H, D]`` activations transposed, without a
copy) and allocate every output. ``lse`` is a plain f32 ``[B, H, L]``.

Precision: the kernels take bfloat16 or float32 tensors, but their
products always run on bf16 inputs with f32 accumulation, as the TPU
kernels do (the softmax, lse, delta and the outputs stay f32). So on a
GPU, float32 attention is bf16 attention with f32 outputs; only the plain
versions on the CPU compute it exactly in f32. The kernels load their
tiles by TMA, which copies bytes and cannot round: the wrappers round
float32 q, k, v and dout to bf16 (``.to(torch.bfloat16)``) before the
launch, and K1-K3 still write O, dQ, dK and dV in q's dtype.

Each wrapper counts its launches in ``.launches``, and those of its calls
under rotary in ``.rot_launches`` (K1, K4: the kernel on rotated copies; K2,
K3: the instantiation that counter-rotates dQ or dK).

The ring-attention steps (K4 in ``csrc/flash_fwd.cu`` on K1's mainloop,
K5 and K6 in ``csrc/flash_bwd.cu`` on K2's and K3's) run one step of
``parallel.ring.ring_attention``: the rank's q shard against the k/v shard
it holds. Each shard is one chunk of global positions ``(off,)`` or two
equal chunks ``(off0, off1)`` (the zigzag schedule); the causal mask runs
on those positions.

- K4 ``flash_ring_step``: one online-softmax update of the carried state
  (o f32 [B, H, Lq, D], un-normalised; m and l f32 [B, H, Lq], m in
  natural-log units);
- K5 ``flash_ring_bwd_dq``: adds this shard's dQ contribution to an f32
  accumulator;
- K6 ``flash_ring_bwd_dkv``: adds its dK, dV contribution to the f32
  accumulators that travel with the k/v shard.

All three update their state or accumulators in place and return them.

Fused rotary (``rotary_base=``, the TPU kernels' ``rotary`` flag): every
wrapper and plain version takes the base of a rotary embedding and rotates
q and k inside (at positions 0..L-1 in K1-K3, at the shards' global
positions in K4-K6), so the caller does not rotate them first. The rotated
values are rounded to the inputs' dtype, as the TPU kernels round them. K2
and K3 counter-rotate their finished dQ and dK (the transpose rotation), so
the gradients are those of the unrotated q and k. K5 and K6 leave dq and dk
in rotated space: their sums carry across ring steps, and the ring
counter-rotates them once after the last step. On a CUDA tensor the rotary
pass and the counter-rotation read cos and sin from one f32 table per
(head dim, base, device), built at first use and grown to the longest
positions asked for (``rope_tables``).

Where the rotation happens on the card: no mainloop rotates. The seventh
kernel, ``rope_rotate`` (``rope.cu``: one pass over a tensor, bit for bit
``apply_rotary``), rotates q and k once a layer, in the forward:
``flash_attention`` (``_FlashFn``) rotates them, runs K1 on the copies and
keeps the copies for the backward, whose K2 and K3 read them as they are
and only counter-rotate dQ and dK. The ring (``parallel.ring``) rotates
its q shard and its home k shard once in its forward and runs K4, K5 and K6
without rotary on the copies. A wrapper called alone with ``rotary_base``
(``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``, the ring steps) and
``flash_backward`` rotate their own q and k first.
"""

import ctypes

import torch

from horovod_tpu_torch.ops import _build

BLOCK_Q = 128  # q rows per step of the blockwise plain version

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (32, 64, 128)
_MAX_GRID_Y = 65535

# The arguments after the tensor pointers, (K2, K3) the two rotary tables of
# the counter-rotation (null without rotary), the tensor maps and (K1-K3) the
# outputs' strides: K1-K3 take B, H, G, L, D and the dtype of their outputs;
# the ring steps B, H, G, Lq, Lk, D and the chunk offsets; then scale,
# causal and the stream.
_P = ctypes.c_void_p
_TAIL = [ctypes.c_float, ctypes.c_int, _P]
_FLASH_ARGS = [ctypes.c_int] * 6 + _TAIL
_RING_ARGS = [ctypes.c_int] * 6 + [_P] + _TAIL
# C entry point -> (source, argument types)
_ENTRIES = {
    "hvd_flash_fwd": ("flash_fwd", [_P] * 7 + _FLASH_ARGS),
    "hvd_flash_bwd_dq": ("flash_bwd", [_P] * 11 + _FLASH_ARGS),
    "hvd_flash_bwd_dkv": ("flash_bwd", [_P] * 12 + _FLASH_ARGS),
    "hvd_flash_ring_fwd": ("flash_fwd", [_P] * 7 + _RING_ARGS),
    "hvd_flash_ring_bwd_dq": ("flash_bwd", [_P] * 8 + _RING_ARGS),
    "hvd_flash_ring_bwd_dkv": ("flash_bwd", [_P] * 9 + _RING_ARGS),
    # x, y, the two tables, strides; B, heads, L, D, off0, off1, len; stream
    "hvd_rope_rotate": ("rope", [_P] * 5 + [ctypes.c_int] * 7 + [_P]),
}
# The forward kernels' TMA boxes: at most 64 bf16 columns (a head dim of
# 128 is two boxes); 128 rows of K and V (a key tile), 64 rows of Q (one
# consumer warpgroup's).
TMA_BOX_COLS = 64
TMA_BOX_ROWS = 128
TMA_Q_BOX_ROWS = 64
# The backward kernels' TMA boxes: 64 rows of the operands that a consumer
# warpgroup owns (K2, K5: q and dout; K3, K6: k and v), and the streamed
# tiles' rows: 64, or 32 for K3's and K6's q tiles at a head dim of 128.
BWD_BOX_ROWS = 64
_bound = {}
_rope = {}  # (D, base, device) -> f32 [2, positions, D / 2]


def _rope_tables(positions, D, base):
    """(cos, sin) f32 [..., D/2] of the angles positions * base^(-2j/D), j <
    D/2: the tables of ``horovod_tpu/ops/flash_attention.py:_rope_tables``
    at half width (pair j and j + D/2 share an angle; the sign of the
    rotation is applied where they are used)."""
    half = D // 2
    inv = base ** (-torch.arange(half, dtype=torch.float32,
                                 device=positions.device) * 2.0 / D)
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x, positions, base=10000.0, neg=False):
    """Rotary embedding over the last dim; ``positions`` broadcastable to
    ``x.shape[:-1]``. Pairs are (d, d + D/2). ``neg=True`` applies the
    transpose rotation R(-pos). Computed in f32, rounded to x's dtype."""
    D = x.shape[-1]
    half = D // 2
    cos, sin = _rope_tables(positions.to(x.device), D, base)
    if neg:
        sin = -sin
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def rope_tables(n, D, base, device):
    """The kernels' rotary tables: one f32 [2, m, D/2] tensor (cos, then
    sin) for positions 0..m-1, m >= n, kept per (D, base, device). Row p is
    the same at any m, so a longer request rebuilds the one table at the
    next power of two of n and every launch indexes it by position."""
    key = (D, float(base), str(device))
    t = _rope.get(key)
    if t is None or t.shape[1] < n:
        m = 1 << max(n - 1, 0).bit_length()
        t = torch.stack(_rope_tables(torch.arange(m, device=device), D,
                                     base)).contiguous()
        _rope[key] = t
    return t


def analytic_attention_flops(B, H, L, D, causal=True, training=False):
    """FLOPs the flash kernels do per call: 2 products per (q, k) pair in
    the forward, 7 in the backward (s and dP are recomputed by both
    backward kernels). ``training=True`` is forward plus backward, 9.
    Causal halves the pairs. H counts query heads."""
    per_matmul = 2.0 * B * H * L * L * D
    if causal:
        per_matmul /= 2.0
    return (9.0 if training else 2.0) * per_matmul


# ---------------------------------------------------------------- plain


def _expand_kv(x, group):
    """[B, G, L, D] -> [B, G * group, L, D]: query head h reads kv head
    h // group."""
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def _scores(q, k, scale, causal):
    """f32 scale * q.k^T, -inf above the diagonal when causal."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        L = s.shape[-1]
        above = torch.ones(L, L, dtype=torch.bool,
                           device=s.device).triu_(1)
        s = s.masked_fill(above, float("-inf"))
    return s


def _rotate(q, k, q_offset, kv_offset, rotary_base):
    """q and k rotated at the global positions of their shards (K1-K3: one
    chunk at 0, positions 0..L-1), as the kernels rotate them; as they are
    without rotary."""
    if rotary_base is None:
        return q, k
    return (apply_rotary(q, shard_positions(q_offset, q.shape[2], q.device),
                         rotary_base),
            apply_rotary(k, shard_positions(kv_offset, k.shape[2], q.device),
                         rotary_base))


def _unrotate(x, rotary_base):
    """The transpose rotation of an f32 gradient at positions 0..L-1 (K2's
    dQ, K3's dK), or x as it is without rotary."""
    if rotary_base is None:
        return x
    return apply_rotary(x, torch.arange(x.shape[2], device=x.device),
                        rotary_base, neg=True)


def _probs_and_ds(q, k, v, dout, lse, delta, scale, causal):
    group = q.shape[1] // k.shape[1]
    kf, vf = _expand_kv(k, group).float(), _expand_kv(v, group).float()
    p = torch.exp(_scores(q, kf, scale, causal) - lse[..., None])
    dp = torch.matmul(dout.float(), vf.transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale, kf


def flash_forward_ref(q, k, v, scale, causal, rotary_base=None):
    """Plain version of K1 in f32: (out in q's dtype, lse f32 [B, H, L])."""
    q, k = _rotate(q, k, (0,), (0,), rotary_base)
    group = q.shape[1] // k.shape[1]
    s = _scores(q, _expand_kv(k, group), scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.matmul(p, _expand_kv(v, group).float())
    return out.to(q.dtype), lse


def flash_bwd_dq_ref(q, k, v, dout, lse, delta, scale, causal,
                     rotary_base=None):
    """Plain version of K2 in f32: dQ = dS.K with P from lse (rotary: on the
    rotated q and k, dQ counter-rotated)."""
    return _dq_ref(*_rotate(q, k, (0,), (0,), rotary_base), v, dout, lse,
                   delta, scale, causal, rotary_base)


def _dq_ref(qr, kr, v, dout, lse, delta, scale, causal, rotary_base):
    """K2's plain version on q and k rotated already (``rotary_base``: dQ
    counter-rotated)."""
    _, ds, kf = _probs_and_ds(qr, kr, v, dout, lse, delta, scale, causal)
    return _unrotate(torch.matmul(ds, kf), rotary_base).to(qr.dtype)


def flash_bwd_dkv_ref(q, k, v, dout, lse, delta, scale, causal,
                      rotary_base=None):
    """Plain version of K3 in f32: dV = P^T.dO and dK = dS^T.Q, summed over
    the query heads of each kv head (rotary: on the rotated q and k, dK
    counter-rotated)."""
    return _dkv_ref(*_rotate(q, k, (0,), (0,), rotary_base), v, dout, lse,
                    delta, scale, causal, rotary_base)


def _dkv_ref(qr, kr, v, dout, lse, delta, scale, causal, rotary_base):
    """K3's plain version on q and k rotated already (``rotary_base``: dK
    counter-rotated)."""
    B, H, L, D = qr.shape
    G = kr.shape[1]
    p, ds, _ = _probs_and_ds(qr, kr, v, dout, lse, delta, scale, causal)
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    dk = torch.matmul(ds.transpose(-1, -2), qr.float())
    dk = dk.view(B, G, H // G, L, D).sum(2)
    dv = dv.view(B, G, H // G, L, D).sum(2)
    return _unrotate(dk, rotary_base).to(kr.dtype), dv.to(v.dtype)


def _delta(out, dout):
    """rowsum(dO * O) in f32, [B, H, L]: one elementwise pass outside the
    kernels, as XLA computes it for the TPU kernels."""
    return (dout.float() * out.float()).sum(-1).contiguous()


def flash_backward_ref(q, k, v, out, lse, dout, scale, causal,
                       rotary_base=None):
    """Plain version of the whole backward: (dq, dk, dv)."""
    delta = _delta(out, dout)
    dk, dv = flash_bwd_dkv_ref(q, k, v, dout, lse, delta, scale, causal,
                               rotary_base)
    return (flash_bwd_dq_ref(q, k, v, dout, lse, delta, scale, causal,
                             rotary_base), dk, dv)


def blockwise_reference(q, k, v, scale, causal, rotary_base=None):
    """Attention over blocks of ``BLOCK_Q`` query rows in f32, the JAX
    package's fallback. q [B, H, L, D], k/v [B, G, L, D]; returns q's
    dtype. A sequence remainder gets its own smaller block."""
    B, H, L, D = q.shape
    group = H // k.shape[1]
    if rotary_base is not None:
        pos = torch.arange(L, device=q.device)
        q = apply_rotary(q, pos, rotary_base)
        k = apply_rotary(k, pos, rotary_base)
    kf = _expand_kv(k, group).float()
    vf = _expand_kv(v, group).float()
    blocks = []
    for start in range(0, L, BLOCK_Q):
        qs = q[:, :, start:start + BLOCK_Q].float()
        s = torch.matmul(qs, kf.transpose(-1, -2)) * scale
        if causal:
            rows = torch.arange(start, start + qs.shape[2],
                                device=q.device)[:, None]
            cols = torch.arange(L, device=q.device)[None]
            s = s.masked_fill(rows < cols, float("-inf"))
        blocks.append(torch.matmul(torch.softmax(s, dim=-1),
                                   vf).to(q.dtype))
    return torch.cat(blocks, dim=2)


def shard_chunks(offset, L):
    """(off0, off1, chunk length) of a shard of length ``L`` given as
    ``(off,)`` (one chunk, then off1 = off0 + L) or ``(off0, off1)`` (two
    equal chunks): row r lies at off0 + r below the chunk length, else at
    off1 + r - length."""
    if isinstance(offset, tuple) and len(offset) == 1:
        return int(offset[0]), int(offset[0]) + L, L
    if isinstance(offset, tuple) and len(offset) == 2 and L % 2 == 0:
        return int(offset[0]), int(offset[1]), L // 2
    raise ValueError("a shard is one chunk (off,) or two equal chunks "
                     "(off0, off1); got %r for length %d" % (offset, L))


def shard_positions(offset, L, device=None):
    """Global positions [L] (int64) of a shard described by its chunk
    offsets (see ``shard_chunks``)."""
    off0, off1, n = shard_chunks(offset, L)
    r = torch.arange(L, device=device)
    return torch.where(r < n, off0 + r, off1 + r - n)


def _ring_scores(q, k, q_offset, kv_offset, scale, causal):
    """(f32 scale * q.k^T over G | H kv heads, the causal mask on global
    positions or None)."""
    s = torch.matmul(q.float(), _expand_kv(k, q.shape[1] // k.shape[1])
                     .float().transpose(-1, -2)) * scale
    if not causal:
        return s, None
    mask = (shard_positions(q_offset, q.shape[2], q.device)[:, None] <
            shard_positions(kv_offset, k.shape[2], q.device)[None, :])
    return s.masked_fill(mask, float("-inf")), mask


def flash_ring_step_ref(q, k, v, o, m, l, q_offset, kv_offset, scale,
                        causal, rotary_base=None):
    """Plain version of K4 in f32: the carried (o, m, l) after this k/v
    shard, as new tensors. Rows with no visible key yet keep m = -inf."""
    q, k = _rotate(q, k, q_offset, kv_offset, rotary_base)
    s, _ = _ring_scores(q, k, q_offset, kv_offset, scale, causal)
    m_new = torch.maximum(m, s.amax(-1))
    empty = torch.isneginf(m_new)
    alpha = torch.where(empty, 0.0, torch.exp(m - m_new))
    p = torch.where(empty[..., None], 0.0, torch.exp(s - m_new[..., None]))
    vf = _expand_kv(v, q.shape[1] // v.shape[1]).float()
    return (o * alpha[..., None] + torch.matmul(p, vf),
            m_new, l * alpha + p.sum(-1))


def _ring_probs_and_ds(q, k, v, dout, lse, delta, q_offset, kv_offset,
                       scale, causal):
    s, mask = _ring_scores(q, k, q_offset, kv_offset, scale, causal)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = p.masked_fill(mask, 0.0)
    vf = _expand_kv(v, q.shape[1] // v.shape[1]).float()
    dp = torch.matmul(dout.float(), vf.transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def flash_ring_bwd_dq_ref(q, k, v, dout, lse, delta, dq, q_offset,
                          kv_offset, scale, causal, rotary_base=None):
    """Plain version of K5 in f32: dq + dS.K, P from the ring's lse (rotary:
    on the rotated q and k, the sum left in rotated space)."""
    q, k = _rotate(q, k, q_offset, kv_offset, rotary_base)
    _, ds = _ring_probs_and_ds(q, k, v, dout, lse, delta, q_offset,
                               kv_offset, scale, causal)
    return dq + torch.matmul(ds, _expand_kv(k, q.shape[1] // k.shape[1])
                             .float())


def flash_ring_bwd_dkv_ref(q, k, v, dout, lse, delta, dk, dv, q_offset,
                           kv_offset, scale, causal, rotary_base=None):
    """Plain version of K6 in f32: (dk + dS^T.Q, dv + P^T.dO), summed over
    the query heads of each kv head (rotary: on the rotated q and k, dk left
    in rotated space)."""
    q, k = _rotate(q, k, q_offset, kv_offset, rotary_base)
    B, H, _, D = q.shape
    G, Lk = k.shape[1], k.shape[2]
    p, ds = _ring_probs_and_ds(q, k, v, dout, lse, delta, q_offset,
                               kv_offset, scale, causal)
    ddk = torch.matmul(ds.transpose(-1, -2), q.float())
    ddv = torch.matmul(p.transpose(-1, -2), dout.float())
    return (dk + ddk.view(B, G, H // G, Lk, D).sum(2),
            dv + ddv.view(B, G, H // G, Lk, D).sum(2))


# --------------------------------------------------------------- kernels


def _entry(name):
    """(library, C function) of an entry point, built and bound once."""
    if name not in _bound:
        source, args = _ENTRIES[name]
        lib = _build.library(source)
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
        _bound[name] = (lib, fn)
    return _bound[name]


def _layout_ok(t):
    """Last dim contiguous, the other strides multiples of 8 elements and
    the base 16-byte aligned: what the kernels' 16-byte loads need."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and
            all(s % 8 == 0 for s, n in zip(t.stride()[:-1], t.shape[:-1])
                if n > 1))


def _kernel_layout(t):
    """``t`` itself if the kernels can read it in place, else a copy."""
    return t if _layout_ok(t) else t.clone(
        memory_format=torch.contiguous_format)


def _on_cpu(what, q):
    """True for CPU tensors (the plain version runs); False for CUDA
    tensors (the kernel runs); raises for any other device."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError("%s: tensors on %s; the kernels run on CUDA and the "
                         "plain version on the CPU" % (what, q.device))
    return False


def _check(what, q, k, tensors, stats=()):
    """Validates the kernel arguments; returns (B, H, G, L, D)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("%s: q and k must be [B, heads, L, D]" % what)
    B, H, L, D = q.shape
    G = k.shape[1]
    if k.shape != (B, G, L, D) or G == 0 or H % G:
        raise ValueError("%s: k/v of shape %s do not fit q %s (kv heads "
                         "must divide query heads)"
                         % (what, tuple(k.shape), tuple(q.shape)))
    if D not in _HEAD_DIMS:
        raise ValueError("%s: head dim %d is not one of %s"
                         % (what, D, _HEAD_DIMS))
    if B * H == 0 or L == 0:
        raise ValueError("%s: empty input %s" % (what, tuple(q.shape)))
    if B * H > _MAX_GRID_Y:
        raise ValueError("%s: B * H = %d exceeds the grid's %d"
                         % (what, B * H, _MAX_GRID_Y))
    if q.dtype not in _DTYPES:
        raise TypeError("%s: dtype %s; the kernels take bfloat16 or float32"
                        % (what, q.dtype))
    for name, t in tensors.items():
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("%s: %s is %s on %s, q is %s on %s" % (
                what, name, t.dtype, t.device, q.dtype, q.device))
        if not _layout_ok(t):
            raise ValueError(
                "%s: %s needs a contiguous last dim, other strides that are "
                "multiples of 8 and a 16-byte aligned base; got strides %s"
                % (what, name, tuple(t.stride())))
    for name, t in stats:
        if (t.device != q.device or t.dtype != torch.float32 or
                t.shape != (B, H, L) or not t.is_contiguous()):
            raise ValueError("%s: %s must be contiguous float32 [B, H, L] on "
                             "%s" % (what, name, q.device))
    return B, H, G, L, D


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def tensor_map(t, box_rows=TMA_BOX_ROWS):
    """The layout of the TMA tensor map over a bf16 ``[B, heads, L, D]``
    view ``t`` with a contiguous last dim, as K1-K4 encode it
    (``csrc/hopper.cuh``), innermost first: dims ``(D, L, heads, B)``, the
    byte strides of L, heads and B, and the box ``(min(D, 64), box_rows, 1,
    1)``.
    Raises ValueError where TMA cannot read ``t`` in place: a base that is
    not 16-byte aligned, or a byte stride that is not a multiple of 16 (a
    dim of size 1 is never stepped over, and its stride is rounded up)."""
    if t.dim() != 4 or t.dtype != torch.bfloat16 or t.stride(-1) != 1:
        raise ValueError("tensor_map: needs a bf16 [B, heads, L, D] view "
                         "with a contiguous last dim; got %s %s strides %s"
                         % (t.dtype, tuple(t.shape), tuple(t.stride())))
    if t.data_ptr() % 16:
        raise ValueError("tensor_map: the base is not 16-byte aligned")
    B, heads, L, D = t.shape
    strides = []
    for dim, n in ((2, L), (1, heads), (0, B)):
        stride = t.stride(dim) * t.element_size()
        if stride % 16:
            if n != 1:
                raise ValueError(
                    "tensor_map: byte stride %d of dim %d is not a multiple "
                    "of 16" % (stride, dim))
            stride += 16 - stride % 16
        strides.append(stride)
    return ((D, L, heads, B), tuple(strides),
            (min(D, TMA_BOX_COLS), box_rows, 1, 1))


def _maps(*tensors_and_rows):
    """The tensor maps of (tensor, box rows) pairs for a C entry point: 11
    values each."""
    vals = [x for t, rows in tensors_and_rows
            for part in tensor_map(t, rows) for x in part]
    return (ctypes.c_longlong * len(vals))(*vals)


def _fwd_maps(q, k, v):
    """The maps of K1 and K4: 64-row q boxes, 128-row k and v boxes."""
    return _maps((q, TMA_Q_BOX_ROWS), (k, TMA_BOX_ROWS), (v, TMA_BOX_ROWS))


def bwd_box_rows(dkv, D):
    """(rows of q's and dout's boxes, rows of k's and v's) for K2 and K5
    (``dkv=False``) or K3 and K6 at head dim D."""
    stream = BWD_BOX_ROWS // 2 if dkv and D == 128 else BWD_BOX_ROWS
    return (stream, BWD_BOX_ROWS) if dkv else (BWD_BOX_ROWS, stream)


def _bwd_maps(q, k, v, dout, dkv):
    """The maps of K2 and K5 (``dkv=False``) or K3 and K6 over q, k, v and
    dout."""
    q_rows, kv_rows = bwd_box_rows(dkv, q.shape[-1])
    return _maps((q, q_rows), (k, kv_rows), (v, kv_rows), (dout, q_rows))


def _bf16(*tensors):
    """The tensors as bf16, for the kernels' TMA loads: a float32 tensor is
    rounded (an explicit cast; the products always took bf16-rounded
    inputs)."""
    return tuple(t if t.dtype == torch.bfloat16 else t.to(torch.bfloat16)
                 for t in tensors)


def _call(name, q, *args):
    """Calls C entry point ``name`` on q's device and stream; raises on a
    CUDA error."""
    lib, fn = _entry(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    _build.check(lib, err, name)


def _launch(name, q, ptrs, strides, dims, scale, causal):
    _call(name, q, *ptrs, strides, *dims, _DTYPES[q.dtype], float(scale),
          int(bool(causal)))


def _count(wrapper, rotary_base):
    """One launch of ``wrapper``'s kernel, without rotary or under it."""
    if rotary_base is None:
        wrapper.launches += 1
    else:
        wrapper.rot_launches += 1


def _rope_ptrs(n, D, rotary_base, device):
    """The kernels' two rotary table pointers for positions 0..n-1, or two
    nulls without rotary."""
    if rotary_base is None:
        return [None, None]
    t = rope_tables(n, D, rotary_base, device)
    return [t[0].data_ptr(), t[1].data_ptr()]


def _empty_like_heads(q, heads):
    """Output [B, heads, L, D] laid out as [B, L, heads, D] in memory, the
    layout of the model's activations."""
    B, _, L, D = q.shape
    return torch.empty(B, L, heads, D, dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def rope_rotate(x, offset, rotary_base):
    """q or k ``[B, heads, L, D]`` rotated at the global positions of a
    shard (``shard_chunks`` offsets; ``(0,)``: 0..L-1): ``apply_rotary`` at
    ``shard_positions``. On a CUDA tensor the rotary pass of ``rope.cu``
    runs once over it and returns a new tensor laid out as ``[B, L, heads,
    D]`` in memory, bit for bit ``apply_rotary`` of the bf16 values: a
    float32 ``x`` is rounded to bf16 first and the bf16 result returned as
    float32, the values the kernels that read it take."""
    if _on_cpu("rope_rotate", x):
        return apply_rotary(x, shard_positions(offset, x.shape[2], x.device),
                            rotary_base)
    return _rope_launch(x, offset, rotary_base).to(x.dtype)


def _rope_launch(x, offset, rotary_base):
    """The rotary pass over a CUDA tensor: a new bf16 tensor."""
    B, heads, _, L, D = _check("rope_rotate", x, x, {"x": x})
    (xb,) = _bf16(x)
    y = _empty_like_heads(xb, heads)
    _call("hvd_rope_rotate", x, xb.data_ptr(), y.data_ptr(),
          *_rope_ptrs(_positions_end(offset, L), D, rotary_base, x.device),
          _strides(xb, y), B, heads, L, D, *shard_chunks(offset, L))
    rope_rotate.launches += 1
    return y


def _rope_qk(q, k, q_offset, kv_offset, rotary_base):
    """q and k as the kernels read them (CUDA tensors): bf16, rotated at
    their shards' positions by the rotary pass under rotary."""
    if rotary_base is None:
        return _bf16(q, k)
    return (_rope_launch(q, q_offset, rotary_base),
            _rope_launch(k, kv_offset, rotary_base))


def flash_fwd(q, k, v, scale, causal, rotary_base=None):
    """K1: (out [B, H, L, D] in q's dtype, lse f32 [B, H, L]). Rotary on the
    card: q and k are rotated first (``rope_rotate``) and K1 runs on the
    copies."""
    if _on_cpu("flash_fwd", q):
        return flash_forward_ref(q, k, v, scale, causal, rotary_base)
    return _fwd(q, k, v, scale, causal, rotary_base)


def _fwd(q, k, v, scale, causal, rotary_base, qk=None):
    """K1 on CUDA tensors; ``qk``: q and k as the kernel reads them
    (``_rope_qk``), made here when not given. A call under ``rotary_base``
    counts as K1_rot."""
    B, H, G, L, D = _check("flash_fwd", q, k, {"q": q, "k": k, "v": v})
    out = _empty_like_heads(q, H)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    if qk is None:
        qk = _rope_qk(q, k, (0,), (0,), rotary_base)
    qkv = (*qk, *_bf16(v))
    _launch("hvd_flash_fwd", q,
            [t.data_ptr() for t in (*qkv, out, lse)] + [_fwd_maps(*qkv)],
            _strides(out), (B, H, G, L, D), scale, causal)
    _count(flash_fwd, rotary_base)
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, scale, causal, rotary_base=None):
    """K2: dq [B, H, L, D] in q's dtype. Rotary on the card: q and k are
    rotated first (``rope_rotate``), and K2_rot counter-rotates dQ."""
    if _on_cpu("flash_bwd_dq", q):
        return flash_bwd_dq_ref(q, k, v, dout, lse, delta, scale, causal,
                                rotary_base)
    return _bwd_dq(q, k, v, dout, lse, delta, scale, causal, rotary_base)


def _bwd_dq(q, k, v, dout, lse, delta, scale, causal, rotary_base, qk=None):
    """K2 on CUDA tensors; ``qk``: q and k as the kernel reads them
    (``_rope_qk``), made here when not given."""
    B, H, G, L, D = _check("flash_bwd_dq", q, k,
                           {"q": q, "k": k, "v": v, "dout": dout},
                           (("lse", lse), ("delta", delta)))
    dq = _empty_like_heads(q, H)
    if qk is None:
        qk = _rope_qk(q, k, (0,), (0,), rotary_base)
    qkvd = (*qk, *_bf16(v, dout))
    _launch("hvd_flash_bwd_dq", q,
            [t.data_ptr() for t in (*qkvd, lse, delta, dq)] +
            _rope_ptrs(L, D, rotary_base, q.device) +
            [_bwd_maps(*qkvd, dkv=False)],
            _strides(dq), (B, H, G, L, D), scale, causal)
    _count(flash_bwd_dq, rotary_base)
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, scale, causal,
                  rotary_base=None):
    """K3: (dk, dv) [B, G, L, D] in k's dtype, the GQA group summed in the
    kernel. Rotary on the card: q and k are rotated first
    (``rope_rotate``), and K3_rot counter-rotates dK."""
    if _on_cpu("flash_bwd_dkv", q):
        return flash_bwd_dkv_ref(q, k, v, dout, lse, delta, scale, causal,
                                 rotary_base)
    return _bwd_dkv(q, k, v, dout, lse, delta, scale, causal, rotary_base)


def _bwd_dkv(q, k, v, dout, lse, delta, scale, causal, rotary_base,
             qk=None):
    """K3 on CUDA tensors; ``qk`` as in ``_bwd_dq``."""
    B, H, G, L, D = _check("flash_bwd_dkv", q, k,
                           {"q": q, "k": k, "v": v, "dout": dout},
                           (("lse", lse), ("delta", delta)))
    dk = _empty_like_heads(k, G)
    dv = _empty_like_heads(k, G)
    if qk is None:
        qk = _rope_qk(q, k, (0,), (0,), rotary_base)
    qkvd = (*qk, *_bf16(v, dout))
    _launch("hvd_flash_bwd_dkv", q,
            [t.data_ptr() for t in (*qkvd, lse, delta, dk, dv)] +
            _rope_ptrs(L, D, rotary_base, q.device) +
            [_bwd_maps(*qkvd, dkv=True)],
            _strides(dk, dv), (B, H, G, L, D), scale, causal)
    _count(flash_bwd_dkv, rotary_base)
    return dk, dv


def _check_ring(what, q, k, tensors, rows=(), q_state=(), kv_state=()):
    """Validates a ring kernel's arguments; returns (B, H, G, Lq, Lk, D).
    q and dout are [B, H, Lq, D], k and v [B, G, Lk, D] (views with a
    contiguous last dim); ``rows`` are contiguous f32 [B, H, Lq]; the
    state and accumulators contiguous f32 [B, H, Lq, D] (``q_state``) or
    [B, G, Lk, D] (``kv_state``)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("%s: q and k must be [B, heads, L, D]" % what)
    B, H, Lq, D = q.shape
    G, Lk = k.shape[1], k.shape[2]
    if k.shape != (B, G, Lk, D) or G == 0 or H % G:
        raise ValueError("%s: k/v of shape %s do not fit q %s (kv heads "
                         "must divide query heads)"
                         % (what, tuple(k.shape), tuple(q.shape)))
    if Lk == 0:
        raise ValueError("%s: empty k/v %s" % (what, tuple(k.shape)))
    for name, t in tensors.items():
        want = (B, G, Lk, D) if name in ("k", "v") else (B, H, Lq, D)
        if t.shape != want:
            raise ValueError("%s: %s is %s, expected %s"
                             % (what, name, tuple(t.shape), want))
    # head dim, empty q, grid, dtypes, devices and layouts as K1-K3's
    _check(what, q, q, tensors)
    for name, t, shape in ([(n, t, (B, H, Lq)) for n, t in rows] +
                           [(n, t, (B, H, Lq, D)) for n, t in q_state] +
                           [(n, t, (B, G, Lk, D)) for n, t in kv_state]):
        if (t.device != q.device or t.dtype != torch.float32 or
                t.shape != shape or not t.is_contiguous()):
            raise ValueError("%s: %s must be contiguous float32 %s on %s"
                             % (what, name, list(shape), q.device))
    return B, H, G, Lq, Lk, D


def _positions_end(offset, L):
    """One past the last global position of a shard of length ``L``
    (``shard_chunks`` offsets): the rows its rotary tables need."""
    off0, off1, n = shard_chunks(offset, L)
    return off1 + L - n


def _ring_call(name, q, tensors, maps, dims, q_offset, kv_offset, scale,
               causal):
    """Launches ring step ``name`` on ``tensors`` (bf16 inputs, f32 rows
    and state) through ``maps``, with the shards' chunk offsets."""
    chunks = (ctypes.c_int * 6)(*shard_chunks(q_offset, dims[3]),
                                *shard_chunks(kv_offset, dims[4]))
    _call(name, q, *[t.data_ptr() for t in tensors], maps, *dims, chunks,
          float(scale), int(bool(causal)))


def flash_ring_step(q, k, v, o, m, l, q_offset, kv_offset, scale, causal,
                    rotary_base=None):
    """K4: one ring step of the online softmax. q [B, H, Lq, D], k/v
    [B, G, Lk, D] (bf16 or f32); the carried state o f32 [B, H, Lq, D]
    (un-normalised), m and l f32 [B, H, Lq] is updated IN PLACE and
    returned as (o, m, l). ``q_offset``/``kv_offset``: the shards' global
    chunk offsets (``shard_chunks``). Rotary on the card: q and k are
    rotated first (``rope_rotate``) and K4 runs on the copies; a ring that
    runs many steps rotates once and calls this without ``rotary_base``."""
    if _on_cpu("flash_ring_step", q):
        new = flash_ring_step_ref(q, k, v, o, m, l, q_offset, kv_offset,
                                  scale, causal, rotary_base)
        for t, n in zip((o, m, l), new):
            t.copy_(n)
        return o, m, l
    dims = _check_ring("flash_ring_step", q, k, {"q": q, "k": k, "v": v},
                       rows=(("m", m), ("l", l)), q_state=(("o", o),))
    qkv = (*_rope_qk(q, k, q_offset, kv_offset, rotary_base), *_bf16(v))
    _ring_call("hvd_flash_ring_fwd", q, (*qkv, o, m, l), _fwd_maps(*qkv),
               dims, q_offset, kv_offset, scale, causal)
    _count(flash_ring_step, rotary_base)
    return o, m, l


def flash_ring_bwd_dq(q, k, v, dout, lse, delta, dq, q_offset, kv_offset,
                      scale, causal, rotary_base=None):
    """K5: adds this step's dQ contribution to the f32 accumulator dq
    [B, H, Lq, D] IN PLACE and returns it (in rotated space under rotary).
    lse (the whole ring's, natural log) and delta = rowsum(dO * O) are f32
    [B, H, Lq]. Rotary on the card: q and k are rotated first
    (``rope_rotate``) and K5 runs on the copies; a ring that runs many
    steps rotates once and calls this without ``rotary_base``."""
    if _on_cpu("flash_ring_bwd_dq", q):
        return dq.copy_(flash_ring_bwd_dq_ref(q, k, v, dout, lse, delta, dq,
                                              q_offset, kv_offset, scale,
                                              causal, rotary_base))
    dims = _check_ring("flash_ring_bwd_dq", q, k,
                       {"q": q, "k": k, "v": v, "dout": dout},
                       rows=(("lse", lse), ("delta", delta)),
                       q_state=(("dq", dq),))
    qkvd = (*_rope_qk(q, k, q_offset, kv_offset, rotary_base),
            *_bf16(v, dout))
    maps = _bwd_maps(*qkvd, dkv=False)
    _ring_call("hvd_flash_ring_bwd_dq", q, (*qkvd, lse, delta, dq), maps,
               dims, q_offset, kv_offset, scale, causal)
    _count(flash_ring_bwd_dq, rotary_base)
    return dq


def flash_ring_bwd_dkv(q, k, v, dout, lse, delta, dk, dv, q_offset,
                       kv_offset, scale, causal, rotary_base=None):
    """K6: adds this step's dK, dV contribution (the GQA group summed in
    the kernel) to the f32 accumulators dk, dv [B, G, Lk, D] IN PLACE and
    returns them (dk in rotated space under rotary; q and k rotated first,
    as in K5)."""
    if _on_cpu("flash_ring_bwd_dkv", q):
        new = flash_ring_bwd_dkv_ref(q, k, v, dout, lse, delta, dk, dv,
                                     q_offset, kv_offset, scale, causal,
                                     rotary_base)
        return dk.copy_(new[0]), dv.copy_(new[1])
    dims = _check_ring("flash_ring_bwd_dkv", q, k,
                       {"q": q, "k": k, "v": v, "dout": dout},
                       rows=(("lse", lse), ("delta", delta)),
                       kv_state=(("dk", dk), ("dv", dv)))
    qkvd = (*_rope_qk(q, k, q_offset, kv_offset, rotary_base),
            *_bf16(v, dout))
    maps = _bwd_maps(*qkvd, dkv=True)
    _ring_call("hvd_flash_ring_bwd_dkv", q, (*qkvd, lse, delta, dk, dv),
               maps, dims, q_offset, kv_offset, scale, causal)
    _count(flash_ring_bwd_dkv, rotary_base)
    return dk, dv


KERNEL_WRAPPERS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, flash_ring_step,
                   flash_ring_bwd_dq, flash_ring_bwd_dkv)


def launch_counts():
    """{wrapper: launches}, {wrapper + "_rot": its launches with
    ``rotary_base``} and {"rope_rotate": launches of the rotary pass}."""
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    counts.update({fn.__name__ + "_rot": fn.rot_launches
                   for fn in KERNEL_WRAPPERS})
    counts["rope_rotate"] = rope_rotate.launches
    return counts


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = fn.rot_launches = 0
    rope_rotate.launches = 0


reset_launch_counts()


def _rotated(q, k, rotary_base):
    """q and k rotated once at 0..L-1 (``rope_rotate``: the pass on the
    card), or as they are without rotary."""
    if rotary_base is None:
        return q, k
    return (rope_rotate(q, (0,), rotary_base),
            rope_rotate(k, (0,), rotary_base))


def _forward(qr, kr, v, scale, causal, rotary_base):
    """K1 on q and k rotated already (``_rotated``): (out, lse). Under
    ``rotary_base`` the launch counts as K1_rot."""
    if _on_cpu("flash_fwd", qr):
        return flash_forward_ref(qr, kr, v, scale, causal)
    return _fwd(qr, kr, v, scale, causal, rotary_base, _bf16(qr, kr))


def _backward(qr, kr, v, out, lse, dout, scale, causal, rotary_base):
    """delta, then K2 and K3 on q and k rotated already (``_rotated``):
    (dq, dk, dv), dQ and dK counter-rotated under ``rotary_base``."""
    args = (qr, kr, v, dout, lse, _delta(out, dout), scale, causal,
            rotary_base)
    if _on_cpu("flash_backward", qr):
        return (_dq_ref(*args), *_dkv_ref(*args))
    qk = _bf16(qr, kr)
    return (_bwd_dq(*args, qk), *_bwd_dkv(*args, qk))


def flash_backward(q, k, v, out, lse, dout, scale, causal, rotary_base=None):
    """delta, then K2 and K3: (dq, dk, dv). Rotary: q and k are rotated once
    (``rope_rotate``, one pass each on the card) and both kernels read the
    copies."""
    return _backward(*_rotated(q, k, rotary_base), v, out, lse, dout, scale,
                     causal, rotary_base)


class _FlashFn(torch.autograd.Function):
    """Attention over [B, H, L, D] with the flash backward, which recomputes
    P from lse. Under rotary the forward rotates q and k once and saves the
    rotated copies in their place, (q_rot, k_rot, v, out, lse): the
    backward rotates nothing."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, rotary_base):
        qr, kr = _rotated(q, k, rotary_base)
        out, lse = _forward(qr, kr, v, scale, causal, rotary_base)
        ctx.save_for_backward(qr, kr, v, out, lse)
        ctx.args = (scale, causal, rotary_base)
        return out

    @staticmethod
    def backward(ctx, g):
        qr, kr, v, out, lse = ctx.saved_tensors
        if g.is_cuda:
            g = _kernel_layout(g)
        dq, dk, dv = _backward(qr, kr, v, out, lse, g, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, scale=None, rotary_base=None):
    """Flash attention over [B, L, H, D] inputs; returns [B, L, H, D] in
    q's dtype. GQA/MQA: k/v may carry G heads with G | H, and query head h
    attends through kv head h // (H // G). ``scale`` defaults to
    D ** -0.5. On CUDA tensors the products take bf16 inputs even when q
    is float32 (see the module docstring).

    ``rotary_base`` fuses rotary position embedding into the kernels at
    positions 0..L-1 (do not also rotate outside); sequences whose
    positions are not 0..L-1 (packing, shifted windows) rotate outside with
    ``apply_rotary`` instead, as in the JAX package."""
    B, L, H, D = q.shape
    G = k.shape[2]
    if H % G:
        raise ValueError("num_heads=%d must be a multiple of num_kv_heads=%d"
                         % (H, G))
    if scale is None:
        scale = D ** -0.5
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.is_cuda:
        qt, kt, vt = (_kernel_layout(x) for x in (qt, kt, vt))
    return _FlashFn.apply(qt, kt, vt, scale, causal,
                          rotary_base).transpose(1, 2)
