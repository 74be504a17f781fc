"""BatchNorm on hand-written Hopper kernels, and their plain PyTorch
versions.

Counterpart of ``horovod_tpu/ops/batch_norm.py``: the Pallas path
(``batch_norm_stats``, ``batch_norm_grad_stats``, ``fused_batch_norm_train``
and ``PallasBatchNorm``) and the traffic-lean path (``lean_batch_norm_train``
and ``LeanBatchNorm``, with ghost BN). Four kernels, in
``csrc/batch_norm.cu``:

- K7 ``batch_norm_stats``: per (group, channel) (sum x, sum x^2) of a
  (M, C) activation; ``batch_norm_stats_terms`` is the same launch with
  the forward's per-channel terms (mean, var, rstd, a = gamma * rstd, b =
  beta - mean * a) formed from the sums on the device;
- K8 ``batch_norm_grad_stats``: per (group, channel) (sum dy, sum dy *
  x_hat), i.e. (dbeta, dgamma), optionally under the ReLU mask;
- ``bn_apply``: the normalize pass, y = x * a + b, optionally max(y, 0);
- ``bn_dx``: the dx pass of the BN backward, optionally under the ReLU mask.

Every kernel is one launch a call. The statistics read their operands
once (bf16 or f32), accumulate in f32 and return f32 sums, reduced across
blocks in a fixed order by the last block of each column tile (no float
atomics), so the same input gives bit-identical statistics; their scratch
(the blocks' partial sums and the tiles' counters, which each call leaves
at 0) is kept for each (device, stream). K7's terms equal the torch
operations of ``batch_norm_stats_terms_ref`` on K7's sums bit for bit.
The two passes are elementwise, in one of two arithmetic modes:
``"pallas"`` computes in f32 and rounds once to x's dtype
(``_FusedBatchNormFn``), ``"lean"`` rounds every operation to x's dtype
(the lean path's bf16 ops). Each pass equals its plain version bit for
bit: the kernel takes the raw per-channel vectors and forms the terms
itself with the plain version's own f32 operations (the divisions by the
row count as products with its f32 reciprocal, which the wrapper hands to
both), rounds them to x's dtype in lean mode as ``.to(dtype)`` does, and
rounds each product and sum apart (no FMA). Rows split into
``groups`` ghost groups of M / groups contiguous rows: a channels-last
activation keeps its batch axis outermost, so a ghost batch is a block of
rows. Every kernel masks both ragged tails, so every M >= 1 and C >= 1 is
taken.

Each wrapper dispatches on where its input lies: a CPU tensor goes to the
plain version, a CUDA tensor launches the kernel or raises. The (M, C)
inputs must be contiguous: a ``channels_last`` [N, C, H, W] activation is
physically NHWC, and ``x.movedim(1, -1).view(-1, C)`` is then a view the
kernels read in place. Nothing is copied to make an input contiguous. Each
wrapper counts its launches in ``.launches``, and those with the ReLU or
mask also in ``.relu_launches``.

``StockBatchNorm`` is the same module on ``F.batch_norm`` (cuDNN on the
GPU), the counterpart of flax's ``nn.BatchNorm``: no kernel of the port;
its sync BN (``group=``) is ``stock_sync_batch_norm_train``, plain torch
math around one collective each way.

``bn_apply`` and ``bn_dx`` are also registered as ``torch.library`` custom
ops (``torch.ops.horovod_tpu_torch.bn_apply`` and ``.bn_dx``), so the
dispatcher sees them; ``bn_remat`` recomputes normalize outputs through
them (``lean_batch_norm_conv``).
"""

import ctypes
import functools
import struct
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.common.ops import raise_peer_loss
from horovod_tpu_torch.groups import resolve_group
from horovod_tpu_torch.ops import _build

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
MODES = ("pallas", "lean")
_THREADS = 256          # threads of a block (csrc/batch_norm.cu)
_SMS = 132              # the SMs of an H100
# The statistics (csrc's bn_stats_kernel): one column tile for C up to
# _STATS_ONE_TILE channels (the kernel takes up to 128), else tiles of
# _STATS_TILE; each group split so that the blocks are a whole multiple of
# _SMS, at least one each where the rows allow it, with at least four
# times the rows a thread keeps in flight between those (K7 8, K8 4:
# _STATS_ROWS), and at most _STATS_BLOCKS in all: one wave at two
# resident blocks an SM (K8's registers allow two), which also bounds the
# last block's serial read of a tile's splits * 2 * tile partial sums.
# Fixed numbers, not read from the device, so every card and every rank
# splits (and so rounds) alike.
_STATS_ONE_TILE = 80
_STATS_TILE = 64
_STATS_ROWS = {"K7": 32, "K8": 16}
_STATS_BLOCKS = 264
# The passes (csrc's pass_shape and split_rows): a tile of at most
# _PASS_TILE channels a block; each group split so that the blocks are a
# whole multiple of _SMS, at least one each where the rows allow it, at
# most _PASS_BLOCKS, with at least _PASS_ROWS rows a thread between those
# (the passes' output does not depend on the split, but every rank
# launches alike).
_PASS_TILE = 1024
_PASS_BLOCKS = 1056
_PASS_ROWS = 16

_bound = {}


# ---------------------------------------------------------------- plain


def _split(t, groups):
    """(M, C) -> the (G, M / G, C) view of its ghost groups; the tensor
    itself for groups == 1."""
    return t if groups == 1 else t.view(groups, -1, t.shape[-1])


def _per_group(t, groups):
    """A per-(group, channel) term, (C,) or (G, C), shaped to broadcast
    over _split's view."""
    return t if groups == 1 or t.dim() == 1 else t.unsqueeze(1)


def _masked(dy, x, mean, rstd, gamma, beta, mode):
    """x_hat = (x - mean) * rstd and the dy that counts (0 where the
    pre-activation x_hat * gamma + beta is not > 0, with gamma given), in
    the mode's arithmetic: f32 (``_bn_train_bwd``) or x's dtype
    (``_lean_bwd:381-386``). Also returns x - mean."""
    if mode == "pallas":
        xm = x.float() - mean
        xhat = xm * rstd
        g = dy.float()
        if gamma is not None:
            g = torch.where(xhat * gamma + beta > 0, g, 0.0)
    else:
        dt = x.dtype
        xm = x - mean.to(dt)
        xhat = xm * rstd.to(dt)
        g = dy.to(dt)
        if gamma is not None:
            pre = xhat * gamma.to(dt) + beta.to(dt)
            g = torch.where(pre > 0, g, torch.zeros((), dtype=dt))
    return xm, xhat, g


def batch_norm_stats_ref(x2d, groups=1):
    """Plain version of K7 in f32: (sum x, sum x^2) over the rows, (C,)
    each, or (G, C) over each of ``groups`` row blocks."""
    xf = _split(x2d, groups).float()
    axis = 0 if groups == 1 else 1
    return xf.sum(axis), (xf * xf).sum(axis)


def _terms_of_sums(s, ss, count, gamma, beta, eps):
    """The forward's per-(group, channel) terms from the sums over
    ``count`` rows, in torch ops (``_bn_train_fwd:205-209``, ``_lean_fwd
    :356-360``): (mean, var, rstd, a, b)."""
    mean = s / count
    var = torch.clamp(ss / count - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    a = gamma * rstd
    b = beta - mean * a
    return mean, var, rstd, a, b


def batch_norm_stats_terms_ref(x2d, gamma, beta, eps, groups=1):
    """Plain version of K7 with the forward's terms: ``batch_norm_stats_ref``
    and the torch ops of ``_terms_of_sums``; (mean, var, rstd, a, b), f32
    (C,) each, or (G, C) over ``groups`` row blocks."""
    return _terms_of_sums(*batch_norm_stats_ref(x2d, groups),
                          x2d.shape[0] // groups, gamma, beta, eps)


def batch_norm_grad_stats_ref(dy2d, x2d, mean, rstd, groups=1, gamma=None,
                              beta=None, mode="pallas"):
    """Plain version of K8 in f32: (sum dy, sum dy * (x - mean) * rstd) over
    the rows of each group, dy 0 where the ReLU mask (``gamma``, ``beta``
    given) is off; x_hat and the mask in the mode's arithmetic, the sums
    f32."""
    _, xhat, g = _masked(_split(dy2d, groups), _split(x2d, groups),
                         _per_group(mean, groups), _per_group(rstd, groups),
                         gamma, beta, mode)
    gf = g.float()
    axis = 0 if groups == 1 else 1
    return gf.sum(axis), (gf * xhat.float()).sum(axis)


def bn_apply_ref(x2d, a, b, groups=1, relu=False, mode="pallas"):
    """Plain version of the normalize pass: y = x * a + b per (group,
    channel), max(y, 0) with ``relu``, in x's dtype. ``"pallas"``:
    ``_bn_train_fwd:211``, f32 then one rounding; ``"lean"``:
    ``_lean_fwd:363-365``, a and b rounded to x's dtype and each operation
    in it."""
    x = _split(x2d, groups)
    a, b = _per_group(a, groups), _per_group(b, groups)
    if mode == "pallas":
        y = x.float() * a + b
        if relu:
            y = torch.relu(y)
        y = y.to(x2d.dtype)
    else:
        dt = x2d.dtype
        y = x * a.to(dt) + b.to(dt)
        if relu:
            y = torch.relu(y)
    return y.view(x2d.shape)


def _f32(v):
    """v rounded to the nearest float32, as a Python float."""
    return struct.unpack("f", struct.pack("f", v))[0]


@functools.lru_cache(maxsize=256)
def count_scales(count):
    """(1 / count, 2 / count) as float32 scalars: the factors of the dx
    pass's divisions by the row count. The first is ATen's on CUDA for a
    tensor divided by a Python number (``BinaryDivTrueKernel.cu``
    multiplies by ``1.0f / count``; XLA multiplies by the reciprocal too),
    the second the f32 value of the double ``2.0 / count`` (``gvar * (2.0 /
    count)`` in ``_bn_train_bwd`` and ``_lean_bwd``). Dividing the
    float32 count in double and rounding once to float32 is the float32
    quotient: double holds more than twice float32's 24 bits."""
    return _f32(1.0 / _f32(count)), _f32(2.0 / count)


def _dx_terms(mean, rstd, gamma, beta, dbeta, dgamma, count, gmean, gvar):
    """The per-(group, channel) terms of the dx pass in f32 ({name: tensor
    or None}): k = gamma * rstd, c1 = dbeta * (1 / count), c2 = dgamma *
    (1 / count), c3 = gmean * (1 / count), c4 = gvar * (2 / count), with
    ``count_scales``' f32 factors, and mean, rstd, gamma, beta. The kernel
    forms the same values from the raw vectors; the plain version
    broadcasts these (in lean mode both round them to x's dtype first, as
    ``_lean_bwd:399-409``)."""
    inv, two = count_scales(count)
    return dict(mean=mean, rstd=rstd, k=gamma * rstd, c1=dbeta * inv,
                c2=dgamma * inv, gamma=gamma, beta=beta,
                c3=None if gmean is None else gmean * inv,
                c4=None if gvar is None else gvar * two)


def bn_dx_ref(dy2d, x2d, mean, rstd, gamma, beta, dbeta, dgamma, count,
              groups=1, relu=False, mode="pallas", gmean=None, gvar=None):
    """Plain version of the dx pass: dx = gamma * rstd * (dy - dbeta / count
    - x_hat * dgamma / count), plus gmean / count + gvar * 2 / count * (x -
    mean) for the mean and var cotangents that are given, dy masked as K8's
    with ``relu`` (then ``beta`` is needed); each division a product with
    the f32 factor of ``count_scales``. ``dbeta`` and ``dgamma`` are the
    sums over the ``count`` rows of each group (over the sync group too).
    ``"pallas"``: ``_bn_train_bwd:237-242`` in f32, one rounding;
    ``"lean"``: ``_lean_bwd:381-409``, each operation in x's dtype."""
    t = _dx_terms(mean, rstd, gamma, beta, dbeta, dgamma, count, gmean, gvar)
    dt = x2d.dtype if mode == "lean" else torch.float32
    t = {k: None if v is None else _per_group(v.to(dt), groups)
         for k, v in t.items()}
    xm, xhat, g = _masked(_split(dy2d, groups), _split(x2d, groups),
                          t["mean"], t["rstd"],
                          t["gamma"] if relu else None, t["beta"], mode)
    dx = t["k"] * (g - t["c1"] - xhat * t["c2"])
    if gmean is not None:
        dx = dx + t["c3"]
    if gvar is not None:
        dx = dx + t["c4"] * xm
    return dx.to(x2d.dtype).view(x2d.shape)


# --------------------------------------------------------------- kernels


# Each entry point takes one packed block of 8-byte fields
# (csrc/batch_norm.cu): the output, the inputs and their dtypes, the flags,
# M, C, groups, vec, the plan, the stream (and for the statistics their
# scratch), then a (pointer, group stride, channel stride) triple for each
# per-(group, channel) f32 input, and the f32 scalars as doubles. One
# struct.pack and one ctypes argument a call.
_STATS_ARGS = struct.Struct("<18q2d")   # K7: gamma, beta; 1 / count, eps
_GRAD_ARGS = struct.Struct("<27q")      # K8: mean, rstd, gamma, beta
_APPLY_ARGS = struct.Struct("<17q")     # a, b
_DX_ARGS = struct.Struct("<37q2d")      # 8 terms; 1 / count, 2 / count
_NO_TERM = (0, 0, 0)


def _entry(name):
    """(library, C function) of an entry point, built and bound once."""
    if name not in _bound:
        lib = _build.library("batch_norm")
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _bound[name] = (lib, fn)
    return _bound[name]


def _on_cpu(what, t):
    """True for CPU tensors (the plain version runs); False for CUDA
    tensors (the kernel runs); raises for any other device."""
    if t.is_cpu:
        return True
    if not t.is_cuda:
        raise ValueError("%s: tensors on %s; the kernels run on CUDA and the "
                         "plain version on the CPU" % (what, t.device))
    return False


def _check_rows(what, name, t, like=None):
    """Raises unless ``t`` is a non-empty contiguous (M, C) bf16 or f32
    tensor, of ``like``'s shape and on its device when ``like`` is given;
    returns (its shape, its data pointer)."""
    size = t.shape
    if len(size) != 2 or size[0] < 1 or size[1] < 1:
        raise ValueError("%s: %s must be a non-empty (M, C) tensor, got %s"
                         % (what, name, tuple(size)))
    if like is not None and size != like.shape:
        raise ValueError("%s: %s is %s, x is %s"
                         % (what, name, tuple(size), tuple(like.shape)))
    if like is not None and t.get_device() != like.get_device():
        raise ValueError("%s: %s is on %s, x on %s"
                         % (what, name, t.device, like.device))
    if t.dtype not in _DTYPES:
        raise TypeError("%s: %s is %s; the kernels take bfloat16 or float32"
                        % (what, name, t.dtype))
    if not t.is_contiguous():
        raise ValueError(
            "%s: %s must be a contiguous (M, C) view (a channels_last "
            "activation as x.movedim(1, -1).view(-1, C)); got strides %s"
            % (what, name, tuple(t.stride())))
    return size, t.data_ptr()


def _check_args(what, x2d, groups, mode):
    if mode not in MODES:
        raise ValueError("%s: mode %r is not one of %s" % (what, mode, MODES))
    if groups < 1 or x2d.shape[0] % groups:
        raise ValueError("%s: groups=%d does not divide the %d rows"
                         % (what, groups, x2d.shape[0]))


def _pass_term(what, name, t, index, groups, C):
    """(pointer, group stride, channel stride) of a per-(group, channel)
    f32 input of a kernel, (C,) (group stride 0: one vector for every
    group) or (groups, C), any strides, on CUDA device ``index``; (0, 0, 0)
    for None. Raises on a wrong shape, device or dtype."""
    if t is None:
        return _NO_TERM
    size, strides = t.shape, t.stride()
    if len(size) == 1:
        ok, gs, cs = size[0] == C, 0, strides[0]
    else:
        ok, gs, cs = size == (groups, C), strides[0], strides[-1]
    if not ok or t.get_device() != index:
        raise ValueError("%s: %s must be (%d,) or (%d, %d) on cuda:%d, got "
                         "%s on %s" % (what, name, C, groups, C, index,
                                       tuple(size), t.device))
    if t.dtype is not torch.float32:
        raise TypeError("%s: %s is %s; the kernels take float32 terms"
                        % (what, name, t.dtype))
    return t.data_ptr(), gs, cs


@functools.lru_cache(maxsize=1024)
def _stats_plan(Mg, C, vec, groups, kernel):
    """(tx, column tiles, splits, stride) of ``kernel`` ("K7" or "K8")
    over ``groups`` groups of Mg rows, from these alone: one tile of C
    channels up to _STATS_ONE_TILE, else tiles of _STATS_TILE (tx threads
    along C, ty = 256 // tx along M); blocks of at least
    _STATS_ROWS[kernel] rows a thread, a whole multiple of _SMS (fewer by
    what a split of every group and tile leaves over), at least _SMS while
    each thread keeps a row, at most _STATS_BLOCKS (or one split a group);
    each block's scratch row of stride f32 (2 * tile rounded up to 4)."""
    tc = -(-C // vec)
    tx = tc if tc * vec <= _STATS_ONE_TILE else _STATS_TILE // vec
    tiles = -(-tc // tx)
    ty = _THREADS // tx
    per = tiles * groups  # blocks for each split of the groups
    blocks = Mg // (ty * _STATS_ROWS[kernel]) * per // _SMS * _SMS
    blocks = max(min(blocks, _STATS_BLOCKS), _SMS)
    # rounded down: a 133rd block would double one SM's share of the rows
    splits = max(1, min(blocks // per, Mg // ty))
    return tx, tiles, splits, -(-2 * tx * vec // 4) * 4


# (device index, stream) -> [scratch, tickets, floats, pointer]: the
# statistics' tickets (u32, each 0 between calls) and partial sums (f32)
_scratch = {}
# scratch that grew out of use, kept alive: a captured CUDA graph may
# still launch on it
_retired = []
# (device index, *shape) -> an f32 tensor of the statistics' output shape
_out_like = {}


def _scratch_of(what, index, stream, tickets, floats):
    """(tickets pointer, partials pointer) of the (device, stream)'s
    scratch, which holds at least ``tickets`` counters and ``floats``
    partial sums; made (zeroed once) or grown outside CUDA graph capture
    only."""
    have = _scratch.get((index, stream))
    if have is None or have[1] < tickets or have[2] < floats:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "%s: the statistics' scratch of this stream is missing or too "
                "small in a CUDA graph capture; call the kernel once on the "
                "capturing stream, at this shape, before the capture" % what)
        if have is not None:
            _retired.append(have[0])
        t = 1 << max(10, (tickets - 1).bit_length())
        f = 1 << max(16, (floats - 1).bit_length())
        buf = torch.zeros(t + f, dtype=torch.int32, device=index)
        have = [buf, t, f, buf.data_ptr()]
        _scratch[(index, stream)] = have
    return have[3], have[3] + 4 * have[1]


def _pass_shape(C, vec):
    """(column tiles, tx, ty) of csrc's pass_shape: tx threads along C, VEC
    channels each and at most _PASS_TILE channels a tile, by ty = 256 / tx
    along M."""
    tc = -(-C // vec)
    tx = min(tc, _PASS_TILE // vec, _THREADS)
    return -(-tc // tx), tx, _THREADS // tx


@functools.lru_cache(maxsize=1024)
def _pass_plan(Mg, C, vec, groups):
    """Row splits of each group for the passes, from (Mg, C, vec, groups)
    alone: blocks of at least _PASS_ROWS rows a thread, at most
    _PASS_BLOCKS of them, in whole multiples of _SMS (every SM the same
    share of rows), and at least _SMS while each thread keeps a row."""
    col_tiles, _, ty = _pass_shape(C, vec)
    per = col_tiles * groups  # blocks for each split of the groups
    blocks = min(Mg // (ty * _PASS_ROWS) * per, _PASS_BLOCKS)
    blocks = max(blocks // _SMS * _SMS, _SMS)
    return max(1, min(-(-blocks // per), Mg // ty))


def _launch(name, args, index):
    """One ctypes call of the entry point ``name`` with its packed
    arguments, switching the current device only when x's (``index``) is
    not."""
    lib, fn = _entry(name)
    if index == torch._C._cuda_getDevice():
        err = fn(args)
    else:
        with torch.cuda.device(index):
            err = fn(args)
    _build.check(lib, err, name)


def _stats_fields(what, x2d, M, C, groups, vec, kernel, planes):
    """The statistics' output (f32 [planes, C], or [planes, groups, C]) on
    x's device and the packed fields from M to the tickets pointer: the
    plan, the stream, the (device, stream)'s scratch."""
    index = x2d.get_device()
    tx, tiles, splits, stride = _stats_plan(M // groups, C, vec, groups,
                                            kernel)
    stream = torch._C._cuda_getCurrentRawStream(index)
    tickets, ws = _scratch_of(what, index, stream, groups * tiles,
                              groups * tiles * splits * stride)
    shape = (index, planes, C) if groups == 1 else (index, planes, groups, C)
    like = _out_like.get(shape)
    if like is None:  # empty_like of a kept tensor is the cheapest alloc
        like = _out_like[shape] = x2d.new_empty(shape[1:],
                                                dtype=torch.float32)
    out = torch.empty_like(like)
    return out, index, (M, C, groups, vec, tx, splits, stream, ws, tickets)


def _k7(what, x2d, groups, gamma=None, beta=None, eps=0.0):
    """One K7 launch: the (2, ...) sums, or with gamma and beta the (5, ...)
    terms, as views; counted in ``batch_norm_stats.launches``."""
    (M, C), xp = _check_rows(what, "x", x2d)
    _check_args(what, x2d, groups, "pallas")
    vec = 8 if C % 8 == 0 and not xp & 15 else 1
    out, index, fields = _stats_fields(what, x2d, M, C, groups, vec, "K7",
                                       2 if gamma is None else 5)
    _launch("hvd_bn_stats", _STATS_ARGS.pack(
        out.data_ptr(), xp, _DTYPES[x2d.dtype], *fields,
        *_pass_term(what, "gamma", gamma, index, groups, C),
        *_pass_term(what, "beta", beta, index, groups, C),
        count_scales(M // groups)[0], eps), index)
    batch_norm_stats.launches += 1
    return out.unbind(0)


def batch_norm_stats(x2d, groups=1):
    """K7: (sum x, sum x^2) over the rows of a (M, C) tensor, two (C,) f32
    tensors; with ``groups`` > 1 over each of that many blocks of M /
    groups rows, two (G, C) tensors. Both are contiguous views of one
    buffer."""
    what = "batch_norm_stats"
    if _on_cpu(what, x2d):
        return batch_norm_stats_ref(x2d, groups)
    return _k7(what, x2d, groups)


def batch_norm_stats_terms(x2d, gamma, beta, eps, groups=1):
    """K7 with the forward's per-(group, channel) terms: (mean, var, rstd,
    a, b), f32 (C,) each, or (G, C) over ``groups`` row blocks, contiguous
    views of one [5, G, C] buffer; bit for bit the torch ops of
    ``batch_norm_stats_terms_ref`` on K7's sums. gamma and beta are f32
    (C,) or (G, C). One K7 launch (``batch_norm_stats.launches``)."""
    what = "batch_norm_stats_terms"
    if _on_cpu(what, x2d):
        return batch_norm_stats_terms_ref(x2d, gamma, beta, eps, groups)
    return _k7(what, x2d, groups, gamma, beta, eps)


def batch_norm_grad_stats(dy2d, x2d, mean, rstd, groups=1, gamma=None,
                          beta=None, mode="pallas"):
    """K8: (sum dy, sum dy * (x - mean) * rstd) over the rows, i.e. (dbeta,
    dgamma), two (C,) f32 tensors, or (G, C) over ``groups`` row blocks,
    contiguous views of one buffer. dy and x are (M, C), bf16 or f32 each
    (f32 dy with bf16 x is allowed); mean and rstd are f32 (C,) or (G, C),
    any strides. With ``gamma`` and ``beta`` dy counts only where x_hat *
    gamma + beta > 0 (the fused ReLU's mask). ``mode`` is the arithmetic of
    x_hat and the mask, as in ``bn_dx``."""
    what = "batch_norm_grad_stats"
    if (gamma is None) != (beta is None):
        raise ValueError("%s: the ReLU mask needs gamma and beta" % what)
    if _on_cpu(what, x2d):
        return batch_norm_grad_stats_ref(dy2d, x2d, mean, rstd, groups,
                                         gamma, beta, mode)
    (M, C), xp = _check_rows(what, "x", x2d)
    _, dyp = _check_rows(what, "dy", dy2d, x2d)
    _check_args(what, x2d, groups, mode)
    vec = 8 if C % 8 == 0 and not (xp | dyp) & 15 else 1
    out, index, fields = _stats_fields(what, x2d, M, C, groups, vec, "K8",
                                       2)
    _launch("hvd_bn_grad_stats", _GRAD_ARGS.pack(
        out.data_ptr(), dyp, _DTYPES[dy2d.dtype], xp, _DTYPES[x2d.dtype],
        mode == "lean", *fields,
        *_pass_term(what, "mean", mean, index, groups, C),
        *_pass_term(what, "rstd", rstd, index, groups, C),
        *_pass_term(what, "gamma", gamma, index, groups, C),
        *_pass_term(what, "beta", beta, index, groups, C)), index)
    batch_norm_grad_stats.launches += 1
    batch_norm_grad_stats.relu_launches += gamma is not None
    return out.unbind(0)


def bn_apply(x2d, a, b, groups=1, relu=False, mode="pallas"):
    """The normalize pass: y = x * a + b per (group, channel), max(y, 0)
    with ``relu``, a new (M, C) tensor in x's dtype. a and b are f32 (C,) or
    (G, C) with ``groups`` row blocks; ``mode`` is ``bn_apply_ref``'s. On
    CUDA one launch, and no torch op but the output's allocation."""
    what = "bn_apply"
    if _on_cpu(what, x2d):
        return bn_apply_ref(x2d, a, b, groups, relu, mode)
    (M, C), xp = _check_rows(what, "x", x2d)
    _check_args(what, x2d, groups, mode)
    index = x2d.get_device()
    y = torch.empty_like(x2d)
    yp = y.data_ptr()
    vec = 8 if C % 8 == 0 and not (xp | yp) & 15 else 1
    _launch("hvd_bn_apply", _APPLY_ARGS.pack(
        yp, xp, _DTYPES[x2d.dtype], mode == "lean", bool(relu), M, C,
        groups, vec, _pass_plan(M // groups, C, vec, groups),
        torch._C._cuda_getCurrentRawStream(index),
        *_pass_term(what, "a", a, index, groups, C),
        *_pass_term(what, "b", b, index, groups, C)), index)
    bn_apply.launches += 1
    bn_apply.relu_launches += bool(relu)
    return y


def bn_dx(dy2d, x2d, mean, rstd, gamma, beta, dbeta, dgamma, count,
          groups=1, relu=False, mode="pallas", gmean=None, gvar=None):
    """The dx pass of the BN backward: ``bn_dx_ref``'s dx, a new (M, C)
    tensor in x's dtype. dy and x are (M, C) (f32 dy with bf16 x is
    allowed); mean, rstd, dbeta, dgamma (and gmean, gvar) f32 (C,) or (G,
    C); gamma (and beta, needed with ``relu``) f32 (C,). On CUDA one launch,
    and no torch op but the output's allocation: the kernel forms the terms
    from these raw vectors and ``count_scales(count)``."""
    what = "bn_dx"
    if relu and beta is None:
        raise ValueError("%s: the ReLU mask needs beta" % what)
    if _on_cpu(what, x2d):
        return bn_dx_ref(dy2d, x2d, mean, rstd, gamma, beta, dbeta, dgamma,
                         count, groups, relu, mode, gmean, gvar)
    (M, C), xp = _check_rows(what, "x", x2d)
    _, dyp = _check_rows(what, "dy", dy2d, x2d)
    _check_args(what, x2d, groups, mode)
    index = x2d.get_device()
    dx = torch.empty_like(x2d)
    dxp = dx.data_ptr()
    vec = 8 if C % 8 == 0 and not (xp | dyp | dxp) & 15 else 1
    _launch("hvd_bn_dx", _DX_ARGS.pack(
        dxp, dyp, _DTYPES[dy2d.dtype], xp, _DTYPES[x2d.dtype],
        mode == "lean", bool(relu), M, C, groups, vec,
        _pass_plan(M // groups, C, vec, groups),
        torch._C._cuda_getCurrentRawStream(index),
        *_pass_term(what, "mean", mean, index, groups, C),
        *_pass_term(what, "rstd", rstd, index, groups, C),
        *_pass_term(what, "gamma", gamma, index, groups, C),
        *_pass_term(what, "beta", beta if relu else None, index, groups, C),
        *_pass_term(what, "dbeta", dbeta, index, groups, C),
        *_pass_term(what, "dgamma", dgamma, index, groups, C),
        *_pass_term(what, "gmean", gmean, index, groups, C),
        *_pass_term(what, "gvar", gvar, index, groups, C),
        *count_scales(count)), index)
    bn_dx.launches += 1
    bn_dx.relu_launches += bool(relu)
    return dx


KERNEL_WRAPPERS = (batch_norm_stats, batch_norm_grad_stats, bn_apply, bn_dx)
# the wrappers whose ReLU (or mask) launches are also counted apart
_RELU_WRAPPERS = (batch_norm_grad_stats, bn_apply, bn_dx)


def launch_counts():
    """{wrapper: launches}, and {wrapper_relu: launches with the ReLU or
    mask} (a part of the wrapper's own count)."""
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    counts.update((fn.__name__ + "_relu", fn.relu_launches)
                  for fn in _RELU_WRAPPERS)
    return counts


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn in _RELU_WRAPPERS:
        fn.relu_launches = 0


reset_launch_counts()


@torch.library.custom_op("horovod_tpu_torch::bn_apply", mutates_args=())
def bn_apply_op(x2d: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                groups: int, relu: bool, mode: str) -> torch.Tensor:
    """``bn_apply`` as a custom op of the dispatcher."""
    return bn_apply(x2d, a, b, groups, relu, mode)


@bn_apply_op.register_fake
def _(x2d, a, b, groups, relu, mode):
    return torch.empty_like(x2d)


@torch.library.custom_op("horovod_tpu_torch::bn_dx", mutates_args=())
def bn_dx_op(dy2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
             rstd: torch.Tensor, gamma: torch.Tensor,
             beta: Optional[torch.Tensor], dbeta: torch.Tensor,
             dgamma: torch.Tensor, count: int, groups: int, relu: bool,
             mode: str, gmean: Optional[torch.Tensor],
             gvar: Optional[torch.Tensor]) -> torch.Tensor:
    """``bn_dx`` as a custom op of the dispatcher."""
    return bn_dx(dy2d, x2d, mean, rstd, gamma, beta, dbeta, dgamma, count,
                 groups, relu, mode, gmean, gvar)


@bn_dx_op.register_fake
def _(dy2d, x2d, *args):
    return torch.empty_like(x2d)


# ----------------------------------------------------- training-mode BN


@raise_peer_loss
def _group_sum(pair, group):
    """(a, b) summed over ``group`` (a ``ProcessGroup``, WORLD or a
    ``torch.distributed`` process group) in one collective of the stacked
    pair, and the group's size; (a, b) and 1 without a group."""
    if group is None:
        return pair, 1
    group = resolve_group(group)
    stacked = torch.stack(pair)
    dist.all_reduce(stacked, op=dist.ReduceOp.SUM, group=group)
    return (stacked[0], stacked[1]), dist.get_world_size(group)


def _batch_stats(x2d, gamma, beta, eps, groups, group):
    """K7 and the terms of ``_bn_train_fwd``/``_lean_fwd``: (mean, var,
    rstd, a, b, the rows each statistic covers), f32 (C,) or (G, C).
    Without a sync group one launch forms them all; with one the sums
    cross its ranks first and the terms are torch ops."""
    count = x2d.shape[0] // groups
    if group is None:
        return batch_norm_stats_terms(x2d, gamma, beta, eps, groups) + (
            count,)
    (s, ss), n = _group_sum(batch_norm_stats(x2d, groups), group)
    count *= n  # equal shards, as psum(1)
    return _terms_of_sums(s, ss, count, gamma, beta, eps) + (count,)


class _FusedBatchNormFn(torch.autograd.Function):
    """Training-mode BN over (M, C): K7 and the normalize pass in the
    forward, K8 and the dx pass in the backward, both passes in f32."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps, group):
        mean, var, rstd, a, b, _ = _batch_stats(x2d, gamma, beta, eps, 1,
                                                group)
        y = bn_apply(x2d, a, b)
        ctx.save_for_backward(x2d, gamma, mean, rstd)
        ctx.group = group
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x2d, gamma, mean, rstd = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(x2d)
        dbeta, dgamma = batch_norm_grad_stats(gy, x2d, mean, rstd)
        # dx needs the sums over the whole sync group; the returned dgamma
        # and dbeta stay local, and the gradient allreduce completes them.
        (dbeta_g, dgamma_g), n = _group_sum((dbeta, dgamma), ctx.group)
        dx = bn_dx(gy, x2d, mean, rstd, gamma, None, dbeta_g, dgamma_g,
                   x2d.shape[0] * n, gmean=gmean, gvar=gvar)
        return dx, dgamma, dbeta, None, None


def fused_batch_norm_train(x2d, gamma, beta, eps=1e-5, group=None):
    """Training-mode BN over a (M, C) activation: returns (y in x's dtype,
    mean, var), the batch statistics f32 with the biased variance. K7 and
    the normalize pass run in the forward, K8 and the dx pass in the
    backward. ``group`` (a ``torch.distributed`` process group, the
    counterpart of ``axis_name``) is sync BN: the statistics are summed
    over the group's ranks, each holding an equal shard."""
    return _FusedBatchNormFn.apply(x2d, gamma, beta, eps, group)


class _LeanBatchNormFn(torch.autograd.Function):
    """``_lean_fwd``/``_lean_bwd``: K7, then the normalize pass in lean mode
    with the ReLU folded in; saves (x, mean, rstd) and the parameters;
    the backward recomputes x_hat and the ReLU mask in K8 and the dx pass,
    both in lean mode."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, relu, groups, group):
        C = x.shape[-1]
        x2d = x.view(-1, C)
        mean, var, rstd, a, b, count = _batch_stats(x2d, gamma, beta, eps,
                                                    groups, group)
        y = bn_apply(x2d, a, b, groups, relu, "lean")
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.relu, ctx.groups, ctx.group, ctx.count = relu, groups, group, count
        ctx.set_materialize_grads(False)
        return y.view(x.shape), mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        x2d = x.view(-1, x.shape[-1])
        dx, dgamma, dbeta = _lean_backward(ctx, gy, x2d, gamma, beta, mean,
                                           rstd, gmean, gvar, bn_dx)
        return dx.view(x.shape), dgamma, dbeta, None, None, None, None


def _lean_backward(ctx, gy, x2d, gamma, beta, mean, rstd, gmean, gvar,
                   dx_pass):
    """``_lean_bwd``: K8 and the dx pass (``dx_pass``, ``bn_dx`` or its
    custom op) in lean mode on the saved x; returns (dx (M, C), dgamma,
    dbeta). ``ctx`` holds relu, groups, group and count."""
    relu, groups = ctx.relu, ctx.groups
    gy = torch.zeros_like(x2d) if gy is None else gy.reshape(x2d.shape)
    mask = (gamma, beta) if relu else (None, None)
    dbeta, dgamma = batch_norm_grad_stats(gy, x2d, mean, rstd, groups,
                                          *mask, mode="lean")
    # dx needs the sums over the whole sync group; the returned dgamma and
    # dbeta stay local (_lean_bwd:392-397).
    (dbeta_g, dgamma_g), _ = _group_sum((dbeta, dgamma), ctx.group)
    dx = dx_pass(gy, x2d, mean, rstd, gamma, beta, dbeta_g, dgamma_g,
                 ctx.count, groups, relu, "lean", gmean, gvar)
    if groups > 1:
        dgamma, dbeta = dgamma.sum(0), dbeta.sum(0)
    return dx, dgamma, dbeta


def lean_batch_norm_train(x, gamma, beta, eps=1e-5, relu=False, groups=1,
                          group=None):
    """Training-mode traffic-lean BN (``horovod_tpu``'s
    ``lean_batch_norm_train``) over a channels-last activation [..., C],
    contiguous, of any rank: statistics over every leading axis. Returns
    (y in x's dtype and shape, mean, var), the statistics f32, (C,) or
    (G, C).

    Forward: K7, then the normalize pass in x's dtype (``"lean"`` mode),
    max(y, 0) with ``relu``. Saves only (x, mean, rstd) and gamma, beta;
    the backward recomputes x_hat and the ReLU mask (from the
    pre-activation x_hat * gamma + beta, as the reference does) in K8 and
    the dx pass. ``groups`` > 1 is ghost BN: the leading axis splits into
    that many virtual batches, each normalized on its own. ``group`` (a
    process group) is sync BN: the statistics are summed over its ranks,
    each holding an equal shard; the returned dgamma and dbeta stay local
    (summed over the ghost groups)."""
    if x.dim() < 2 or x.shape[0] % groups:
        raise ValueError("lean_batch_norm_train: groups=%d does not divide "
                         "the leading axis of %s" % (groups, tuple(x.shape)))
    return _LeanBatchNormFn.apply(x, gamma, beta, eps, bool(relu), groups,
                                  group)


class _LeanNormConvFn(torch.autograd.Function):
    """``bn_remat``: a lean BN and the convolution that reads its output,
    with that output not kept for the backward. The forward runs K7, the
    normalize pass and the convolution, and saves x, the statistics, the
    normalize pass's a and b and the convolution's weight; the backward
    recomputes the normalize output from those a and b with one launch of
    the normalize pass (through its custom op), runs the
    convolution's backward on it, then K8 and the dx pass as
    ``_LeanBatchNormFn`` does. The same operations on the same values as
    the two modules apart, so the same results."""

    @staticmethod
    def forward(ctx, x, gamma, beta, weight, eps, relu, groups, group, conv):
        xl = x.movedim(1, -1)
        x2d = xl.view(-1, xl.shape[-1])
        mean, var, rstd, a, b, count = _batch_stats(x2d, gamma, beta, eps,
                                                    groups, group)
        y = bn_apply(x2d, a, b, groups, relu, "lean")
        stride, pad, padding, dtype = conv
        w = weight.to(dtype, memory_format=torch.channels_last)
        out = F.conv2d(_padded(y.view(xl.shape).movedim(-1, 1), pad)
                       .to(dtype), w, stride=stride, padding=padding)
        ctx.save_for_backward(x, gamma, beta, mean, rstd, w, a, b)
        ctx.relu, ctx.groups, ctx.group, ctx.count = relu, groups, group, count
        ctx.conv, ctx.weight_dtype = conv, weight.dtype
        ctx.set_materialize_grads(False)
        return out, mean, var

    @staticmethod
    def backward(ctx, gout, gmean, gvar):
        x, gamma, beta, mean, rstd, w, a, b = ctx.saved_tensors
        stride, pad, padding, dtype = ctx.conv
        xl = x.movedim(1, -1)
        x2d = xl.view(-1, xl.shape[-1])
        y = torch.ops.horovod_tpu_torch.bn_apply(x2d, a, b, ctx.groups,
                                                 ctx.relu, "lean")
        yp = _padded(y.view(xl.shape).movedim(-1, 1), pad).to(dtype)
        padding = [padding] * 2 if isinstance(padding, int) else padding
        gy, gw, _ = torch.ops.aten.convolution_backward(
            gout, yp, w, None, [stride] * 2, list(padding), [1, 1], False,
            [0, 0], 1, [True, True, False])
        if pad:
            lf, _, t, _ = pad
            gy = gy[:, :, t:t + x.shape[2], lf:lf + x.shape[3]]
        dx, dgamma, dbeta = _lean_backward(
            ctx, gy.movedim(1, -1), x2d, gamma, beta, mean, rstd, gmean,
            gvar, torch.ops.horovod_tpu_torch.bn_dx)
        return (dx.view(xl.shape).movedim(-1, 1), dgamma, dbeta,
                gw.to(ctx.weight_dtype), None, None, None, None, None)


def _padded(y, pad):
    return F.pad(y, pad) if pad else y


def lean_batch_norm_conv(x, gamma, beta, weight, eps=1e-5, relu=False,
                         groups=1, group=None, stride=1, pad=None, padding=0,
                         dtype=torch.bfloat16):
    """``F.conv2d(F.pad(lean_batch_norm_train(x)'s y, pad), weight in
    dtype, stride, padding)`` on a channels-last [N, C, H, W] activation,
    without keeping y for the backward: the backward recomputes it with
    one launch of the normalize pass (``bn_remat``). Returns (the
    convolution's output, mean, var)."""
    return _LeanNormConvFn.apply(x, gamma, beta, weight, eps, bool(relu),
                                 groups, group, (stride, pad, padding, dtype))


class _StockSyncBatchNormFn(torch.autograd.Function):
    """Sync BN on the stock path, the counterpart of flax's
    ``nn.BatchNorm(axis_name=)``: the per-channel sum and sum of squares of
    x in f32 are summed over the group, the variance is E[x^2] - E[x]^2 (as
    flax's pmean of the two means gives), y = (x - mean) * (rstd * gamma)
    + beta. The backward sums its two per-channel terms (sum dy, sum dy *
    x_hat) over the group, the transpose of that sum, and returns the
    local dgamma and dbeta."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, group):
        dims, shape = _stock_dims(x)
        xf = x.float()
        (s, ss), n = _group_sum((xf.sum(dims), (xf * xf).sum(dims)), group)
        count = x.numel() // x.shape[1] * n
        mean = s / count
        var = torch.clamp(ss / count - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        y = ((xf - mean.view(shape)) * (rstd * gamma).view(shape)
             + beta.view(shape)).to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.group, ctx.count = group, count
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, gamma, mean, rstd = ctx.saved_tensors
        dims, shape = _stock_dims(x)
        xhat = (x.float() - mean.view(shape)) * rstd.view(shape)
        g = gy.float()
        dbeta, dgamma = g.sum(dims), (g * xhat).sum(dims)
        (dbeta_g, dgamma_g), _ = _group_sum((dbeta, dgamma), ctx.group)
        dx = (gamma * rstd).view(shape) * (
            g - (dbeta_g / ctx.count).view(shape)
            - xhat * (dgamma_g / ctx.count).view(shape))
        return dx.to(x.dtype), dgamma, dbeta, None, None


def _stock_dims(x):
    """The reduced dims of [N, C, ...] and the shape a (C,) term takes to
    broadcast over x."""
    return ([0] + list(range(2, x.dim())),
            (1, -1) + (1,) * (x.dim() - 2))


def stock_sync_batch_norm_train(x, gamma, beta, eps=1e-5, group=None):
    """Training-mode BN over dim 1 of [N, C, ...] with the statistics
    summed over ``group`` (a ``ProcessGroup``, WORLD or a
    ``torch.distributed`` process group; every rank an equal shard). Plain
    torch math, no kernel of the port. Returns (y in x's dtype, mean,
    var), the statistics f32 and global, the variance biased."""
    return _StockSyncBatchNormFn.apply(x, gamma, beta, eps, group)


# --------------------------------------------------------------- modules


class _BatchNorm(nn.Module):
    """Parameters, buffers and the eval path shared by the port's
    BatchNorms. flax conventions: ``momentum`` is the weight of the old
    running value, ``ra = momentum * ra + (1 - momentum) * batch``, and the
    running variance takes the biased batch variance (torch's
    ``nn.BatchNorm2d`` writes the same update with momentum 0.1 the other
    way round and takes the unbiased variance). ``fuse_relu``: the module
    applies the ReLU that follows it (only ``LeanBatchNorm`` does)."""

    fuse_relu = False

    def __init__(self, num_features, eps=1e-5, momentum=0.9, group=None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.momentum = momentum
        self.group = group
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def _eval(self, x):
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * a
        shape = (-1,) + (1,) * (x.dim() - 2)
        y = x.float() * a.view(shape) + b.view(shape)
        if self.fuse_relu:
            y = torch.relu(y)
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var):
        if mean.dim() == 2:  # ghost groups: the mean of their statistics
            mean, var = mean.mean(0), var.mean(0)
        m = self.momentum
        self.running_mean.mul_(m).add_(mean, alpha=1 - m)
        self.running_var.mul_(m).add_(var, alpha=1 - m)


def _channels_last(what, x):
    """[N, C, ...] -> the [N, ..., C] view that the kernels read in place;
    raises unless x is channels-last in memory."""
    xl = x.movedim(1, -1)
    if not xl.is_contiguous():
        raise ValueError(
            "%s: the activation must be channels-last in memory "
            "(x.to(memory_format=torch.channels_last)); strides %s"
            % (what, tuple(x.stride())))
    return xl


def _ghost_groups(virtual_batch_size, n):
    """Ghost groups of a batch of ``n`` (``:576-582``): 1 without a virtual
    batch size."""
    if not virtual_batch_size:
        return 1
    if n % virtual_batch_size:
        raise ValueError("virtual_batch_size=%d does not divide the batch %d"
                         % (virtual_batch_size, n))
    return n // virtual_batch_size


class FusedBatchNorm(_BatchNorm):
    """Counterpart of ``PallasBatchNorm``: BN over dim 1 of [N, C, ...]
    with K7, K8 and the two passes in training mode; eval mode is
    elementwise and launches no kernel. The activation must be
    channels-last in memory (``torch.channels_last`` for 4-D) so the
    kernels read it in place. ``group`` is sync BN over a process group.
    ``virtual_batch_size`` is ghost BN, routed through
    ``lean_batch_norm_train`` (without the ReLU) as the reference routes
    it. Built on ``device`` (default: the GPU; ``"cpu"`` for tests)."""

    def __init__(self, num_features, eps=1e-5, momentum=0.9, group=None,
                 virtual_batch_size=None, device=None):
        super().__init__(num_features, eps, momentum, group, device)
        self.virtual_batch_size = virtual_batch_size

    def forward(self, x):
        if not self.training:
            return self._eval(x)
        xl = _channels_last("FusedBatchNorm", x)
        if self.virtual_batch_size:
            y, mean, var = lean_batch_norm_train(
                xl.reshape(-1, xl.shape[-1]), self.weight, self.bias,
                self.eps, False, _ghost_groups(self.virtual_batch_size,
                                               x.shape[0]), self.group)
        else:
            y, mean, var = fused_batch_norm_train(
                xl.view(-1, xl.shape[-1]), self.weight, self.bias, self.eps,
                self.group)
        self._update_running(mean, var)
        return y.view(xl.shape).movedim(-1, 1)


class LeanBatchNorm(_BatchNorm):
    """Counterpart of ``horovod_tpu``'s ``LeanBatchNorm``: BN over dim 1 of
    a channels-last [N, C, ...] activation through
    ``lean_batch_norm_train`` in training mode (K7, K8 and the two passes
    in x's dtype, the backward recomputing x_hat). ``fuse_relu`` applies the
    ReLU that follows the norm inside it, in training and eval mode.
    ``virtual_batch_size`` is ghost BN (it must divide the batch; the
    running statistics take the mean of the group statistics); ``group``
    (a process group) is sync BN."""

    def __init__(self, num_features, eps=1e-5, momentum=0.9, group=None,
                 virtual_batch_size=None, fuse_relu=False, device=None):
        super().__init__(num_features, eps, momentum, group, device)
        self.virtual_batch_size = virtual_batch_size
        self.fuse_relu = fuse_relu

    def forward(self, x):
        if not self.training:
            return self._eval(x)
        groups = _ghost_groups(self.virtual_batch_size, x.shape[0])
        xl = _channels_last("LeanBatchNorm", x)
        y, mean, var = lean_batch_norm_train(xl, self.weight, self.bias,
                                             self.eps, self.fuse_relu,
                                             groups, self.group)
        self._update_running(mean, var)
        return y.movedim(-1, 1)

    def forward_conv(self, x, conv):
        """``conv(self(x))`` for a ``models.resnet.Conv`` without keeping
        ``self(x)`` for the backward, which recomputes it
        (``lean_batch_norm_conv``, ``ResNet(bn_remat=True)``)."""
        if not self.training:
            return conv(self(x))
        _channels_last("LeanBatchNorm", x)
        pad, padding = conv.pads(x.shape)
        out, mean, var = lean_batch_norm_conv(
            x, self.weight, self.bias, conv.weight, self.eps, self.fuse_relu,
            _ghost_groups(self.virtual_batch_size, x.shape[0]), self.group,
            conv.stride, pad, padding, conv.dtype)
        self._update_running(mean, var)
        return out


class StockBatchNorm(_BatchNorm):
    """flax ``nn.BatchNorm`` in PyTorch: ``F.batch_norm`` on the batch
    statistics in training mode, with flax's running-statistics update
    (biased variance, ``momentum`` the weight of the old value); with
    ``group``, ``stock_sync_batch_norm_train``."""

    def forward(self, x):
        if not self.training:
            return self._eval(x)
        if self.group is not None:
            y, mean, var = stock_sync_batch_norm_train(
                x, self.weight, self.bias, self.eps, self.group)
            self._update_running(mean, var)
            return y
        y = F.batch_norm(x, None, None, self.weight, self.bias,
                         training=True, eps=self.eps)
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            var, mean = torch.var_mean(x.float(), dim=dims, correction=0)
            self._update_running(mean, var)
        return y
