"""BatchNorm with hand-written statistics kernels for Hopper, and their
plain PyTorch versions.

Counterpart of ``horovod_tpu/ops/batch_norm.py`` (the Pallas path:
``batch_norm_stats``, ``batch_norm_grad_stats``, ``fused_batch_norm_train``
and ``PallasBatchNorm``). Two kernels, in ``csrc/batch_norm.cu``:

- K7 ``batch_norm_stats``: per-channel (sum x, sum x^2) of a (M, C)
  activation;
- K8 ``batch_norm_grad_stats``: per-channel (sum dy, sum dy * x_hat), i.e.
  (dbeta, dgamma).

Each reads its operands once (bf16 or f32), accumulates in f32 and returns
two (C,) f32 tensors. Each wrapper dispatches on where its input lies: a
CPU tensor goes to the plain version, a CUDA tensor launches the kernel or
raises. The kernels mask both ragged tails, so every M >= 1 and C >= 1 is
taken, and reduce across blocks in a fixed order (no float atomics), so
the same input gives bit-identical statistics. The (M, C) input must be
contiguous: a ``channels_last`` [N, C, H, W] activation is physically
NHWC, and ``x.movedim(1, -1).view(-1, C)`` is then a view the kernels
read in place. Nothing is copied to make an input contiguous.

The normalize and dx passes stay elementwise PyTorch, as the JAX package
leaves them to XLA. Each wrapper counts its launches in ``.launches``.
``StockBatchNorm`` is the same module on ``F.batch_norm`` (cuDNN on the
GPU), the counterpart of flax's ``nn.BatchNorm``: no kernel of the port.
"""

import ctypes

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.ops import _build

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_THREADS = 256          # threads of a pass-1 block (csrc/batch_norm.cu)
# Row splits: enough pass-1 blocks to fill the card (about 4 of 256
# threads per SM of an H100), each thread taking at least _MIN_ROWS rows.
# A fixed number, not read from the device, so every card and every rank
# splits (and so rounds) alike.
_TARGET_BLOCKS = 528
_MIN_ROWS = 32

_bound = {}


# ---------------------------------------------------------------- plain


def batch_norm_stats_ref(x2d):
    """Plain version of K7 in f32: (sum x, sum x^2) over the rows."""
    xf = x2d.float()
    return xf.sum(0), (xf * xf).sum(0)


def batch_norm_grad_stats_ref(dy2d, x2d, mean, rstd):
    """Plain version of K8 in f32: (sum dy, sum dy * (x - mean) * rstd)."""
    dyf = dy2d.float()
    xhat = (x2d.float() - mean) * rstd
    return dyf.sum(0), (dyf * xhat).sum(0)


# --------------------------------------------------------------- kernels


_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> its argument types (csrc/batch_norm.cu): the input
# pointers with their dtypes, (mean, rstd), ws, out, M, C, vec, splits,
# stream.
_ARGTYPES = {
    "hvd_bn_stats": [_P, _I, _P, _P, ctypes.c_longlong, _I, _I, _I, _P],
    "hvd_bn_grad_stats": [_P, _I, _P, _I, _P, _P, _P, _P, ctypes.c_longlong,
                          _I, _I, _I, _P],
}


def _entry(name):
    """(library, C function) of an entry point, built and bound once."""
    if name not in _bound:
        lib = _build.library("batch_norm")
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _bound[name] = (lib, fn)
    return _bound[name]


def _on_cpu(what, t):
    """True for CPU tensors (the plain version runs); False for CUDA
    tensors (the kernel runs); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError("%s: tensors on %s; the kernels run on CUDA and the "
                         "plain version on the CPU" % (what, t.device))
    return False


def _check_rows(what, name, t, device, shape=None):
    if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError("%s: %s must be a non-empty (M, C) tensor, got %s"
                         % (what, name, tuple(t.shape)))
    if shape is not None and t.shape != shape:
        raise ValueError("%s: %s is %s, x is %s"
                         % (what, name, tuple(t.shape), tuple(shape)))
    if t.device != device:
        raise ValueError("%s: %s is on %s, x on %s"
                         % (what, name, t.device, device))
    if t.dtype not in _DTYPES:
        raise TypeError("%s: %s is %s; the kernels take bfloat16 or float32"
                        % (what, name, t.dtype))
    if not t.is_contiguous():
        raise ValueError(
            "%s: %s must be a contiguous (M, C) view (a channels_last "
            "activation as x.movedim(1, -1).view(-1, C)); got strides %s"
            % (what, name, tuple(t.stride())))


def _plan(M, C, vec):
    """Row splits of pass 1 for a (M, C) input read ``vec`` channels at a
    time: the workspace is f32 [splits, 2, C]."""
    tc = -(-C // vec)
    tx = min(tc, _THREADS)
    col_tiles = -(-tc // tx)
    rows_per_pass = _THREADS // tx
    return max(1, min(-(-M // (rows_per_pass * _MIN_ROWS)),
                      -(-_TARGET_BLOCKS // col_tiles)))


def _launch(name, args, tensors, M, C):
    """Launches ``name`` over (M, C) and returns its (2, C) f32 output."""
    dev = tensors[0].device
    vec = 8 if C % 8 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in tensors) else 1
    splits = _plan(M, C, vec)
    ws = torch.empty(splits, 2, C, dtype=torch.float32, device=dev)
    out = torch.empty(2, C, dtype=torch.float32, device=dev)
    lib, fn = _entry(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, ws.data_ptr(), out.data_ptr(), M, C, vec, splits,
                 stream)
    _build.check(lib, err, name)
    return out


def batch_norm_stats(x2d):
    """K7: (sum x, sum x^2) over the rows of a (M, C) tensor, two (C,) f32
    tensors."""
    if _on_cpu("batch_norm_stats", x2d):
        return batch_norm_stats_ref(x2d)
    _check_rows("batch_norm_stats", "x", x2d, x2d.device)
    M, C = x2d.shape
    out = _launch("hvd_bn_stats", [x2d.data_ptr(), _DTYPES[x2d.dtype]],
                  [x2d], M, C)
    batch_norm_stats.launches += 1
    return out[0], out[1]


def batch_norm_grad_stats(dy2d, x2d, mean, rstd):
    """K8: (sum dy, sum dy * (x - mean) * rstd) over the rows, i.e. (dbeta,
    dgamma), two (C,) f32 tensors. dy and x are (M, C), bf16 or f32 each
    (f32 dy with bf16 x is allowed); mean and rstd are (C,) f32."""
    if _on_cpu("batch_norm_grad_stats", x2d):
        return batch_norm_grad_stats_ref(dy2d, x2d, mean, rstd)
    what = "batch_norm_grad_stats"
    _check_rows(what, "x", x2d, x2d.device)
    _check_rows(what, "dy", dy2d, x2d.device, x2d.shape)
    M, C = x2d.shape
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.shape != (C,) or t.dtype != torch.float32
                or t.device != x2d.device or not t.is_contiguous()):
            raise ValueError("%s: %s must be contiguous float32 (%d,) on %s"
                             % (what, name, C, x2d.device))
    out = _launch("hvd_bn_grad_stats",
                  [dy2d.data_ptr(), _DTYPES[dy2d.dtype], x2d.data_ptr(),
                   _DTYPES[x2d.dtype], mean.data_ptr(), rstd.data_ptr()],
                  [dy2d, x2d], M, C)
    batch_norm_grad_stats.launches += 1
    return out[0], out[1]


batch_norm_stats.launches = 0
batch_norm_grad_stats.launches = 0
KERNEL_WRAPPERS = (batch_norm_stats, batch_norm_grad_stats)


def launch_counts():
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


# ----------------------------------------------------- training-mode BN


def _group_sum(pair, group):
    """(a, b) summed over ``group`` in one collective of the stacked pair,
    and the group's size; (a, b) and 1 without a group."""
    if group is None:
        return pair, 1
    stacked = torch.stack(pair)
    dist.all_reduce(stacked, op=dist.ReduceOp.SUM, group=group)
    return (stacked[0], stacked[1]), dist.get_world_size(group)


class _FusedBatchNormFn(torch.autograd.Function):
    """Training-mode BN over (M, C): K7 in the forward, K8 in the backward,
    the normalize and dx passes elementwise in f32."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps, group):
        M = x2d.shape[0]
        (s, ss), n = _group_sum(batch_norm_stats(x2d), group)
        M = M * n  # equal shards, as the JAX package's psum(1)
        mean = s / M
        var = torch.clamp(ss / M - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        a = gamma * rstd
        b = beta - mean * a
        y = (x2d.float() * a + b).to(x2d.dtype)
        ctx.save_for_backward(x2d, gamma, mean, rstd)
        ctx.group = group
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x2d, gamma, mean, rstd = ctx.saved_tensors
        M = x2d.shape[0]
        if gy is None:
            gy = torch.zeros_like(x2d)
        dbeta, dgamma = batch_norm_grad_stats(gy, x2d, mean, rstd)
        # dx needs the sums over the whole sync group; the returned dgamma
        # and dbeta stay local, and the gradient allreduce completes them.
        (dbeta_g, dgamma_g), n = _group_sum((dbeta, dgamma), ctx.group)
        Mg = M * n
        xf = x2d.float()
        xhat = (xf - mean) * rstd
        dx = (gamma * rstd) * (gy.float() - dbeta_g / Mg
                               - xhat * (dgamma_g / Mg))
        # The mean and var cotangents: None in training use (the running
        # statistics are not differentiated), kept exact otherwise.
        if gmean is not None:
            dx = dx + gmean / Mg
        if gvar is not None:
            dx = dx + gvar * (2.0 / Mg) * (xf - mean)
        return dx.to(x2d.dtype), dgamma, dbeta, None, None


def fused_batch_norm_train(x2d, gamma, beta, eps=1e-5, group=None):
    """Training-mode BN over a (M, C) activation: returns (y in x's dtype,
    mean, var), the batch statistics f32 with the biased variance. K7 runs
    in the forward and K8 in the backward. ``group`` (a ``torch.distributed``
    process group, the counterpart of ``axis_name``) is sync BN: the
    statistics are summed over the group's ranks, each holding an equal
    shard."""
    return _FusedBatchNormFn.apply(x2d, gamma, beta, eps, group)


class _BatchNorm(nn.Module):
    """Parameters, buffers and the eval path shared by the port's two
    BatchNorms. flax conventions: ``momentum`` is the weight of the old
    running value, ``ra = momentum * ra + (1 - momentum) * batch``, and the
    running variance takes the biased batch variance (torch's
    ``nn.BatchNorm2d`` writes the same update with momentum 0.1 the other
    way round and takes the unbiased variance)."""

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
        return (x.float() * a.view(shape) + b.view(shape)).to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var):
        m = self.momentum
        self.running_mean.mul_(m).add_(mean, alpha=1 - m)
        self.running_var.mul_(m).add_(var, alpha=1 - m)


class FusedBatchNorm(_BatchNorm):
    """Counterpart of ``PallasBatchNorm``: BN over dim 1 of [N, C, ...]
    with K7 and K8 in training mode; eval mode is elementwise and launches
    no kernel. The activation must be channels-last in memory
    (``torch.channels_last`` for 4-D) so the kernels read it in place.
    ``group`` is sync BN over a process group. Built on ``device``
    (default: the GPU; ``"cpu"`` for tests)."""

    def __init__(self, num_features, eps=1e-5, momentum=0.9, group=None,
                 virtual_batch_size=None, device=None):
        if virtual_batch_size:
            raise NotImplementedError(
                "ghost BN (virtual_batch_size) is a later slice of the port "
                "(ROADMAP A3, the lean BN path)")
        super().__init__(num_features, eps, momentum, group, device)

    def forward(self, x):
        if not self.training:
            return self._eval(x)
        # [N, ..., C], a view; contiguous when x is channels-last
        xl = x.movedim(1, -1)
        if not xl.is_contiguous():
            raise ValueError(
                "FusedBatchNorm: the activation must be channels-last in "
                "memory (x.to(memory_format=torch.channels_last)); strides "
                "%s" % (tuple(x.stride()),))
        y, mean, var = fused_batch_norm_train(
            xl.view(-1, xl.shape[-1]), self.weight, self.bias, self.eps,
            self.group)
        self._update_running(mean, var)
        return y.view(xl.shape).movedim(-1, 1)


class StockBatchNorm(_BatchNorm):
    """flax ``nn.BatchNorm`` in PyTorch: ``F.batch_norm`` on the batch
    statistics in training mode, with flax's running-statistics update
    (biased variance, ``momentum`` the weight of the old value)."""

    def forward(self, x):
        if not self.training:
            return self._eval(x)
        if self.group is not None:
            raise NotImplementedError(
                "sync BN on the stock path is a later slice of the port "
                "(ROADMAP A3); norm='pallas' takes bn_group")
        y = F.batch_norm(x, None, None, self.weight, self.bias,
                         training=True, eps=self.eps)
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            var, mean = torch.var_mean(x.float(), dim=dims, correction=0)
            self._update_running(mean, var)
        return y
