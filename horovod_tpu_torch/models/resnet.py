"""ResNet v1.5, the flagship model of the data-parallel benchmark.

Counterpart of ``horovod_tpu/models/resnet.py``: the stem (7x7 stride-2
conv, BN, ReLU, 3x3 stride-2 max-pool), stages of basic (ResNet-18/34) or
bottleneck (ResNet-50/101/152) blocks with the stride on the 3x3 conv and
a 1x1 projection where the shape changes, global mean pool and a dense
head. The block-final BN starts with a zero scale, as in flax.

Layout and precision: images come in as [N, 3, H, W] and every activation
is ``torch.channels_last`` (physically NHWC, as the JAX model's). The
parameters are float32; each convolution and the head cast their input
and weight to ``dtype`` explicitly (no autocast), and the logits come out
float32. The convolutions are cuDNN's ``F.conv2d``, as the JAX package
leaves them to XLA.

``norm``: ``"pallas"`` is ``FusedBatchNorm`` (K7, K8 and the normalize and
dx passes in f32), ``"lean"`` is ``LeanBatchNorm`` (the same kernels in the
compute dtype, the backward recomputing x_hat; the norm that a ReLU follows
inside a block, and the stem's, applies that ReLU itself, while block-final
norms, projections and the ReLU after the residual add stay apart, as in
the reference), ``"batch"`` the stock BN (``F.batch_norm``), the
counterpart of flax's ``nn.BatchNorm``. All keep flax's running statistics
and state-dict keys. ``"group"`` is ``GroupNorm`` (flax's
``GroupNorm(num_groups=32, epsilon=1e-5)``, ``ResNet50GN``) and ``"none"``
no norm at all, with no parameter (``ResNet50NF``, ``ResNet101NF``, the
norm-free ResNets trained with AGC, ``ops/agc.py``). ``bn_group`` is
sync BN over a process group (the counterpart of ``bn_axis_name``),
``bn_virtual_batch_size`` ghost BN
(``"lean"`` and ``"pallas"``). ``bn_remat`` (the counterpart of
``bn_remat_policy`` over each block) recomputes in the backward, instead
of keeping, the output of every norm inside a block that a convolution
reads (``LeanBatchNorm.forward_conv``); as in the reference it changes
only ``"lean"``, whose normalize outputs are the ones tagged.

Padding follows flax's ``"SAME"``: a stride-2 3x3 convolution of an even
input pads 0 before and 1 after, where ``nn.Conv2d(padding=1)`` would pad
1 and 1 and shift every output. ``Conv`` also takes flax's rectangular
kernels, ``"VALID"`` and a bias (Inception, VGG, the MNIST CNN).
"""

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.ops.agc import tag_units
from horovod_tpu_torch.ops.batch_norm import (FusedBatchNorm, LeanBatchNorm,
                                               StockBatchNorm)

_NORMS = {"batch": StockBatchNorm, "pallas": FusedBatchNorm,
          "lean": LeanBatchNorm}


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _same_padding(size, k, stride):
    """flax "SAME": (before, after) padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(w, generator=None):
    """flax's ``lecun_normal`` on a torch [out, in, ...] weight, in place: a
    normal truncated at +-2 sigma, scaled so that its variance is
    1 / fan_in (fan_in = in * the kernel's size)."""
    std = w[0].numel() ** -0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv``: an f32 [out, in, kh, kw] weight (``kernel`` an int
    or (kh, kw)), the product in ``dtype``, an f32 bias added in ``dtype``
    with ``bias=True``; ``stride`` an int or a pair; padding ``"SAME"``,
    ``"VALID"`` or ((top, bottom), (left, right))."""

    def __init__(self, cin, cout, kernel, stride=1, padding="SAME",
                 dtype=torch.bfloat16, device=None, bias=False):
        super().__init__()
        kh, kw = _pair(kernel)
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if bias else None)
        self.stride = stride
        self.padding = padding
        self.dtype = dtype

    def pads(self, shape):
        """(``F.pad``'s pad or None, ``F.conv2d``'s padding) for an input of
        ``shape``: symmetric padding goes to the convolution, asymmetric to
        an explicit pad."""
        if self.padding == "SAME":
            (t, b), (lf, r) = (_same_padding(n, k, s) for n, k, s in zip(
                shape[2:], self.weight.shape[2:], _pair(self.stride)))
        elif self.padding == "VALID":
            (t, b), (lf, r) = (0, 0), (0, 0)
        else:
            (t, b), (lf, r) = self.padding
        if t == b and lf == r:
            return None, (t, lf)
        return (lf, r, t, b), 0

    def forward(self, x):
        pad, padding = self.pads(x.shape)
        if pad:
            x = F.pad(x, pad)
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), w, bias, stride=self.stride,
                        padding=padding)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=dtype)``:
    statistics and normalization in f32 over each sample's groups of
    channels, f32 scale and bias, the output cast to ``dtype`` and
    channels-last. flax's statistics are E[x^2] - E[x]^2, these
    ``F.group_norm``'s (a library call for what XLA computes in the
    reference: no Pallas body)."""

    fuse_relu = False

    def __init__(self, num_features, num_groups=32, eps=1e-5,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if num_features % num_groups:
            raise ValueError("GroupNorm: %d groups do not divide %d "
                             "channels" % (num_groups, num_features))
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.to(self.dtype, memory_format=torch.channels_last)


class NoNorm(nn.Module):
    """``norm="none"``: the identity, no parameter."""

    fuse_relu = False

    def __init__(self, num_features=None):
        super().__init__()

    def forward(self, x):
        return x


class ResNetBlock(nn.Module):
    """Basic two-conv residual block (ResNet-18/34)."""
    expansion = 1

    @staticmethod
    def layers(cin, filters, stride):
        """(in, out, kernel, stride) of each conv, in order."""
        return [(cin, filters, 3, stride), (filters, filters, 3, 1)]

    def __init__(self, cin, filters, norm, stride=1, dtype=torch.bfloat16,
                 device=None, norm_act=None, bn_remat=False):
        super().__init__()
        self.bn_remat = bn_remat
        specs = self.layers(cin, filters, stride)
        self.convs = nn.ModuleList(Conv(*s, dtype=dtype, device=device)
                                   for s in specs)
        # norm_act: the norm that applies the ReLU after it itself, for
        # every norm but the block-final one (norm="lean")
        inner = norm_act or norm
        self.norms = nn.ModuleList(
            (inner if i < len(specs) - 1 else norm)(s[1])
            for i, s in enumerate(specs))
        cout = specs[-1][1]
        self.conv_proj = self.norm_proj = None
        if cin != cout or stride != 1:
            self.conv_proj = Conv(cin, cout, 1, stride, dtype=dtype,
                                  device=device)
            self.norm_proj = norm(cout)

    def forward(self, x):
        y = self.convs[0](x)
        for norm, conv in zip(self.norms, self.convs[1:]):
            if self.bn_remat:
                y = norm.forward_conv(y, conv)
                continue
            y = norm(y)
            if not norm.fuse_relu:
                y = F.relu(y)
            y = conv(y)
        y = self.norms[-1](y)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BottleneckBlock(ResNetBlock):
    """1x1 -> 3x3 (stride) -> 1x1 bottleneck (ResNet-50/101/152, v1.5)."""
    expansion = 4

    @staticmethod
    def layers(cin, filters, stride):
        return [(cin, filters, 1, 1), (filters, filters, 3, stride),
                (filters, filters * 4, 1, 1)]


class ResNet(nn.Module):
    """ResNet v1.5: images [N, 3, H, W] -> f32 logits [N, num_classes].

    Built on ``device`` (default: the GPU; ``"cpu"`` for tests), its
    weights drawn from ``generator`` (a ``torch.Generator`` on that device)
    with flax's initializers: convolutions and the head lecun-normal
    (truncated normal of variance 1/fan_in), head bias 0, norm scale 1 and
    bias 0, the block-final norm scale 0 (``norm="none"`` has none)."""

    def __init__(self, stage_sizes, block_cls, num_classes=1000,
                 num_filters=64, dtype=torch.bfloat16, norm="batch",
                 bn_group=None, bn_virtual_batch_size=None, bn_remat=False,
                 device=None, generator=None):
        super().__init__()
        if norm not in tuple(_NORMS) + ("group", "none"):
            raise ValueError("norm=%r is not batch|pallas|lean|group|none"
                             % norm)
        device = resolve_device(device)
        self.dtype = dtype
        if norm in ("group", "none"):
            if bn_group is not None or bn_virtual_batch_size:
                raise ValueError("bn_group and bn_virtual_batch_size apply "
                                 "to the BN norms, not norm=%r" % norm)
            norm_cls = (functools.partial(GroupNorm, dtype=dtype,
                                          device=device)
                        if norm == "group" else NoNorm)
        else:
            opts = dict(group=bn_group, device=device)
            if bn_virtual_batch_size:
                if norm == "batch":
                    raise ValueError("bn_virtual_batch_size (ghost BN) "
                                     "needs norm='lean' or norm='pallas'")
                opts["virtual_batch_size"] = bn_virtual_batch_size
            norm_cls = functools.partial(_NORMS[norm], **opts)
        norm_act = (functools.partial(norm_cls, fuse_relu=True)
                    if norm == "lean" else None)
        self.conv_init = Conv(3, num_filters, 7, 2, ((3, 3), (3, 3)),
                              dtype=dtype, device=device)
        self.bn_init = (norm_act or norm_cls)(num_filters)
        blocks, cin = [], num_filters
        for i, n in enumerate(stage_sizes):
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                blocks.append(block_cls(cin, filters, norm_cls, stride,
                                        dtype=dtype, device=device,
                                        norm_act=norm_act,
                                        bn_remat=bn_remat and norm == "lean"))
                cin = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=device)
        self.reset_parameters(generator)
        self.to(memory_format=torch.channels_last)
        tag_units(self)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for m in self.modules():
            if isinstance(m, (Conv, nn.Linear)):
                lecun_normal_(m.weight, generator)
            elif isinstance(m, tuple(_NORMS.values()) + (GroupNorm,)):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.head.bias.zero_()
        for block in self.blocks:
            if not isinstance(block.norms[-1], NoNorm):
                block.norms[-1].weight.zero_()

    def forward(self, x):
        x = x.to(self.dtype, memory_format=torch.channels_last)
        x = self.bn_init(self.conv_init(x))
        if not self.bn_init.fuse_relu:
            x = F.relu(x)
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return F.linear(x.to(self.dtype), self.head.weight.to(self.dtype),
                        self.head.bias.to(self.dtype)).float()


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckBlock)
ResNet50PBN = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                                block_cls=BottleneckBlock, norm="pallas")
ResNet50Lean = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                                 block_cls=BottleneckBlock, norm="lean")
ResNet50GN = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                               block_cls=BottleneckBlock, norm="group")
ResNet50NF = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                               block_cls=BottleneckBlock, norm="none")
ResNet101NF = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                                block_cls=BottleneckBlock, norm="none")
