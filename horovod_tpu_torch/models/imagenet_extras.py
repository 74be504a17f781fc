"""VGG-16 and Inception V3, the other models of the reference's published
scaling table (Inception V3, ResNet-101, VGG-16).

Counterpart of ``horovod_tpu/models/imagenet_extras.py``, with
``models/resnet.py``'s conventions: images [N, 3, H, W], channels-last
activations, f32 parameters, each convolution and dense layer computing
in ``dtype``, f32 logits, flax's initializers (lecun-normal kernels, zero
biases, BN scale 1 and bias 0) drawn from ``generator``.

Both flatten or pool an NHWC tensor before their dense layers, as flax
does: VGG flattens in (H, W, C) order, so a channels-last activation is
permuted to [N, H, W, C] (a free view) before the reshape.

``Dropout(0.5)`` runs in training mode before the dense layers that
follow it (VGG's two hidden ones, Inception's head), with masks from a
generator seeded with ``dropout_seed``; eval mode skips it.

Inception V3 (aux head omitted, as in the reference) is built of 94
Conv + BN + ReLU blocks (``ConvBN``) in the order flax creates its
``_ConvBN_<i>`` modules. ``norm="batch"`` is the stock BN
(``StockBatchNorm``), ``norm="pallas"`` ``FusedBatchNorm`` (K7, K8 and the
two BN passes); both with flax's epsilon 1e-3 and momentum 0.9, and
``bn_group`` is sync BN over a process group (the reference's
``bn_axis_name``). Its average pools are flax's ``avg_pool`` with
``"SAME"`` padding, which counts the padded zeros; its max-pools are
``"VALID"``. The branches concatenate along the channels, channels-last.
"""

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.ops.agc import tag_units
from horovod_tpu_torch.ops.batch_norm import FusedBatchNorm, StockBatchNorm
from horovod_tpu_torch.models.resnet import Conv, lecun_normal_

_CL = torch.channels_last


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in training mode each element is kept
    with probability 1 - rate (a uniform draw from the module's generator
    below it) and divided by 1 - rate, the others are 0; the identity in
    eval mode or at rate 0."""

    def __init__(self, rate=0.5, seed=0):
        super().__init__()
        self.rate, self.seed = rate, seed
        self._gen = None

    def reset(self):
        """Restarts the masks from the seed: the next call draws what a
        new module's first call draws."""
        self._gen = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self._gen is None or self._gen.device.type != x.device.type:
            self._gen = torch.Generator(device=x.device).manual_seed(
                self.seed)
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self._gen,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def _dense(x, layer, dtype):
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def init_flax_(model, generator=None):
    """flax's defaults over ``model``: lecun-normal convolution and dense
    kernels, zero biases, norm scale 1 and bias 0."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Conv, nn.Linear)):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (FusedBatchNorm, StockBatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()


VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16(nn.Module):
    """VGG-16 (configuration D): 13 3x3 convolutions with biases and ReLU
    in 5 stages, each followed by a 2x2 max-pool, then dense 4096, 4096
    (ReLU and dropout) and the head. ``image_size`` sets fc0's input
    width, which flax infers from the first input: 512 x (size / 32)^2."""

    def __init__(self, num_classes=1000, dtype=torch.bfloat16,
                 image_size=224, dropout_seed=0, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        convs, cin = [], 3
        for filters, reps in VGG_STAGES:
            for _ in range(reps):
                convs.append(Conv(cin, filters, 3, dtype=dtype, device=device,
                                  bias=True))
                cin = filters
        self.convs = nn.ModuleList(convs)
        side = image_size // 2 ** len(VGG_STAGES)
        self.fc = nn.ModuleList([nn.Linear(cin * side * side, 4096,
                                           device=device),
                                 nn.Linear(4096, 4096, device=device)])
        self.dropout = Dropout(0.5, dropout_seed)
        self.head = nn.Linear(4096, num_classes, device=device)
        init_flax_(self, generator)
        self.to(memory_format=_CL)
        tag_units(self)

    def forward(self, x):
        x = x.to(self.dtype, memory_format=_CL)
        convs = iter(self.convs)
        for _, reps in VGG_STAGES:
            for _ in range(reps):
                x = F.relu(next(convs)(x))
            x = F.max_pool2d(x, 2, 2)
        # flax flattens NHWC: (h, w, c) order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for fc in self.fc:
            x = self.dropout(F.relu(_dense(x, fc, self.dtype)))
        return _dense(x, self.head, self.dtype).float()


class ConvBN(nn.Module):
    """Conv (no bias) + BN + ReLU, Inception's building block."""

    def __init__(self, cin, filters, kernel, stride=1, padding="SAME",
                 norm_cls=None, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.conv = Conv(cin, filters, kernel, stride, padding, dtype=dtype,
                         device=device)
        self.bn = norm_cls(filters)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _cat(parts):
    return torch.cat(parts, 1).contiguous(memory_format=_CL)


def _avgpool3(x):
    """flax ``avg_pool(x, (3, 3), (1, 1), "SAME")``: the zeros of the
    padding count in the mean."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _maxpool3(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features, cbn):
        super().__init__()
        self.b1 = cbn(cin, 64, 1)
        self.b5_1, self.b5_2 = cbn(cin, 48, 1), cbn(48, 64, 5)
        self.b3_1, self.b3_2, self.b3_3 = (cbn(cin, 64, 1), cbn(64, 96, 3),
                                           cbn(96, 96, 3))
        self.bp = cbn(cin, pool_features, 1)
        self.cout = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return _cat([self.b1(x), self.b5_2(self.b5_1(x)),
                     self.b3_3(self.b3_2(self.b3_1(x))),
                     self.bp(_avgpool3(x))])


class InceptionB(nn.Module):
    """Grid 35 -> 17."""

    def __init__(self, cin, cbn):
        super().__init__()
        self.b3 = cbn(cin, 384, 3, 2, "VALID")
        self.bd_1, self.bd_2, self.bd_3 = (cbn(cin, 64, 1), cbn(64, 96, 3),
                                           cbn(96, 96, 3, 2, "VALID"))
        self.cout = 384 + 96 + cin

    def forward(self, x):
        return _cat([self.b3(x), self.bd_3(self.bd_2(self.bd_1(x))),
                     _maxpool3(x)])


class InceptionC(nn.Module):
    def __init__(self, cin, c7, cbn):
        super().__init__()
        self.b1 = cbn(cin, 192, 1)
        self.b7 = nn.Sequential(cbn(cin, c7, 1), cbn(c7, c7, (1, 7)),
                                cbn(c7, 192, (7, 1)))
        self.bd = nn.Sequential(cbn(cin, c7, 1), cbn(c7, c7, (7, 1)),
                                cbn(c7, c7, (1, 7)), cbn(c7, c7, (7, 1)),
                                cbn(c7, 192, (1, 7)))
        self.bp = cbn(cin, 192, 1)
        self.cout = 4 * 192

    def forward(self, x):
        return _cat([self.b1(x), self.b7(x), self.bd(x),
                     self.bp(_avgpool3(x))])


class InceptionD(nn.Module):
    """Grid 17 -> 8."""

    def __init__(self, cin, cbn):
        super().__init__()
        self.b3 = nn.Sequential(cbn(cin, 192, 1),
                                cbn(192, 320, 3, 2, "VALID"))
        self.b7 = nn.Sequential(cbn(cin, 192, 1), cbn(192, 192, (1, 7)),
                                cbn(192, 192, (7, 1)),
                                cbn(192, 192, 3, 2, "VALID"))
        self.cout = 320 + 192 + cin

    def forward(self, x):
        return _cat([self.b3(x), self.b7(x), _maxpool3(x)])


class InceptionE(nn.Module):
    def __init__(self, cin, cbn):
        super().__init__()
        self.b1 = cbn(cin, 320, 1)
        self.b3_1 = cbn(cin, 384, 1)
        self.b3_2a, self.b3_2b = cbn(384, 384, (1, 3)), cbn(384, 384, (3, 1))
        self.bd_1, self.bd_2 = cbn(cin, 448, 1), cbn(448, 384, 3)
        self.bd_3a, self.bd_3b = cbn(384, 384, (1, 3)), cbn(384, 384, (3, 1))
        self.bp = cbn(cin, 192, 1)
        self.cout = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x):
        b3 = self.b3_1(x)
        bd = self.bd_2(self.bd_1(x))
        return _cat([self.b1(x), self.b3_2a(b3), self.b3_2b(b3),
                     self.bd_3a(bd), self.bd_3b(bd), self.bp(_avgpool3(x))])


class InceptionV3(nn.Module):
    """Inception V3 over [N, 3, 299, 299] (any size from 75 up): the stem
    to 35 x 35 x 192, 3 A blocks, B, 4 C blocks (c7 = 128, 160, 160, 192),
    D, 2 E blocks, the global mean, dropout and the dense head."""

    def __init__(self, norm="batch", num_classes=1000, dtype=torch.bfloat16,
                 bn_group=None, dropout_seed=0, device=None, generator=None):
        super().__init__()
        if norm not in ("batch", "pallas"):
            raise ValueError("norm=%r is not batch|pallas" % norm)
        device = resolve_device(device)
        self.dtype = dtype
        bn = functools.partial(
            FusedBatchNorm if norm == "pallas" else StockBatchNorm,
            eps=1e-3, momentum=0.9, group=bn_group, device=device)
        cbn = functools.partial(ConvBN, norm_cls=bn, dtype=dtype,
                                device=device)
        self.stem = nn.ModuleList([
            cbn(3, 32, 3, 2, "VALID"), cbn(32, 32, 3, 1, "VALID"),
            cbn(32, 64, 3), cbn(64, 80, 1, 1, "VALID"),
            cbn(80, 192, 3, 1, "VALID")])
        blocks, cin = [], 192
        for make in ([functools.partial(InceptionA, pool_features=f)
                      for f in (32, 64, 64)] + [InceptionB] +
                     [functools.partial(InceptionC, c7=c)
                      for c in (128, 160, 160, 192)] +
                     [InceptionD, InceptionE, InceptionE]):
            blocks.append(make(cin, cbn=cbn))
            cin = blocks[-1].cout
        self.blocks = nn.ModuleList(blocks)
        self.dropout = Dropout(0.5, dropout_seed)
        self.head = nn.Linear(cin, num_classes, device=device)
        init_flax_(self, generator)
        self.to(memory_format=_CL)
        tag_units(self)

    def forward(self, x):
        x = x.to(self.dtype, memory_format=_CL)
        for i, layer in enumerate(self.stem):
            x = layer(x)
            if i in (2, 4):
                x = _maxpool3(x)
        for block in self.blocks:
            x = block(x)
        x = self.dropout(x.mean(dim=(2, 3)))
        return _dense(x, self.head, self.dtype).float()
