"""The 2-layer MNIST CNN of the reference's MNIST examples.

Counterpart of ``horovod_tpu/models/mnist.py``: conv 32 (3 x 3), ReLU,
conv 64 (3 x 3), ReLU, 2 x 2 max-pool, dense 128, ReLU, dense 10, every
layer with a bias and ``"SAME"`` padding. Images [N, 1, H, W], activations
channels-last, f32 parameters, products in ``dtype``, f32 logits, flax's
initializers from ``generator``. flax flattens the NHWC activation in
(h, w, c) order, so the port permutes its channels-last activation to
[N, H, W, C] (a free view) before the reshape. ``image_size`` sets the
first dense layer's input width, which flax infers from the first input.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models.imagenet_extras import _dense, init_flax_
from horovod_tpu_torch.models.resnet import Conv
from horovod_tpu_torch.ops.agc import tag_units


class MnistCNN(nn.Module):
    """conv(32, 3x3) -> conv(64, 3x3) -> maxpool -> dense(128) -> dense(10)."""

    def __init__(self, num_classes=10, dtype=torch.bfloat16, image_size=28,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.conv1 = Conv(1, 32, 3, dtype=dtype, device=device, bias=True)
        self.conv2 = Conv(32, 64, 3, dtype=dtype, device=device, bias=True)
        side = image_size // 2
        self.fc1 = nn.Linear(64 * side * side, 128, device=device)
        self.fc2 = nn.Linear(128, num_classes, device=device)
        init_flax_(self, generator)
        self.to(memory_format=torch.channels_last)
        tag_units(self)

    def forward(self, x):
        x = x.to(self.dtype, memory_format=torch.channels_last)
        x = F.relu(self.conv2(F.relu(self.conv1(x))))
        x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(_dense(x, self.fc1, self.dtype))
        return _dense(x, self.fc2, self.dtype).float()
