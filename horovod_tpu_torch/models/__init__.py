"""Models of the port."""

from horovod_tpu_torch.models.resnet import (  # noqa: F401
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet50Lean,
    ResNet50PBN,
    ResNet101,
    ResNet152,
    ResNetBlock,
)
from horovod_tpu_torch.models.transformer import (  # noqa: F401
    Attention,
    Block,
    Transformer,
    TransformerConfig,
)
