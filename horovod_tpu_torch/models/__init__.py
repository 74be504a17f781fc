"""Models of the port: the counterparts of ``horovod_tpu/models``."""

from horovod_tpu_torch.models.resnet import (  # noqa: F401
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet50GN,
    ResNet50Lean,
    ResNet50NF,
    ResNet50PBN,
    ResNet101,
    ResNet101NF,
    ResNet152,
    ResNetBlock,
)
from horovod_tpu_torch.models.mnist import MnistCNN  # noqa: F401
from horovod_tpu_torch.models.word2vec import SkipGram  # noqa: F401
from horovod_tpu_torch.models.transformer import (  # noqa: F401
    Attention,
    Block,
    Transformer,
    TransformerConfig,
)
from horovod_tpu_torch.models.imagenet_extras import (  # noqa: F401
    VGG16,
    InceptionV3,
)
