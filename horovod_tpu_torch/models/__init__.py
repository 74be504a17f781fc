"""Models of the port."""

from horovod_tpu_torch.models.transformer import (  # noqa: F401
    Attention,
    Block,
    Transformer,
    TransformerConfig,
)
