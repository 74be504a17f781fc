"""Device ops of the port: hand-written Hopper kernels and their plain
versions. The kernels build at first use (``_build.py``), never at
import."""

from horovod_tpu_torch.ops.agc import (  # noqa: F401
    adaptive_grad_clip,
    agc_clip,
    unitwise_norm,
)
from horovod_tpu_torch.ops.batch_norm import (  # noqa: F401
    FusedBatchNorm,
    LeanBatchNorm,
    batch_norm_grad_stats,
    batch_norm_stats,
    bn_apply,
    bn_dx,
    fused_batch_norm_train,
    lean_batch_norm_train,
)
from horovod_tpu_torch.ops.flash_attention import (  # noqa: F401
    analytic_attention_flops,
    apply_rotary,
    flash_attention,
)
from horovod_tpu_torch.ops.losses import (  # noqa: F401
    chunked_softmax_cross_entropy,
)
from horovod_tpu_torch.ops.wire_codec import (  # noqa: F401
    wire_decode_add,
    wire_encode,
)
