"""The reference's half of ``tests/test_torch_port_core_grads.py``: the
gradients that ``tests/torch_port_core_worker.py grads`` computed on each
rank (``OUT_DIR/local_R.pt``), averaged by the reference's
``horovod_tpu.jax.allreduce_gradients`` on its host plane (its core's
negotiation and TCP ring). Writes ``OUT_DIR/reference_R.npz``.

Run: python -m horovod_tpu.run.run -np 2 -- python
tests/torch_port_core_ref_worker.py OUT_DIR
"""

import os
import sys

import numpy as np
import torch

import horovod_tpu as hvd
from horovod_tpu import jax as hvd_jax


def main(out_dir):
    hvd.init()
    r = hvd.rank()
    local = torch.load(os.path.join(out_dir, "local_%d.pt" % r))
    grads = {k: v.numpy() for k, v in local.items()}
    # each rank's own gradients, no weights: nothing to broadcast
    out = hvd_jax.allreduce_gradients(grads)  # hvd-lint: disable=missing-initial-broadcast
    np.savez(os.path.join(out_dir, "reference_%d.npz" % r),
             **{k: np.asarray(v) for k, v in out.items()})
    print("rank %d: reference grads written" % r, flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
