#!/usr/bin/env python3
"""Times the flash backward kernels K2 and K3 of this tree against another
tree's, in one call on one GPU.

    python3 tests/torch_port_bwd_ab.py OTHER_ROOT [--rounds N]

OTHER_ROOT holds another version's ``chip_smoke.py`` and
``horovod_tpu_torch/`` (e.g. ``git archive`` of the parent commit, unpacked
under the git-ignored ``horovod_tpu_torch/ops/_build/``). Runs other, this,
this, other (N rounds) in separate processes on the runner of
``tests/torch_port_fwd_ab.py``, each timing its own tree's kernels with its
``chip_smoke.time_ms``, at the LM's shape [8, 12, 2048, 64] bf16, causal and
without the causal mask, on the lse of the tree's own K1 and delta from its
O: K2, K3, and K2 + K3 back to back, beside SDPA's backward (dQ, dK and dV
in one ``autograd.grad`` call: a yardstick the port never calls).

Prints one ``AB {...}`` JSON line a run and the card's name and power limit.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_port_fwd_ab as ab  # noqa: E402


def one(root, label):
    cs, fa = ab.load(root)
    res = {"label": label, "root": str(root)}
    shape = dict(B=8, H=12, G=12, L=2048, D=64)
    q, k, v, dout = cs._inputs(shape, 1)
    scale = shape["D"] ** -0.5
    for causal, tag in ((True, ""), (False, "_full")):
        out, lse = fa.flash_fwd(q, k, v, scale, causal)
        delta = fa._delta(out, dout)
        args = (q, k, v, dout, lse, delta, scale, causal)
        res["k2" + tag + "_ms"] = cs.time_ms(lambda: fa.flash_bwd_dq(*args))
        res["k3" + tag + "_ms"] = cs.time_ms(lambda: fa.flash_bwd_dkv(*args))
        res["k2k3" + tag + "_ms"] = cs.time_ms(
            lambda: (fa.flash_bwd_dq(*args), fa.flash_bwd_dkv(*args)))
        res["sdpa_bwd" + tag + "_ms"] = cs.sdpa_times(
            q, k, v, dout, causal, scale)["sdpa_bwd_ms"]
        del out, lse, delta, args
    print("AB " + json.dumps(res), flush=True)


if __name__ == "__main__":
    ab.main(one, __file__, __doc__)
