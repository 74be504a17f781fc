#!/usr/bin/env python3
"""Times the flash backward kernels K2 and K3 and the ring's backward steps
K5 and K6 of this tree against another tree's, in one call on one GPU.

    python3 tests/torch_port_bwd_ab.py OTHER_ROOT [--rounds N]

OTHER_ROOT holds another version's ``chip_smoke.py`` and
``horovod_tpu_torch/`` (e.g. ``git archive`` of the parent commit, unpacked
under the git-ignored ``horovod_tpu_torch/ops/_build/``). Runs other, this,
this, other (N rounds) in separate processes on the runner of
``tests/torch_port_fwd_ab.py``, each timing its own tree's kernels with its
``chip_smoke.time_ms``, at the LM's shape [8, 12, 2048, 64] bf16, causal and
without the causal mask, on the lse of the tree's own K1 and delta from its
O: K2, K3, and K2 + K3 back to back, beside SDPA's backward (dQ, dK and dV
in one ``autograd.grad`` call: a yardstick the port never calls). Then K5,
K6 and K5 + K6 on the lse of the tree's own K4 and delta from its state:

- at the sp phase's launch, [2, 12, 8192, 64] causal, zigzag chunks
  (0, 4096) on one rank, beside SDPA's causal backward at that shape;
- at one off-diagonal ring step, [2, 12, 2048, 64], q at offset 2048 and
  k/v at 0 (every tile visible), beside SDPA's backward without the mask.

The timed repeats add into the same f32 sums: the same tiles run. Last,
at the lc phase's launch, [2, 6, 8192, 128] with 2 kv heads, causal: K2
and K3, and, where the tree has fused rotary, K2_rot and K3_rot through
their wrappers (``k2_rot_lc_ms``, ``k3_rot_lc_ms``: a tree with the rotary
pass rotates q and k in each call), ``flash_backward`` with and without
rotary (``bwd_rot_lc_ms``, ``bwd_lc_ms``: delta, any rotation, K2 and K3),
and the model's rotary backward (``bwd_rot_model_lc_ms``: a tree whose
forward keeps the rotated q and k runs delta, K2_rot and K3_rot on them; an
older tree runs ``flash_backward`` with rotary, which rotates); K5_rot and
K6_rot at the sp launch; and K5 and K6 at the lc_sp phase's launch (the lc
widths, zigzag chunks (0, 4096) on one rank) without rotary and with it
through their wrappers, and the rotary ring's backward there
(``ring_rot_lcsp_ms``: a tree whose ring forward keeps the rotated shards
runs K5 and K6 on copies rotated beforehand, outside the timing; a tree
with the backward's rotary pass rotates q and k once and runs K5 and K6 on
them; an older tree runs K5_rot and K6_rot).

Prints one ``AB {...}`` JSON line a run and the card's name and power limit.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_port_fwd_ab as ab  # noqa: E402


def one(root, label):
    import torch
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
    del q, k, v, dout
    for tag, L, q_off, kv_off in (("sp", 8192, (0, 4096), (0, 4096)),
                                  ("off", 2048, (2048,), (0,))):
        q, k, v, dout = cs._inputs(dict(B=2, H=12, G=12, L=L, D=64), 2)
        o = torch.zeros(q.shape, device="cuda")
        m = torch.full(q.shape[:3], float("-inf"), device="cuda")
        l = torch.zeros(q.shape[:3], device="cuda")
        fa.flash_ring_step(q, k, v, o, m, l, q_off, kv_off, scale, True)
        lse = m + torch.log(l)
        delta = fa._delta((o / l[..., None]).to(q.dtype), dout)
        dq = torch.zeros(q.shape, device="cuda")
        dk, dv = (torch.zeros(k.shape, device="cuda") for _ in range(2))
        args = (q, k, v, dout, lse, delta)
        offs = (q_off, kv_off, scale, True)

        def k5():
            fa.flash_ring_bwd_dq(*args, dq, *offs)

        def k6():
            fa.flash_ring_bwd_dkv(*args, dk, dv, *offs)
        res["k5_%s_ms" % tag] = cs.time_ms(k5)
        res["k6_%s_ms" % tag] = cs.time_ms(k6)
        res["k5k6_%s_ms" % tag] = cs.time_ms(lambda: (k5(), k6()))
        res["sdpa_bwd_%s_ms" % tag] = cs.sdpa_times(
            q, k, v, dout, tag == "sp", scale)["sdpa_bwd_ms"]
        if tag == "sp" and ab.rotary(fa):
            rb = dict(rotary_base=10000.0)
            res["k5_rot_sp_ms"] = cs.time_ms(lambda: fa.flash_ring_bwd_dq(
                *args, dq, *offs, **rb))
            res["k6_rot_sp_ms"] = cs.time_ms(lambda: fa.flash_ring_bwd_dkv(
                *args, dk, dv, *offs, **rb))
        del q, k, v, dout, o, m, l, lse, delta, dq, dk, dv, args
    q, k, v, dout = cs._inputs(dict(B=2, H=6, G=2, L=8192, D=128), 3)
    scale = 128 ** -0.5
    for tag, rb in (("", {}), ("_rot", dict(rotary_base=10000.0))):
        if rb and not ab.rotary(fa):
            continue
        out, lse = fa.flash_fwd(q, k, v, scale, True, **rb)
        delta = fa._delta(out, dout)
        args = (q, k, v, dout, lse, delta, scale, True)
        res["k2%s_lc_ms" % tag] = cs.time_ms(
            lambda: fa.flash_bwd_dq(*args, **rb))
        res["k3%s_lc_ms" % tag] = cs.time_ms(
            lambda: fa.flash_bwd_dkv(*args, **rb))
        res["bwd%s_lc_ms" % tag] = cs.time_ms(lambda: fa.flash_backward(
            q, k, v, out, lse, dout, scale, True, **rb))
        if rb and hasattr(fa, "_backward"):  # on the forward's copies
            qr, kr = fa._rotated(q, k, rb["rotary_base"])
            res["bwd_rot_model_lc_ms"] = cs.time_ms(lambda: fa._backward(
                qr, kr, v, out, lse, dout, scale, True, rb["rotary_base"]))
            del qr, kr
        elif rb:
            res["bwd_rot_model_lc_ms"] = res["bwd_rot_lc_ms"]
        del out, lse, delta, args
    if ab.rotary(fa):
        res.update(lc_sp(cs, fa, q, k, v, dout, scale))
    print("AB " + json.dumps(res), flush=True)


def lc_sp(cs, fa, q, k, v, dout, scale):
    """K5 and K6 at the lc_sp launch, without and with rotary, and the
    rotary ring's backward there, on the lse of the tree's own K4_rot."""
    import torch
    rb, offs = 10000.0, (0, q.shape[2] // 2)
    o = torch.zeros(q.shape, device="cuda")
    m = torch.full(q.shape[:3], float("-inf"), device="cuda")
    l = torch.zeros(q.shape[:3], device="cuda")
    fa.flash_ring_step(q, k, v, o, m, l, offs, offs, scale, True, rb)
    lse = m + torch.log(l)
    delta = fa._delta((o / l[..., None]).to(q.dtype), dout)
    dq = torch.zeros(q.shape, device="cuda")
    dk, dv = (torch.zeros(k.shape, device="cuda") for _ in range(2))
    ring = (offs, offs, scale, True)

    def k5(qq, kk, *rot):
        fa.flash_ring_bwd_dq(qq, kk, v, dout, lse, delta, dq, *ring, *rot)

    def k6(qq, kk, *rot):
        fa.flash_ring_bwd_dkv(qq, kk, v, dout, lse, delta, dk, dv, *ring,
                              *rot)

    import horovod_tpu_torch.parallel.ring  # noqa: F401
    ring_mod = sys.modules["horovod_tpu_torch.parallel.ring"]
    if hasattr(ring_mod, "rotate_shards"):  # the forward rotated them
        qr, kr = ring_mod.rotate_shards(q, k, offs, offs, rb)

    def ring_rot():
        if hasattr(ring_mod, "rotate_shards"):
            k5(qr, kr)
            k6(qr, kr)
        elif hasattr(fa, "rope_rotate"):  # rotated once, K5 and K6 on them
            qr2, kr2 = (fa.rope_rotate(q, offs, rb),
                        fa.rope_rotate(k, offs, rb))
            k5(qr2, kr2)
            k6(qr2, kr2)
        else:
            k5(q, k, rb)
            k6(q, k, rb)
    return {"k5_lcsp_ms": cs.time_ms(lambda: k5(q, k)),
            "k6_lcsp_ms": cs.time_ms(lambda: k6(q, k)),
            "k5_rot_lcsp_ms": cs.time_ms(lambda: k5(q, k, rb)),
            "k6_rot_lcsp_ms": cs.time_ms(lambda: k6(q, k, rb)),
            "ring_lcsp_ms": cs.time_ms(lambda: (k5(q, k), k6(q, k))),
            "ring_rot_lcsp_ms": cs.time_ms(ring_rot)}


if __name__ == "__main__":
    ab.main(one, __file__, __doc__, compare=False)
