"""Ranks of the port's ring-attention checks (gloo, CPU).

Run through torch.multiprocessing by tests/test_torch_port_ring.py: every
rank builds the same seeded inputs with numpy, takes its shard of the
sequence (contiguous or zigzag), runs ``ring_attention`` (and the ring
Transformer through ``make_train_step``) over the world as the mesh axis
"sp", and writes what it got to ``<out_dir>/rank<r>.pt``; 4 ranks also
lay out a 2-D ("dp", "sp") mesh. Imports torch,
numpy and the port only.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
import horovod_tpu_torch.ops.flash_attention  # noqa: F401
import horovod_tpu_torch.parallel.ring  # noqa: F401
import torch_port_bn_worker
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.parallel import (hybrid_mesh, make_train_step,
                                        ring_attention, shard_lm_loss,
                                        zigzag_shard)

fa = sys.modules["horovod_tpu_torch.ops.flash_attention"]
ring_mod = sys.modules["horovod_tpu_torch.parallel.ring"]

# name -> (ranks, B, global L, H, G, D, causal, schedule); the shapes of
# tests/test_parallel.py's ring tests
RING_CASES = {
    "n2-contiguous": (2, 1, 256, 2, 2, 16, True, "contiguous"),
    "n2-contiguous-full": (2, 1, 2048, 1, 1, 16, False, "contiguous"),
    "n2-gqa": (2, 1, 256, 4, 2, 16, True, "contiguous"),
    "n2-zigzag": (2, 1, 512, 2, 2, 16, True, "zigzag"),
    "n4-contiguous": (4, 2, 512, 2, 2, 16, True, "contiguous"),
    "n4-zigzag": (4, 1, 4096, 2, 2, 16, True, "zigzag"),
}
# the same, with fused rotary (``rotary_base=ROPE``)
ROTARY_CASES = {
    "n2-contiguous-rope": (2, 1, 256, 4, 2, 16, True, "contiguous"),
    "n2-zigzag-rope": (2, 1, 512, 4, 2, 16, True, "zigzag"),
    "n4-contiguous-rope": (4, 1, 512, 2, 2, 16, True, "contiguous"),
    "n4-zigzag-rope": (4, 1, 1024, 2, 2, 16, True, "zigzag"),
    # GQA 3 at a head dim of 32: the rotated k shards of 2 kv heads travel
    # the ring under 6 query heads
    "n2-zigzag-gqa3-rope": (2, 1, 512, 6, 2, 32, True, "zigzag"),
    "n4-zigzag-gqa3-rope": (4, 1, 1024, 6, 2, 32, True, "zigzag"),
}
ROPE = 10000.0
# name -> (ranks, B, global L, schedule): the ring Transformer
LM = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64,
          mlp_dim=256, max_seq_len=512)
LM_CASES = {
    "lm-zigzag": (2, 2, 512, "zigzag"),
    "lm-contiguous": (2, 2, 256, "contiguous"),
}
# plain step versions whose calls a rank counts
COUNTED = ("flash_ring_step_ref", "flash_ring_bwd_dq_ref",
           "flash_ring_bwd_dkv_ref")


def ring_case(case):
    """(ranks, B, L, H, G, D, causal, schedule, rotary base or None)."""
    if case in ROTARY_CASES:
        return ROTARY_CASES[case] + (ROPE,)
    return RING_CASES[case] + (None,)


def ring_inputs(case):
    """q, dout [B, L, H, D], k, v [B, L, G, D] float32 over the global
    sequence, in natural order."""
    _, B, L, H, G, D, _, _, _ = ring_case(case)
    seed = (100 + sorted(ROTARY_CASES).index(case) if case in ROTARY_CASES
            else sorted(RING_CASES).index(case))
    rng = np.random.RandomState(seed)
    q = rng.randn(B, L, H, D).astype(np.float32)
    k = rng.randn(B, L, G, D).astype(np.float32)
    v = rng.randn(B, L, G, D).astype(np.float32)
    w = rng.randn(B, L, H, D).astype(np.float32)
    return q, k, v, w


def lm_tokens(case):
    _, B, L, _ = LM_CASES[case]
    return np.random.RandomState(7).randint(
        0, LM["vocab_size"], (B, L)).astype(np.int64)


def shard(x, n, rank, schedule, axis=1):
    """This rank's part of a global sequence axis under ``schedule``."""
    if schedule == "zigzag":
        x = zigzag_shard(x, n, axis)
    return torch.chunk(x, n, dim=axis)[rank]


class _Counting:
    """Counts the calls of a function in its module (by default the plain
    step versions in flash_attention) and keeps their positional
    arguments."""

    def __init__(self, name, module=fa):
        self.name, self.module = name, module
        self.fn, self.calls, self.args = getattr(module, name), 0, []
        setattr(module, name, self)

    def __call__(self, *args):
        self.calls += 1
        self.args.append(args)
        return self.fn(*args)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def run_ring(rank, size, store_path, out_dir):
    """Every case of RING_CASES, ROTARY_CASES and LM_CASES for ``size``
    ranks."""
    torch.set_num_threads(2)
    torch_port_bn_worker._start(rank, size, store_path)
    try:
        hybrid_mesh((size,), ("sp",))
        got = {}
        for case in list(RING_CASES) + list(ROTARY_CASES):
            n, _, _, _, _, _, causal, schedule, rope = ring_case(case)
            if n != size:
                continue
            counters = [_Counting(name) for name in COUNTED]
            # the ring's rotary pass (one call per rotated shard)
            rotations = _Counting("rope_rotate", ring_mod)
            q, k, v, w = (shard(torch.from_numpy(a), n, rank, schedule)
                          for a in ring_inputs(case))
            q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
            out = ring_attention(q, k, v, "sp", causal=causal,
                                 schedule=schedule, rotary_base=rope)
            in_forward = rotations.calls
            (out * w).sum().backward()
            got[case] = dict(
                out=out.detach(), dq=q.grad, dk=k.grad, dv=v.grad,
                calls={c.name: c.calls for c in counters},
                # calls with a rotary base (the steps' last argument)
                rotary_calls={c.name: sum(a[-1] is not None for a in c.args)
                              for c in counters},
                rope_rotate=[(tuple(a[0].shape), a[1])
                             for a in rotations.args],
                rope_rotate_in_backward=rotations.calls - in_forward)
            for c in counters + [rotations]:
                c.restore()
        for case, (n, _, L, schedule) in LM_CASES.items():
            if n == size:
                got[case] = run_lm(case, rank, size, out_dir)
        if size == 4:  # a 2-D mesh: each rank's group along each axis
            mesh = hybrid_mesh((2, -1), ("dp", "sp"))
            got["mesh"] = {name: dist.get_process_group_ranks(group)
                           for name, group in mesh.groups.items()}
        torch.save(got, "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()


def run_lm(case, rank, size, out_dir):
    """The ring Transformer on this rank's shard, with the weights the test
    converted from flax: its logits, then one make_train_step step."""
    _, B, L, schedule = LM_CASES[case]
    cfg = TransformerConfig(attention="ring", sp_axis="sp",
                            sp_schedule=schedule, dtype=torch.float32, **LM)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(torch.load("%s/lm_state.pt" % out_dir))
    tokens = torch.from_numpy(lm_tokens(case))
    positions = torch.arange(L).expand(B, L)
    labels = torch.roll(tokens, -1, dims=1)  # in natural order
    batch = {k: shard(t, size, rank, schedule) for k, t in
             (("tokens", tokens), ("positions", positions),
              ("labels", labels))}
    with torch.no_grad():
        logits = model(batch["tokens"], batch["positions"])
    step = make_train_step(model, shard_lm_loss,
                           torch.optim.SGD(model.parameters(), lr=0.1),
                           device="cpu")
    loss = step(batch)
    return dict(logits=logits, loss=loss,
                grads={k: p.grad.clone()
                       for k, p in model.named_parameters()})


def spawn(out_dir, size, timeout=240):
    return torch_port_bn_worker.spawn(run_ring, out_dir, size=size,
                                      timeout=timeout)
