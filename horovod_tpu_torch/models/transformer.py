"""Decoder-only transformer LM, the model of the port's training path.

Counterpart of ``horovod_tpu/models/transformer.py``: pre-norm blocks,
RMSNorm, rotary position embedding applied to q and k outside the
attention kernel (at the positions the caller passes, global ones for a
sequence shard) or, with ``rope_fused=True`` under flash, ring or Ulysses
attention, inside the kernels, attention ``"dense"`` (plain PyTorch),
``"flash"`` (the Hopper kernels of ``ops/flash_attention``), ``"ring"`` or
``"ulysses"`` (sequence-parallel over the mesh axis ``sp_axis``,
``parallel/ring.py``), GQA through ``num_kv_heads``, a SiLU MLP or, every
``moe_every``-th block, a Switch MoE (``parallel/expert.py``, experts
sharded over ``ep_axis``), Megatron tensor parallelism over ``tp_axis``
(build with ``cfg.local(tp_size)``), and an untied lm_head.

Precision follows flax's ``dtype=``/``param_dtype=``: parameters are
float32, and with ``cfg.dtype=torch.bfloat16`` each product casts its
input and weight to bf16 explicitly (no autocast), so a float32 config
computes exactly in float32. RMSNorm takes its statistics in float32.
Parameter layouts are PyTorch's (``Linear.weight`` is [out, in]);
``horovod_tpu_torch.convert`` maps a flax parameter tree onto them.
"""

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.ops.agc import tag_units
from horovod_tpu_torch.ops.flash_attention import apply_rotary, flash_attention
from horovod_tpu_torch.parallel import _axis
from horovod_tpu_torch.parallel.expert import MoeMlp
from horovod_tpu_torch.parallel.ring import ring_attention, ulysses_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config, every field.

    ``attention``: "dense", "flash", "ring" or "ulysses" (the last two with
    ``sp_axis``; "ring" with ``sp_schedule``). ``rope_fused=True`` rotates
    q and k inside the flash, ring or Ulysses kernels (``rotary_base=
    rope_base``), at positions 0..L-1 of the sequence (the ring: its
    shards' global positions): the ``positions`` the model is given are
    then ignored, as in the JAX package, so packed sequences or shifted
    windows need ``rope_fused=False``. Dense attention rotates outside
    either way.

    ``tp_axis``: the model runs as one tp shard (``num_heads``,
    ``num_kv_heads`` and ``mlp_dim`` are the local sizes: build it from
    ``local(tp_size)``) and sums the partial products of the out and mlp_out
    projections over the axis. ``moe_experts``: every ``moe_every``-th
    block (``i % moe_every == moe_every - 1``) swaps its MLP for a
    ``MoeMlp`` of that many experts (top ``moe_top_k``), each rank holding
    ``moe_experts / ep_size`` of them with ``ep_axis``. MoE and tp do not
    combine (the reference's ``ValueError``).

    With ``attention="flash"`` on a GPU the kernels' products take bf16
    inputs whatever ``dtype`` is: a float32 config gets f32 softmax and
    accumulators but bf16-rounded q, k, v, P and dS. On the CPU (the plain
    versions) and with ``attention="dense"`` float32 is exact."""
    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 12
    embed_dim: int = 768
    mlp_dim: int = 3072
    max_seq_len: int = 8192
    attention: str = "dense"      # dense | flash | ring | ulysses
    num_kv_heads: Optional[int] = None
    rope_fused: bool = False
    rope_base: float = 10000.0
    sp_axis: Optional[str] = None
    sp_schedule: str = "contiguous"
    tp_axis: Optional[str] = None
    head_dim: Optional[int] = None
    moe_experts: Optional[int] = None
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1
    ep_axis: Optional[str] = None
    ep_size: int = 1
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.attention not in ("dense", "flash", "ring", "ulysses"):
            raise ValueError("attention=%r is not dense|flash|ring|ulysses"
                             % self.attention)
        if self.attention in ("ring", "ulysses") and not self.sp_axis:
            raise ValueError("attention=%r needs sp_axis, the mesh axis "
                             "that holds the sequence shards"
                             % self.attention)
        if self.moe_experts is not None and self.tp_axis is not None:
            # The MoE branch neither sums like the row-parallel mlp_out nor
            # shards experts by tp: the activations would diverge across
            # tp shards.
            raise ValueError("moe_experts cannot be combined with "
                             "tp_axis (MoE blocks are ep-parallel, "
                             "not tensor-parallel)")
        G = self.num_kv_heads or self.num_heads
        if self.num_heads % G:
            raise ValueError("num_kv_heads=%d must divide num_heads=%d"
                             % (G, self.num_heads))

    def local(self, tp_size):
        """The per-shard config for ``tp_size``-way tensor parallelism."""
        if self.num_heads % tp_size or self.mlp_dim % tp_size:
            raise ValueError(
                "tp_size=%d must divide both num_heads=%d and "
                "mlp_dim=%d" % (tp_size, self.num_heads, self.mlp_dim))
        kv = self.num_kv_heads
        if kv is not None:
            if kv % tp_size:
                raise ValueError(
                    "tp_size=%d must divide num_kv_heads=%d (tensor "
                    "parallelism shards the kv heads too)"
                    % (tp_size, kv))
            kv = kv // tp_size
        return dataclasses.replace(
            self, num_heads=self.num_heads // tp_size,
            num_kv_heads=kv,
            mlp_dim=self.mlp_dim // tp_size,
            head_dim=self.head_dim or self.embed_dim // self.num_heads)


def _rotary(x, positions, base=10000.0):
    """Rotary embedding of [B, L, H, D]; positions [B, L] global, the same
    for every head."""
    return apply_rotary(x, positions[..., None], base)


def _linear(x, layer, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype))


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: y = x * rsqrt(mean(x^2) + eps) * scale, the
    statistics and the product in float32, the result in ``dtype``."""

    def __init__(self, dim, dtype, eps=1e-6, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mul = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (xf * (mul * self.weight)).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.head_dim = cfg.head_dim or cfg.embed_dim // cfg.num_heads
        self.kv_heads = cfg.num_kv_heads or cfg.num_heads
        E, H, G, D = (cfg.embed_dim, cfg.num_heads, self.kv_heads,
                      self.head_dim)
        lin = lambda i, o: nn.Linear(i, o, bias=False, device=device)  # noqa: E731
        self.query = lin(E, H * D)
        self.key = lin(E, G * D)
        self.value = lin(E, G * D)
        self.out = lin(H * D, E)

    def agc_units(self):
        """AGC's unit of q, k and v (``ops/agc.py``): each is flax's
        DenseGeneral kernel [E, heads, D], whose unit is one d across the
        heads and E, stored as a ``Linear`` [heads * D, E]."""
        view = (-1, self.head_dim, self.cfg.embed_dim)
        return {name + ".weight": (1, view)
                for name in ("query", "key", "value")}

    def forward(self, x, positions):
        cfg = self.cfg
        B, L, _ = x.shape
        H, G, D = cfg.num_heads, self.kv_heads, self.head_dim
        q = _linear(x, self.query, cfg.dtype).view(B, L, H, D)
        k = _linear(x, self.key, cfg.dtype).view(B, L, G, D)
        v = _linear(x, self.value, cfg.dtype).view(B, L, G, D)
        fused = (cfg.rope_fused and
                 cfg.attention in ("flash", "ring", "ulysses"))
        if not fused:
            q = _rotary(q, positions, cfg.rope_base)
            k = _rotary(k, positions, cfg.rope_base)
        rb = cfg.rope_base if fused else None
        if cfg.attention == "flash":
            o = flash_attention(q, k, v, causal=True, rotary_base=rb)
        elif cfg.attention == "ring":
            o = ring_attention(q, k, v, cfg.sp_axis, causal=True,
                               schedule=cfg.sp_schedule, rotary_base=rb)
        elif cfg.attention == "ulysses":
            o = ulysses_attention(q, k, v, cfg.sp_axis, causal=True,
                                  rotary_base=rb)
        else:
            o = _dense_attention(q, k, v, D ** -0.5)
        out = _linear(o.reshape(B, L, H * D), self.out, cfg.dtype)
        if cfg.tp_axis is not None:
            # each tp shard projected its local heads: a partial sum
            out = _axis.psum(out, cfg.tp_axis)
        return out


def _dense_attention(q, k, v, scale):
    """Plain causal attention over [B, L, H, D]: f32 scores and softmax,
    probabilities cast to v's dtype for the product (as the JAX model's
    dense path)."""
    H, G = q.shape[2], k.shape[2]
    if G != H:
        k = k.repeat_interleave(H // G, dim=2)
        v = v.repeat_interleave(H // G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    L = s.shape[-1]
    above = torch.ones(L, L, dtype=torch.bool, device=s.device).triu_(1)
    p = torch.softmax(s.masked_fill(above, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


class Block(nn.Module):
    """A pre-norm block: attention, then the SiLU MLP or, with ``moe``, a
    ``MoeMlp`` (``cfg.moe_experts`` experts)."""

    def __init__(self, cfg, moe=False, device=None):
        super().__init__()
        self.cfg = cfg
        E = cfg.embed_dim
        self.norm1 = RMSNorm(E, cfg.dtype, device=device)
        self.attn = Attention(cfg, device=device)
        self.norm2 = RMSNorm(E, cfg.dtype, device=device)
        self.moe = moe
        if moe:
            self.moe_mlp = MoeMlp(E, cfg.moe_experts, cfg.mlp_dim,
                                  capacity_factor=cfg.moe_capacity_factor,
                                  ep_axis=cfg.ep_axis, ep_size=cfg.ep_size,
                                  top_k=cfg.moe_top_k, dtype=cfg.dtype,
                                  device=device)
        else:
            self.mlp_in = nn.Linear(E, cfg.mlp_dim, bias=False,
                                    device=device)
            self.mlp_out = nn.Linear(cfg.mlp_dim, E, bias=False,
                                     device=device)

    def forward(self, x, positions):
        cfg = self.cfg
        x = x + self.attn(self.norm1(x), positions)
        if self.moe:
            return x + self.moe_mlp(self.norm2(x))
        h = F.silu(_linear(self.norm2(x), self.mlp_in, cfg.dtype))
        h = _linear(h, self.mlp_out, cfg.dtype)
        if cfg.tp_axis is not None:
            # column-parallel mlp_in, row-parallel mlp_out: a partial sum
            h = _axis.psum(h, cfg.tp_axis)
        return x + h


class Transformer(nn.Module):
    """tokens [B, L] (+ positions [B, L]) -> f32 logits [B, L, vocab], or
    the final normed hidden states with ``return_hidden=True``.

    Built on ``device`` (default: the GPU; ``"cpu"`` for tests), its
    weights drawn from ``generator`` (a ``torch.Generator`` on that
    device) with flax's default scales: embedding N(0, 1/E), each linear
    N(0, 1/fan_in), norms 1, MoE weights N(0, 0.02)."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim,
                                  device=device)
        self.blocks = nn.ModuleList(
            Block(cfg, moe=(cfg.moe_experts is not None and
                            i % cfg.moe_every == cfg.moe_every - 1),
                  device=device)
            for i in range(cfg.num_layers))
        self.norm_f = RMSNorm(cfg.embed_dim, cfg.dtype, device=device)
        self.lm_head = nn.Linear(cfg.embed_dim, cfg.vocab_size, bias=False,
                                 device=device)
        self.reset_parameters(generator)
        tag_units(self)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5,
                                 generator=generator)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, m.embedding_dim ** -0.5,
                                 generator=generator)
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, MoeMlp):
                m.reset_parameters(generator)

    def forward(self, tokens, positions=None, return_hidden=False):
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        x = self.embed(tokens).to(cfg.dtype)
        for block in self.blocks:
            x = block(x, positions)
        x = self.norm_f(x)
        if return_hidden:
            return x
        return _linear(x, self.lm_head, cfg.dtype).float()
