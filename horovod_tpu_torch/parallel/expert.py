"""Expert parallelism: Switch (top-1) and GShard-style (top-2) mixture of
experts, the expert dim sharded over an ``ep`` mesh axis.

Counterpart of ``horovod_tpu/parallel/expert.py``, arithmetic for
arithmetic:

- static shapes: each expert has a fixed capacity ``C = ceil(T/E *
  capacity_factor)``; a token whose queue position is past it is dropped
  (its row of the dispatch tensor is all zero, so the MoE adds nothing and
  the residual carries it);
- routing in float32: softmax of the router logits, ``argmax`` (first index
  on ties, as ``jnp.argmax``), first choices of all tokens queued before
  any second choice (GShard), the chosen gates renormalised only for k > 1,
  the Switch aux loss from first-choice fractions;
- dispatch and combine as einsums over the [T, E, C] one-hot tensors, cast
  to the tokens' dtype as the reference does;
- with ``ep_axis``, the expert inputs [E, C, D] go through a tiled
  all-to-all (split on experts, concatenated on capacity) so each rank runs
  its E/ep local experts on every rank's tokens, and back
  (``_axis.all_to_all``, whose backward is the inverse exchange).

Parameters are plain float32 ``nn.Parameter``s in flax's layout: ``router``
[D, E] (replicated), ``w_in`` [E_local, D, F], ``w_out`` [E_local, F, D]
(dim 0 sharded over ``ep``), so converting flax weights is the identity a
leaf. The einsums are plain PyTorch, as they are plain XLA in the reference:
no Pallas kernel here.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.parallel import _axis

# the parameters held as dim-0 shards of the expert dim
_EXPERT_PARAMS = ("w_in", "w_out")


def switch_dispatch(router_logits, capacity):
    """Top-1 (Switch) routing with a static per-expert capacity.

    router_logits: [T, E] (softmax in float32). Returns (dispatch [T, E, C]
    f32 one-hot, combine [T, E, C] f32 gate-weighted, aux_loss: E *
    sum(frac_tokens_e * mean_prob_e))."""
    return topk_dispatch(router_logits, capacity, k=1)


def topk_dispatch(router_logits, capacity, k=2):
    """Top-k routing (GShard's for k = 2) with a static per-expert capacity:
    each choice takes one capacity slot, round r's tokens queued after all
    of round r - 1's; for k > 1 the chosen gates are renormalised to sum
    to 1. Returns (dispatch, combine, aux_loss) as ``switch_dispatch``."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    onehots, gates = [], []
    masked = probs
    for _ in range(k):
        oh = F.one_hot(torch.argmax(masked, dim=-1), E).float()
        onehots.append(oh)
        gates.append(torch.sum(probs * oh, dim=-1))
        masked = masked * (1.0 - oh)
    if k > 1:
        denom = sum(gates)
        gates = [g / torch.clamp(denom, min=1e-9) for g in gates]

    slots = torch.arange(capacity, device=probs.device)
    prior = torch.zeros(E, device=probs.device)
    dispatch = combine = None
    for oh, gate in zip(onehots, gates):
        pos = (torch.sum((torch.cumsum(oh, dim=0) + prior) * oh, dim=-1)
               .to(torch.int32) - 1)                                  # [T]
        # a position past the capacity matches no slot: the drop
        # (F.one_hot would raise where jax.nn.one_hot gives zeros)
        d = oh[:, :, None] * (pos[:, None] == slots).float()[:, None, :]
        c = d * gate[:, None, None]
        dispatch = d if dispatch is None else dispatch + d
        combine = c if combine is None else combine + c
        prior = prior + torch.sum(oh, dim=0)

    frac = torch.mean(onehots[0], dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = E * torch.sum(frac * mean_prob)
    return dispatch, combine, aux


def moe_capacity(tokens, num_experts, capacity_factor):
    """Static per-expert capacity (a Python int)."""
    return max(1, int(math.ceil(tokens / num_experts * capacity_factor)))


def moe_ffn(x, router_w, w_in, w_out, capacity_factor=1.25, ep_axis=None,
            act=F.silu, top_k=1):
    """Switch (``top_k=1``) or GShard-style (``top_k=2``) MoE feed-forward
    over flattened tokens.

    x: [T, D]; router_w: [D, E] (replicated); w_in: [E_local, D, F], w_out:
    [E_local, F, D], E_local = E without ``ep_axis``, E / ep with it (the
    expert dim sharded over the axis). Returns (y [T, D] in x's dtype,
    aux_loss f32 scalar)."""
    T, D = x.shape
    E = router_w.shape[1]
    ep = 1 if ep_axis is None else _axis.axis_size(ep_axis)
    if w_in.shape[0] * ep != E:
        raise ValueError("expert shards (%d local x ep=%d) != num_experts %d"
                         % (w_in.shape[0], ep, E))
    capacity = moe_capacity(T, E, capacity_factor)
    logits = x.float() @ router_w.float()
    dispatch, combine, aux = topk_dispatch(logits, capacity, k=top_k)

    expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    if ep_axis is not None:
        # [E, C, D] -> [E/ep, ep*C, D]: this rank's experts' slots from
        # every rank's tokens
        expert_in = _axis.all_to_all(expert_in, ep_axis, 0, 1)
    h = act(torch.einsum("ecd,edf->ecf", expert_in, w_in))
    out = torch.einsum("ecf,efd->ecd", h, w_out)
    if ep_axis is not None:
        out = _axis.all_to_all(out, ep_axis, 1, 0)  # back to [E, C, D]
    y = torch.einsum("tec,ecd->td", combine.to(x.dtype), out)
    return y.to(x.dtype), aux


class MoeMlp(nn.Module):
    """The MoE replacement of a transformer MLP: [B, L, D] -> [B, L, D].
    Its last forward's Switch aux loss is ``aux_loss`` (flax sows it into
    ``intermediates/moe_aux_loss``); ``moe_aux_loss(model)`` sums them.

    ``num_experts`` is global; ``ep_size`` the expert-parallel degree the
    module runs under, so each rank holds ``num_experts / ep_size``
    experts (load them with ``convert.shard_state_dict``). Weights N(0,
    0.02) from ``generator``, as flax's ``normal(0.02)``; built on
    ``device`` (default: the GPU)."""

    def __init__(self, embed_dim, num_experts, mlp_dim, capacity_factor=1.25,
                 ep_axis=None, ep_size=1, top_k=1, dtype=torch.bfloat16,
                 device=None, generator=None):
        super().__init__()
        if num_experts % ep_size:
            raise ValueError("ep_size=%d must divide num_experts=%d"
                             % (ep_size, num_experts))
        device = resolve_device(device)
        e_local = num_experts // ep_size
        self.capacity_factor, self.ep_axis = capacity_factor, ep_axis
        self.top_k, self.dtype = top_k, dtype
        self.router = nn.Parameter(torch.empty(embed_dim, num_experts,
                                               device=device))
        self.w_in = nn.Parameter(torch.empty(e_local, embed_dim, mlp_dim,
                                             device=device))
        self.w_out = nn.Parameter(torch.empty(e_local, mlp_dim, embed_dim,
                                              device=device))
        self.aux_loss = None
        self.reset_parameters(generator)

    def agc_units(self):
        """AGC's unit (``ops/agc.py``): flax's layout is kept, so the last
        dim."""
        return {name: (-1, None) for name in ("router", "w_in", "w_out")}

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for p in (self.router, self.w_in, self.w_out):
            p.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        B, L, D = x.shape
        y, self.aux_loss = moe_ffn(
            x.reshape(-1, D), self.router, self.w_in.to(self.dtype),
            self.w_out.to(self.dtype), capacity_factor=self.capacity_factor,
            ep_axis=self.ep_axis, top_k=self.top_k)
        return y.reshape(B, L, D)


def moe_aux_loss(model):
    """The sum of the aux losses of ``model``'s ``MoeMlp``s from their last
    forward, in module order (``sum(intermediates["moe_aux_loss"])``)."""
    losses = [m.aux_loss for m in model.modules() if isinstance(m, MoeMlp)]
    if any(a is None for a in losses):
        raise RuntimeError("a MoeMlp has not run forward yet")
    return sum(losses)


def _is_expert(name):
    return name.split(".")[-1] in _EXPERT_PARAMS


def ep_param_specs(params):
    """{name: sharded dim}: 0 for the expert weights (``w_in``, ``w_out``,
    sharded over the ep axis), None for every other (replicated).
    ``params`` is a module, or a dict keyed by parameter name (a
    ``state_dict()``)."""
    return {name: 0 if _is_expert(name) else None
            for name in _names(params)}


def _names(params):
    if isinstance(params, nn.Module):
        return [n for n, _ in params.named_parameters()]
    return list(params)


def ep_grad_sync(grads, ep_axis="ep", dp_axis=None, average=False):
    """Synchronizes raw per-shard gradients ({name: tensor}) under expert
    parallelism; returns new ones.

    Differentiate a local (un-summed) loss on every rank, then call this.
    With tokens sharded over (dp x ep): the expert weights' gradients
    already hold every ep peer's tokens (the all-to-all's backward brings
    them to the owning rank), so they are summed over the dp axes only;
    every other gradient holds this rank's tokens only and is summed over
    dp and ep. ``average=True`` divides by dp x ep (the gradient of the
    mean of the local losses, ``tp_grad_sync``'s convention). ``dp_axis``
    is an axis name or a tuple of them."""
    dp_axes = ()
    if dp_axis is not None:
        dp_axes = (dp_axis,) if isinstance(dp_axis, str) else tuple(dp_axis)
    total = 1
    if average:
        for ax in dp_axes + (ep_axis,):
            total *= _axis.axis_size(ax)
    out = {}
    for name, g in grads.items():
        axes = list(dp_axes)
        if not _is_expert(name):
            axes.append(ep_axis)
        for ax in axes:
            g = _axis.psum(g, ax)
        if average:
            g = g / total
        out[name] = g
    return out
