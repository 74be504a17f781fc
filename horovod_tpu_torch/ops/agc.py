"""Adaptive gradient clipping (AGC), the optimizer knob that makes the
norm-free ResNets (``ResNet50NF``, ``ResNet101NF``) trainable.

Counterpart of ``horovod_tpu/ops/agc.py``. Each gradient is clipped so
that the norm of each of its units never exceeds ``clipping`` times the
norm of the same unit of the parameter:

    g_u <- g_u * clipping * max(||w_u||, eps) / ||g_u||   where that is less

A unit is one slice along the output axis. The reference reduces over
every axis of the flax leaf but the last; 1-D leaves and scalars are one
unit. The port keeps some leaves in another layout than flax
(``convert.py``), so each parameter carries its unit as ``agc_unit`` =
``(dim, view)``: the norms are taken over every dim of ``x.reshape(view)``
(``x`` itself for ``view`` None) but ``dim``. ``tag_units(model)`` sets it
from the modules, and the port's models call it when they are built:

- ``nn.Embedding`` [V, E] and the ``MoeMlp`` leaves (``router`` [E, X],
  ``w_in`` [X, E, M], ``w_out`` [X, M, E]) are flax's layout as it is:
  the unit is the last dim;
- a module may name its own with an ``agc_units()`` method, {parameter
  name: (dim, view)}: the attention's q, k, v ``Linear`` [H * D, E] come
  from a DenseGeneral [E, H, D] whose unit is one d across the heads and
  E, so they take ``((-1, D, E)`` viewed, dim 1); SkipGram's
  ``nce_weight`` [V, D] is flax's (dim -1);
- an untagged parameter of 2 dims or more is in torch's [out, in, ...]
  layout (Conv OIHW from HWIO, ``Linear`` [out, in] from [in, out]): the
  unit is dim 0.

``copy.deepcopy`` copies a parameter without its attributes: call
``tag_units`` on the copy.

The clip runs after the gradient reduction (``DistributedOptimizer(agc=)``
clips the averaged gradient, so every rank clips alike), and not under the
sharded update, whose flat shards have no units.
"""

import torch
import torch.nn as nn

from horovod_tpu_torch.common.ops import tree_flatten, tree_unflatten

LAST = (-1, None)


def tag_units(model):
    """Sets ``agc_unit`` on the parameters of ``model`` whose unit is not
    dim 0 (module docstring); returns ``model``."""
    for m in model.modules():
        units = {}
        if isinstance(m, nn.Embedding):
            units["weight"] = LAST
        if hasattr(m, "agc_units"):
            units.update(m.agc_units())
        for name, unit in units.items():
            m.get_parameter(name).agc_unit = unit
    return model


def unit_of(p):
    """(dim, view) of a parameter: its tag, else dim 0 (torch's layout)."""
    return getattr(p, "agc_unit", (0, None))


def unitwise_norm(x, unit=(0, None)):
    """Per-unit L2 norms of ``x`` in f32, shaped to broadcast against
    ``x.reshape(view)``; one norm for a tensor of at most one dim."""
    x = x.float()
    if x.dim() <= 1:
        return x.pow(2).sum().sqrt()
    dim, view = unit
    if view is not None:
        x = x.reshape(view)
    dim = dim % x.dim()
    dims = [d for d in range(x.dim()) if d != dim]
    return x.pow(2).sum(dims, keepdim=True).sqrt()


def _clip_one(g, p, clipping, eps, unit):
    """The reference's ``_clip_one``: ``g`` where its unit norm is within
    the limit, ``g * limit / norm`` where it is not."""
    shape = g.shape
    if g.dim() > 1 and unit[1] is not None:
        g = g.reshape(unit[1])
    g_norm = unitwise_norm(g, (unit[0], None))
    max_norm = clipping * torch.clamp(unitwise_norm(p, unit), min=eps)
    scale = max_norm / torch.clamp(g_norm, min=1e-16)
    out = torch.where(g_norm > max_norm, g * scale.to(g.dtype), g)
    return out.reshape(shape)


def agc_clip(grads, params, clipping=0.01, eps=1e-3):
    """Clips a tree of gradients (a tensor, or a dict, list or tuple of
    them) against the parameters at the same places of ``params``, leaf by
    leaf (NF-paper defaults). Each leaf's unit is its parameter's
    ``agc_unit``. Returns new tensors in the structure of ``grads``."""
    gs, ps = dict(tree_flatten(grads)), dict(tree_flatten(params))
    if gs.keys() != ps.keys():
        raise ValueError("grads and params differ in structure: %s"
                         % sorted(set(gs) ^ set(ps))[:5])
    out = {}
    for path, g in gs.items():
        p = ps[path]
        if g.shape != p.shape:
            raise ValueError("a gradient of shape %s against a parameter "
                             "of shape %s" % (tuple(g.shape),
                                              tuple(p.shape)))
        out[path] = _clip_one(g, p.detach(), clipping, eps, unit_of(p))
    return tree_unflatten(grads, out)


def adaptive_grad_clip(clipping=0.01, eps=1e-3):
    """AGC as a transformation in torch's idiom (the reference's optax
    ``GradientTransformation``): ``clip(params)`` clips the ``.grad`` of
    each parameter in place. Call it after the gradients are reduced and
    before ``optimizer.step()``, or let ``DistributedOptimizer(agc=)`` do
    it."""

    @torch.no_grad()
    def clip(params=None):
        if params is None:
            raise ValueError(
                "adaptive_grad_clip needs params: the clip threshold is "
                "relative to each parameter's unit-wise norm — call "
                "clip(params)")
        for p in params:
            if p.grad is not None:
                p.grad.copy_(_clip_one(p.grad, p, clipping, eps,
                                       unit_of(p)))

    return clip
