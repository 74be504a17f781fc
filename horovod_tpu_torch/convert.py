"""Carries flax parameters into the port's models.

``transformer_state_dict_from_jax(params_np, cfg)`` takes the flax
``params`` tree of ``horovod_tpu.models.Transformer`` as numpy arrays
(nested dicts) and returns the ``state_dict`` of
``horovod_tpu_torch.models.Transformer``. Layouts:

- ``embed/embedding`` [V, E] is ``nn.Embedding.weight`` as it is;
- ``attn/{query,key,value}/kernel`` [E, heads, D] (DenseGeneral) becomes
  the ``Linear`` weight [heads * D, E]; ``attn/out/kernel`` [H, D, E]
  becomes [E, H * D];
- ``mlp_in``, ``mlp_out`` and ``lm_head`` kernels [in, out] are
  transposed to [out, in];
- ``norm1``, ``norm2``, ``norm_f`` ``scale`` [E] is the RMSNorm weight;
- a MoE block's ``moe_mlp`` ``router`` [E, experts], ``w_in``
  [experts, E, M] and ``w_out`` [experts, M, E] are the ``MoeMlp``
  parameters as they are.

A local (tp-sharded) flax tree converts with the local config
(``cfg.local(tp)``). ``shard_state_dict(state, tp_size, tp_rank, ep_size,
ep_rank)`` slices a full port state dict to one tp or ep shard: the dims
of ``tensor_parallel.tp_param_specs`` and ``expert.ep_param_specs``.

``resnet_state_dict_from_jax(variables_np, model)`` takes the flax
``{"params", "batch_stats"}`` tree of ``horovod_tpu.models.ResNet`` as
numpy and returns the ``state_dict`` of the port's ``ResNet`` ``model``:

- conv ``kernel`` HWIO becomes OIHW;
- ``Dense_0`` ``kernel`` [in, out] becomes [out, in], ``bias`` as it is;
- BN ``scale``/``bias`` become ``weight``/``bias``, and ``batch_stats``
  ``mean``/``var`` become ``running_mean``/``running_var``.

flax names the unnamed submodules by class and position (``Conv_1``,
``BatchNorm_0`` or ``PallasBatchNorm_0``, ``BottleneckBlock_3``), and the
norm's class depends on ``norm=``; the converter matches on the position
only. ``norm="group"`` has ``GroupNorm_<i>`` scales and biases and no
``batch_stats``; ``norm="none"`` has no norm at all, so only the
convolutions and the head map.

The rest of the zoo, each from its flax variables as numpy:
``vgg16_state_dict_from_jax`` (``conv<i>_<j>``, ``fc0``, ``fc1``,
``head``: conv kernels and biases, dense kernels transposed; the port
flattens in flax's (h, w, c) order, so ``fc0`` needs no permutation),
``inception_v3_state_dict_from_jax`` (``_ConvBN_<i>`` in the port's
``ConvBN`` order, each a conv kernel and a BN with its ``batch_stats``;
``Dense_0``), ``mnist_state_dict_from_jax`` (``Conv_0``, ``Conv_1``,
``Dense_0``, ``Dense_1``) and ``skipgram_state_dict_from_jax``
(``embedding/embedding``, ``nce_weight``, ``nce_bias`` as they are).
"""

import re

import numpy as np
import torch

from horovod_tpu_torch.parallel.expert import ep_param_specs
from horovod_tpu_torch.parallel.tensor_parallel import tp_param_specs


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def transformer_state_dict_from_jax(params_np, cfg):
    sd = {"embed.weight": _t(params_np["embed"]["embedding"]),
          "norm_f.weight": _t(params_np["norm_f"]["scale"]),
          "lm_head.weight": _t(np.asarray(params_np["lm_head"]["kernel"]).T)}
    for i in range(cfg.num_layers):
        for name, t in block_state_dict_from_jax(
                params_np["block_%d" % i], cfg).items():
            sd["blocks.%d.%s" % (i, name)] = t
    return sd


def block_state_dict_from_jax(p, cfg):
    """The ``state_dict`` of one ``Block`` from flax's ``block_<i>`` tree."""
    E = cfg.embed_dim
    sd = {}
    attn = p["attn"]
    for name in ("query", "key", "value"):
        k = np.asarray(attn[name]["kernel"])
        sd["attn.%s.weight" % name] = _t(k.reshape(E, -1).T)
    sd["attn.out.weight"] = _t(
        np.asarray(attn["out"]["kernel"]).reshape(-1, E).T)
    sd["norm1.weight"] = _t(p["norm1"]["scale"])
    sd["norm2.weight"] = _t(p["norm2"]["scale"])
    if "moe_mlp" in p:
        for name in ("router", "w_in", "w_out"):
            sd["moe_mlp." + name] = _t(p["moe_mlp"][name])
    else:
        sd["mlp_in.weight"] = _t(np.asarray(p["mlp_in"]["kernel"]).T)
        sd["mlp_out.weight"] = _t(np.asarray(p["mlp_out"]["kernel"]).T)
    return sd


def shard_state_dict(state, tp_size=1, tp_rank=0, ep_size=1, ep_rank=0):
    """The shard of a full port state dict (or of any {name: tensor} of the
    transformer's parameters, gradients too) that tp rank ``tp_rank`` of
    ``tp_size`` and ep rank ``ep_rank`` of ``ep_size`` hold: each tensor
    cut into contiguous equal chunks along its sharded dim, every other
    tensor as it is."""
    tp_dims, ep_dims = tp_param_specs(state), ep_param_specs(state)
    out = {}
    for name, t in state.items():
        for dims, n, r in ((tp_dims, tp_size, tp_rank),
                           (ep_dims, ep_size, ep_rank)):
            if dims[name] is not None and n > 1:
                if t.shape[dims[name]] % n:
                    raise ValueError("%s: dim %d of %s does not split into "
                                     "%d shards" % (name, dims[name],
                                                    tuple(t.shape), n))
                t = t.chunk(n, dims[name])[r]
        out[name] = t.clone()
    return out


def _by_position(tree, exclude=()):
    """{class prefix: [subtrees in position order]} of flax's automatic
    names (``<Class>_<i>``) in ``tree``."""
    groups = {}
    for name in tree:
        m = re.fullmatch(r"(\w+?)_(\d+)", name)
        if m and name not in exclude:
            groups.setdefault(m.group(1), []).append((int(m.group(2)), name))
    return {k: [tree[n] for _, n in sorted(v)] for k, v in groups.items()}


def _conv(sd, prefix, kernel, bias=None):
    sd[prefix + ".weight"] = _t(np.transpose(np.asarray(kernel),
                                             (3, 2, 0, 1)))
    if bias is not None:
        sd[prefix + ".bias"] = _t(bias)


def _dense(sd, prefix, p):
    sd[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def _norm(sd, prefix, params, stats=None):
    sd[prefix + ".weight"] = _t(params["scale"])
    sd[prefix + ".bias"] = _t(params["bias"])
    if stats is not None:
        sd[prefix + ".running_mean"] = _t(stats["mean"])
        sd[prefix + ".running_var"] = _t(stats["var"])


def _split(groups):
    """(convs, norms) from _by_position's groups: the convs and the one
    other class, whatever the norm is called (none under norm="none")."""
    convs = groups.pop("Conv", [])
    if len(groups) > 1:
        raise ValueError("expected one norm class beside the convs, got %s"
                         % sorted(groups))
    return convs, groups.popitem()[1] if groups else []


def resnet_state_dict_from_jax(variables_np, model):
    params = variables_np["params"]
    stats = variables_np.get("batch_stats", {})
    sd = {}
    _conv(sd, "conv_init", params["conv_init"]["kernel"])
    if "bn_init" in params:
        _norm(sd, "bn_init", params["bn_init"], stats.get("bn_init"))
    _dense(sd, "head", params["Dense_0"])
    blocks = _by_position(params, exclude=("Dense_0",))
    if len(blocks) != 1:
        raise ValueError("expected one block class, got %s" % sorted(blocks))
    blocks = blocks.popitem()[1]
    block_stats = (_by_position(stats).popitem()[1] if stats
                   else [{}] * len(blocks))
    if len(blocks) != len(model.blocks):
        raise ValueError("the flax model has %d blocks, the port's %d"
                         % (len(blocks), len(model.blocks)))
    for i, (p, st) in enumerate(zip(blocks, block_stats)):
        pre = "blocks.%d." % i
        convs, norms = _split(_by_position(p))
        norm_stats = (_split(_by_position(st))[1] if st
                      else [None] * len(norms))
        for j, kernel in enumerate(c["kernel"] for c in convs):
            _conv(sd, pre + "convs.%d" % j, kernel)
        for j, (np_, ns) in enumerate(zip(norms, norm_stats)):
            _norm(sd, pre + "norms.%d" % j, np_, ns)
        if "conv_proj" in p:
            _conv(sd, pre + "conv_proj", p["conv_proj"]["kernel"])
            if "norm_proj" in p:
                _norm(sd, pre + "norm_proj", p["norm_proj"],
                      st.get("norm_proj"))
    return sd


def vgg16_state_dict_from_jax(variables_np, model):
    params = variables_np["params"]
    convs = sorted((k for k in params if k.startswith("conv")),
                   key=lambda k: tuple(int(i) for i in k[4:].split("_")))
    if len(convs) != len(model.convs):
        raise ValueError("the flax model has %d convs, the port's %d"
                         % (len(convs), len(model.convs)))
    sd = {}
    for i, name in enumerate(convs):
        _conv(sd, "convs.%d" % i, params[name]["kernel"],
              params[name]["bias"])
    for j in range(2):
        _dense(sd, "fc.%d" % j, params["fc%d" % j])
    _dense(sd, "head", params["head"])
    return sd


def inception_v3_state_dict_from_jax(variables_np, model):
    """Each ``_ConvBN_<i>`` to the i-th ``ConvBN`` of ``model`` in module
    order (the order flax creates them), BN epsilon 1e-3 in both."""
    from horovod_tpu_torch.models.imagenet_extras import ConvBN
    params, stats = variables_np["params"], variables_np["batch_stats"]
    names = [n for n, m in model.named_modules() if isinstance(m, ConvBN)]
    flax = _by_position(params, exclude=("Dense_0",))["_ConvBN"]
    flax_stats = _by_position(stats)["_ConvBN"]
    if len(flax) != len(names):
        raise ValueError("the flax model has %d ConvBN blocks, the port's %d"
                         % (len(flax), len(names)))
    sd = {}
    for name, p, st in zip(names, flax, flax_stats):
        convs, norms = _split(_by_position(p))
        _, norm_stats = _split(_by_position(st))
        _conv(sd, name + ".conv", convs[0]["kernel"])
        _norm(sd, name + ".bn", norms[0], norm_stats[0])
    _dense(sd, "head", params["Dense_0"])
    return sd


def mnist_state_dict_from_jax(variables_np):
    params = variables_np["params"]
    sd = {}
    for i in range(2):
        c = params["Conv_%d" % i]
        _conv(sd, "conv%d" % (i + 1), c["kernel"], c["bias"])
        _dense(sd, "fc%d" % (i + 1), params["Dense_%d" % i])
    return sd


def skipgram_state_dict_from_jax(variables_np):
    params = variables_np["params"]
    return {"embedding.weight": _t(params["embedding"]["embedding"]),
            "nce_weight": _t(params["nce_weight"]),
            "nce_bias": _t(params["nce_bias"])}
