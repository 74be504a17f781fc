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
- ``norm1``, ``norm2``, ``norm_f`` ``scale`` [E] is the RMSNorm weight.

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
only.
"""

import re

import numpy as np
import torch


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def transformer_state_dict_from_jax(params_np, cfg):
    E = cfg.embed_dim
    sd = {"embed.weight": _t(params_np["embed"]["embedding"]),
          "norm_f.weight": _t(params_np["norm_f"]["scale"]),
          "lm_head.weight": _t(np.asarray(params_np["lm_head"]["kernel"]).T)}
    for i in range(cfg.num_layers):
        p = params_np["block_%d" % i]
        pre = "blocks.%d." % i
        attn = p["attn"]
        for name in ("query", "key", "value"):
            k = np.asarray(attn[name]["kernel"])
            sd[pre + "attn.%s.weight" % name] = _t(k.reshape(E, -1).T)
        sd[pre + "attn.out.weight"] = _t(
            np.asarray(attn["out"]["kernel"]).reshape(-1, E).T)
        sd[pre + "norm1.weight"] = _t(p["norm1"]["scale"])
        sd[pre + "norm2.weight"] = _t(p["norm2"]["scale"])
        sd[pre + "mlp_in.weight"] = _t(np.asarray(p["mlp_in"]["kernel"]).T)
        sd[pre + "mlp_out.weight"] = _t(np.asarray(p["mlp_out"]["kernel"]).T)
    return sd


def _by_position(tree, exclude=()):
    """{class prefix: [subtrees in position order]} of flax's automatic
    names (``<Class>_<i>``) in ``tree``."""
    groups = {}
    for name in tree:
        m = re.fullmatch(r"(\w+?)_(\d+)", name)
        if m and name not in exclude:
            groups.setdefault(m.group(1), []).append((int(m.group(2)), name))
    return {k: [tree[n] for _, n in sorted(v)] for k, v in groups.items()}


def _conv(sd, prefix, kernel):
    sd[prefix + ".weight"] = _t(np.transpose(np.asarray(kernel),
                                             (3, 2, 0, 1)))


def _norm(sd, prefix, params, stats):
    sd[prefix + ".weight"] = _t(params["scale"])
    sd[prefix + ".bias"] = _t(params["bias"])
    sd[prefix + ".running_mean"] = _t(stats["mean"])
    sd[prefix + ".running_var"] = _t(stats["var"])


def _split(groups):
    """(convs, norms) from _by_position's groups: the convs and the one
    other class, whatever the norm is called."""
    convs = groups.pop("Conv", [])
    if len(groups) != 1:
        raise ValueError("expected one norm class beside the convs, got %s"
                         % sorted(groups))
    return convs, groups.popitem()[1]


def resnet_state_dict_from_jax(variables_np, model):
    params, stats = variables_np["params"], variables_np["batch_stats"]
    sd = {}
    _conv(sd, "conv_init", params["conv_init"]["kernel"])
    _norm(sd, "bn_init", params["bn_init"], stats["bn_init"])
    dense = params["Dense_0"]
    sd["head.weight"] = _t(np.asarray(dense["kernel"]).T)
    sd["head.bias"] = _t(dense["bias"])
    blocks = _by_position(params, exclude=("Dense_0",))
    block_stats = _by_position(stats)
    if len(blocks) != 1 or len(block_stats) != 1:
        raise ValueError("expected one block class, got %s" % sorted(blocks))
    blocks, block_stats = blocks.popitem()[1], block_stats.popitem()[1]
    if len(blocks) != len(model.blocks):
        raise ValueError("the flax model has %d blocks, the port's %d"
                         % (len(blocks), len(model.blocks)))
    for i, (p, st) in enumerate(zip(blocks, block_stats)):
        pre = "blocks.%d." % i
        convs, norms = _split(_by_position(p))
        _, norm_stats = _split(_by_position(st))
        for j, kernel in enumerate(c["kernel"] for c in convs):
            _conv(sd, pre + "convs.%d" % j, kernel)
        for j, (np_, ns) in enumerate(zip(norms, norm_stats)):
            _norm(sd, pre + "norms.%d" % j, np_, ns)
        if "conv_proj" in p:
            _conv(sd, pre + "conv_proj", p["conv_proj"]["kernel"])
            _norm(sd, pre + "norm_proj", p["norm_proj"], st["norm_proj"])
    return sd
