"""Carries a flax Transformer's parameters into the port's model.

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
"""

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
