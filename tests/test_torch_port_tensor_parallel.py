"""The port's tensor parallelism against the JAX package's, on the CPU.

Counterparts of tests/test_tensor_parallel.py, of
tests/test_fsdp.py::test_gspmd_fsdp_x_tp_composition and of the host-plane
Megatron f and g of tests/mesh_worker.py. The flax model's full-size
weights go into the port through ``convert``, each rank keeps its tp shard
(``convert.shard_state_dict``) and runs the model of ``cfg.local(tp)``; on
4 gloo ranks (tests/torch_port_parallel_worker.py, spawned once for the
module), against JAX under ``shard_map`` on 4 virtual CPU devices:

- tp = 4: the logits against the full model's;
- (dp=2, tp=2): every rank's raw gradients against JAX's raw per-shard
  gradients (the psum transpose: sharded weights tp-fold), and
  ``tp_grad_sync(dp_axis="dp")``'s against the full model's gradient of
  the mean loss over the whole batch;
- tp = 2 through flash attention (the plain versions here) at L = 128;
- (tp=2, sp=2) with ring attention;
- (fsdp=2, tp=2): ``make_fsdp_train_step(group=fsdp, grad_sync=
  tp_grad_sync)`` on the tp-local model: the logits, and every parameter
  after one SGD step against the full model's step;
- ``copy_to_model_parallel`` and ``reduce_from_model_parallel`` over the
  model group of ``init(model_parallel=2)``: mesh_worker's exact value and
  gradient.

In this process: ``local()``'s checks and the parameter classification.
Both sides run in float32, JAX at its highest matmul precision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_port_parallel_worker as worker
from horovod_tpu import models as jax_models
from horovod_tpu.parallel import tensor_parallel as jtp
from horovod_tpu_torch.convert import (shard_state_dict,
                                       transformer_state_dict_from_jax)
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.parallel import tp_param_specs
from horovod_tpu_torch.parallel.tensor_parallel import is_tp_sharded

jax.config.update("jax_default_matmul_precision", "highest")

# tests/test_tensor_parallel.py's tolerances: forward 2e-5, gradients 5e-5
FWD_TOL = 2e-5
GRAD_TOL = 5e-5


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices("cpu")[:n]).reshape(shape), names)


def _cfg(kw, **over):
    return jax_models.TransformerConfig(dtype=jnp.float32, **dict(kw,
                                                                  **over))


def _port_cfg(kw, **over):
    return TransformerConfig(dtype=torch.float32, **dict(kw, **over))


def _to_state(tree, cfg):
    return transformer_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), cfg)


def _xent(logits, tokens):
    logp = jax.nn.log_softmax(logits)
    tgt = jnp.roll(tokens, -1, axis=1)
    return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], -1))


def _place(params, mesh, specs):
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
        specs)


def _case(kw, shape, seed_tokens, seed_init):
    tokens = np.random.RandomState(seed_tokens).randint(
        0, kw["vocab_size"], shape)
    model = jax_models.Transformer(_cfg(kw))
    params = model.init(jax.random.PRNGKey(seed_init),
                        jnp.asarray(tokens))["params"]
    return model, params, tokens


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, {case: JAX result}, [what each rank saved])."""
    cases = {"fwd4": (worker.TP, (2, 16), 0, 3),
             "grads": (worker.TP, (4, 16), 1, 3),
             "flash": (worker.TP, (2, 128), 5, 7),
             "tp_sp": (worker.TP, (2, 32), 9, 11),
             "fsdp_tp": (worker.FSDP_TP, (4, 16), 3, 0)}
    inputs, want = {}, {}
    for name, (kw, shape, st, si) in cases.items():
        model, params, tokens = _case(kw, shape, st, si)
        inputs[name] = dict(state=_to_state(params, _port_cfg(kw)),
                            tokens=torch.from_numpy(tokens))
        want[name] = dict(logits=np.asarray(model.apply(
            {"params": params}, jnp.asarray(tokens))))
        if name == "grads":
            want[name].update(_jax_tp_grads(params, tokens))
        if name == "fsdp_tp":
            want[name].update(_jax_sgd_step(model, params, tokens))
    got = worker.spawn(worker.run_tp, tmp_path_factory.mktemp("tp"), inputs)
    return inputs, want, got


def _jax_tp_grads(params, tokens):
    """On (dp=2, tp=2): every rank's raw gradients of its mean loss
    (stacked over the mesh), tp_grad_sync(dp_axis="dp")'s, and the full
    model's gradient of the mean loss over the whole batch."""
    full = jax_models.Transformer(_cfg(worker.TP))
    local = jax_models.Transformer(_cfg(worker.TP, tp_axis="tp").local(2))
    mesh = _mesh((2, 2), ("dp", "tp"))
    specs = jtp.tp_param_specs(params, "tp")

    def grads(p, t):
        g = jax.grad(lambda p: _xent(local.apply({"params": p}, t), t))(p)
        raw = jax.tree_util.tree_map(lambda x: x[None], g)
        return raw, jtp.tp_grad_sync(g, "tp", dp_axis="dp")

    rank = jax.tree_util.tree_map(lambda _: P(("dp", "tp")), params)
    raw, synced = jax.jit(jax.shard_map(
        grads, mesh=mesh, in_specs=(specs, P("dp")),
        out_specs=(rank, specs), check_vma=False))(
            _place(params, mesh, specs), jnp.asarray(tokens))
    expected = jax.grad(lambda p: _xent(full.apply({"params": p},
                                                   jnp.asarray(tokens)),
                                        jnp.asarray(tokens)))(params)
    return dict(raw=raw, synced=synced, full=expected)


def _jax_sgd_step(model, params, tokens):
    """The full model's parameters after one SGD step on the mean loss of
    the whole batch."""
    g = jax.grad(lambda p: _xent(model.apply({"params": p},
                                             jnp.asarray(tokens)),
                                 jnp.asarray(tokens)))(params)
    return dict(new=jax.tree_util.tree_map(lambda p, g: p - worker.LR * g,
                                           params, g))


def test_tp_forward_matches_full_model(ranks):
    _, want, got = ranks
    for out in got:
        np.testing.assert_allclose(_np(out["fwd4"]), want["fwd4"]["logits"],
                                   rtol=FWD_TOL, atol=FWD_TOL)


def test_tp_gradients_match_full_model(ranks):
    """The raw gradients equal JAX's per shard (sharded weights tp-fold,
    replicated ones rank-dependent), and tp_grad_sync over tp and dp
    gives each rank its slice of the full model's gradient."""
    _, want, got = ranks
    w = want["grads"]
    local = _port_cfg(worker.TP, tp_axis="tp").local(2)
    full = _to_state(w["full"], _port_cfg(worker.TP))
    for r, out in enumerate(got):
        res = out["grads"]
        raw = _to_state(jax.tree_util.tree_map(lambda g: g[r], w["raw"]),
                        local)
        synced = shard_state_dict(full, tp_size=2, tp_rank=r % 2)
        assert set(res["raw"]) == set(raw) == set(res["synced"])
        for name in raw:
            np.testing.assert_allclose(_np(res["raw"][name]),
                                       raw[name].numpy(), rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=name)
            np.testing.assert_allclose(_np(res["synced"][name]),
                                       synced[name].numpy(), rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=name)
    # the factor the sync undoes: a sharded weight's raw gradient is
    # tp-fold, summed over dp (each dp shard's mean loss)
    name = "blocks.0.attn.query.weight"
    total = sum(out["grads"]["raw"][name] for out in got[:1] + got[2:3])
    np.testing.assert_allclose(_np(total) / 2 / 2,
                               _np(got[0]["grads"]["synced"][name]),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_tp_with_flash_attention_path(ranks):
    _, want, got = ranks
    for out in got:
        np.testing.assert_allclose(_np(out["flash"]),
                                   want["flash"]["logits"], rtol=FWD_TOL,
                                   atol=FWD_TOL)


def test_tp_with_ring_attention_sp_mesh(ranks):
    """Heads over tp, the sequence over sp through the ring inside each tp
    group: each rank's logits are its sequence shard of the full model's."""
    _, want, got = ranks
    for r, out in enumerate(got):
        s = r % 2
        np.testing.assert_allclose(_np(out["tp_sp"]),
                                   want["tp_sp"]["logits"][:, s * 16:
                                                           (s + 1) * 16],
                                   rtol=FWD_TOL, atol=FWD_TOL)


def test_fsdp_x_tp_composition(ranks):
    """(fsdp=2, tp=2): each tp shard sharded again over fsdp (the
    projections on dim 0 where 2 divides it), the logits the full model's,
    and after one SGD step on the fsdp shards of the batch every parameter
    its tp slice of the full model's step."""
    _, want, got = ranks
    w = want["fsdp_tp"]
    new = _to_state(w["new"], _port_cfg(worker.FSDP_TP))
    for r, out in enumerate(got):
        res = out["fsdp_tp"]
        np.testing.assert_allclose(_np(res["out"]), w["logits"],
                                   rtol=FWD_TOL, atol=FWD_TOL)
        assert "blocks.0.attn.query.weight" in res["sharded"]
        assert "embed.weight" in res["sharded"]
        mine = shard_state_dict(new, tp_size=2, tp_rank=r % 2)
        assert set(res["params"]) == set(mine)
        for name, p in res["params"].items():
            np.testing.assert_allclose(_np(p), mine[name].numpy(),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=name)
        assert np.isfinite(float(res["loss"]))


def test_megatron_f_and_g_over_the_model_group(ranks):
    """tests/mesh_worker.py's f and g under init(model_parallel=2): rank r
    in model group (2 (r // 2), 2 (r // 2) + 1), W = (group rank + 1),
    sum(g(f(1) @ W)^2) = 4 * 81 and every gradient 36."""
    _, _, got = ranks
    for r, out in enumerate(got):
        res = out["fg"]
        assert res["ranks"] == (2 * (r // 2), 2 * (r // 2) + 1)
        assert abs(float(res["val"]) - 4 * 81.0) < 1e-4
        assert torch.allclose(res["grad"], torch.full((3, 2), 36.0))


def test_tp_local_config_validation():
    cfg = _port_cfg(worker.TP)
    with pytest.raises(ValueError):
        cfg.local(3)  # 4 heads not divisible by 3
    assert cfg.local(2).num_heads == 2
    assert cfg.local(2).mlp_dim == 32
    assert cfg.local(2).head_dim == 8
    gqa = _port_cfg(worker.TP, num_kv_heads=2)
    assert gqa.local(2).num_kv_heads == 1
    with pytest.raises(ValueError, match="num_kv_heads"):
        gqa.local(4)
    with pytest.raises(ValueError, match="cannot be combined"):
        _port_cfg(worker.TP, tp_axis="tp", moe_experts=4)


def test_tp_spec_classification():
    """The projections' head or hidden dims, in PyTorch's [out, in]
    layout; the embedding, norms and head replicated. Each names the same
    leaves as the JAX package's specs."""
    model = Transformer(_port_cfg(worker.TP), device="cpu")
    specs = tp_param_specs(model)
    assert specs["blocks.0.attn.query.weight"] == 0
    assert specs["blocks.0.attn.out.weight"] == 1
    assert specs["blocks.1.mlp_in.weight"] == 0
    assert specs["blocks.1.mlp_out.weight"] == 1
    for name in ("embed.weight", "norm_f.weight", "lm_head.weight",
                 "blocks.0.norm1.weight"):
        assert specs[name] is None and not is_tp_sharded(name)
    params = jax_models.Transformer(_cfg(worker.TP)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    flat = jax.tree_util.tree_flatten_with_path(
        jtp.tp_param_specs(params, "tp"))[0]
    n_sharded = sum(s != P() for _, s in flat)
    assert n_sharded == sum(d is not None for d in specs.values())
