"""The port's Transformer against the JAX package's, on the CPU.

The flax parameters go into the port through
``convert.transformer_state_dict_from_jax``; both models run in float32
(JAX at its highest matmul precision), and the logits and the gradient of
the LM loss for every parameter are compared.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu import models as jax_models
from horovod_tpu_torch import CudaUnavailableError
from horovod_tpu_torch.convert import transformer_state_dict_from_jax
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.parallel import lm_loss, lm_loss_streaming

# Two f32 models through 2 layers: the same arithmetic in another order.
LOGIT_TOL = 2e-5
# Gradients of the mean loss, through the attention backward.
GRAD_TOL = 1e-4

SMALL = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64,
             mlp_dim=256, max_seq_len=256)


def _jax_side(attention, num_kv_heads, tokens):
    cfg = jax_models.TransformerConfig(attention=attention,
                                       num_kv_heads=num_kv_heads,
                                       dtype=jnp.float32, **SMALL)
    model = jax_models.Transformer(cfg)
    x = jnp.asarray(tokens)
    params = model.init(jax.random.PRNGKey(0), x[:1])["params"]

    def loss_fn(params):
        logits = model.apply({"params": params}, x)
        tgt = jnp.roll(x, -1, axis=1)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], axis=-1))

    with jax.default_matmul_precision("highest"):
        logits = model.apply({"params": params}, x)
        loss, grads = jax.value_and_grad(loss_fn)(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), np.asarray(logits), float(loss), to_np(grads)


def _port(attention, num_kv_heads, params_np):
    cfg = TransformerConfig(attention=attention, num_kv_heads=num_kv_heads,
                            dtype=torch.float32, **SMALL)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(transformer_state_dict_from_jax(params_np, cfg))
    return model, cfg


@pytest.mark.parametrize("attention", ["flash", "dense"])
@pytest.mark.parametrize("num_kv_heads", [None, 2])
def test_transformer_matches_jax(attention, num_kv_heads):
    tokens = np.random.RandomState(0).randint(
        0, SMALL["vocab_size"], (2, 64)).astype(np.int32)
    params_np, logits_j, loss_j, grads_j = _jax_side(attention, num_kv_heads,
                                                     tokens)
    model, cfg = _port(attention, num_kv_heads, params_np)
    x = torch.from_numpy(tokens).long()
    logits = model(x)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), logits_j,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)

    loss = lm_loss(model, x)
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-6)
    loss.backward()
    expected = transformer_state_dict_from_jax(grads_j, cfg)
    names = dict(model.named_parameters())
    assert set(names) == set(expected)
    for name, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), expected[name].numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_flash_and_dense_agree_in_bf16():
    """The bf16 compute path (explicit casts over f32 params): flash and
    dense attention give the same loss within bf16 rounding."""
    cfg = TransformerConfig(attention="flash", dtype=torch.bfloat16,
                            **SMALL)
    gen = torch.Generator().manual_seed(0)
    flash = Transformer(cfg, device="cpu", generator=gen)
    dense = Transformer(dataclasses.replace(cfg, attention="dense"),
                        device="cpu")
    dense.load_state_dict(flash.state_dict())
    x = torch.randint(0, SMALL["vocab_size"], (2, 64),
                      generator=torch.Generator().manual_seed(1))
    assert flash(x, return_hidden=True).dtype == torch.bfloat16
    a, b = lm_loss(flash, x).item(), lm_loss(dense, x).item()
    assert abs(a - b) <= 1e-2 * abs(b)


def test_seeded_init_is_reproducible():
    cfg = TransformerConfig(attention="flash", dtype=torch.float32, **SMALL)
    a = Transformer(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    b = Transformer(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    # flax's default scales: embedding N(0, 1/E), linear N(0, 1/fan_in).
    assert abs(a.embed.weight.std().item() - 64 ** -0.5) < 0.02
    assert abs(a.blocks[0].mlp_out.weight.std().item() - 256 ** -0.5) < 0.01


# The long-context GQA LM (bench.py --seq-len 8192 --fused-xent
# --num-heads 6 --num-kv-heads 2 --fused-rope) cut to 2 layers and D = 32.
LC_SMALL = dict(vocab_size=128, num_layers=2, num_heads=6, num_kv_heads=2,
                embed_dim=192, mlp_dim=384, max_seq_len=256,
                attention="flash", rope_fused=True)


def test_long_context_gqa_slice_matches_jax():
    """The slice as a whole at a small size: the rope_fused GQA flash model
    (fused rotary in K1-K3, the plain versions on the CPU) with the
    streaming loss (lm_loss_streaming: 3 chunks of 64), converted from
    flax weights, against the JAX model's rope_fused flash attention and
    chunked_softmax_cross_entropy (bench.py's loss_fn): the loss and every
    parameter's gradient, both in float32. Tolerances are those of
    test_transformer_matches_jax: the same f32 arithmetic in another
    order."""
    from horovod_tpu.ops.losses import chunked_softmax_cross_entropy
    B, L = 2, 192
    tokens = np.random.RandomState(6).randint(
        0, LC_SMALL["vocab_size"], (B, L)).astype(np.int32)
    jcfg = jax_models.TransformerConfig(dtype=jnp.float32, **LC_SMALL)
    model = jax_models.Transformer(jcfg)
    x = jnp.asarray(tokens)
    params = model.init(jax.random.PRNGKey(2), x[:1])["params"]

    def loss_fn(params):
        hidden = model.apply({"params": params}, x, return_hidden=True)
        return chunked_softmax_cross_entropy(
            hidden, params["lm_head"]["kernel"], jnp.roll(x, -1, axis=1),
            chunk=64)

    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    cfg = TransformerConfig(dtype=torch.float32, **LC_SMALL)
    port = Transformer(cfg, device="cpu")
    port.load_state_dict(transformer_state_dict_from_jax(to_np(params), cfg))
    assert port.blocks[0].attn.head_dim == 32
    assert port.blocks[0].attn.key.weight.shape == (2 * 32, 192)
    loss = lm_loss_streaming(port, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-6)
    loss.backward()
    expected = transformer_state_dict_from_jax(to_np(grads_j), cfg)
    names = dict(port.named_parameters())
    assert set(names) == set(expected)
    for name, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), expected[name].numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_convert_carries_the_lc_widths():
    """convert.py at the long-context LM's attention widths (embed 768, 6
    query heads of 128, 2 kv heads; one layer, a small vocabulary and MLP):
    the key and value projections are [2 * 128, 768], and the port's
    logits match the flax model's."""
    widths = dict(vocab_size=64, num_layers=1, num_heads=6, num_kv_heads=2,
                  embed_dim=768, mlp_dim=64, max_seq_len=64,
                  attention="flash", rope_fused=True)
    jcfg = jax_models.TransformerConfig(dtype=jnp.float32, **widths)
    model = jax_models.Transformer(jcfg)
    x = jnp.asarray(np.random.RandomState(8).randint(0, 64, (1, 24)),
                    jnp.int32)
    params = model.init(jax.random.PRNGKey(3), x)["params"]
    with jax.default_matmul_precision("highest"):
        logits_j = np.asarray(model.apply({"params": params}, x))
    cfg = TransformerConfig(dtype=torch.float32, **widths)
    port = Transformer(cfg, device="cpu")
    state = transformer_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg)
    assert state["blocks.0.attn.query.weight"].shape == (768, 768)
    assert state["blocks.0.attn.key.weight"].shape == (256, 768)
    assert state["blocks.0.attn.out.weight"].shape == (768, 768)
    port.load_state_dict(state)
    logits = port(torch.from_numpy(np.array(x)).long())
    np.testing.assert_allclose(logits.detach().numpy(), logits_j,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_rope_fused_dense_rotates_outside():
    """rope_fused under dense attention rotates outside, as the reference
    does: the same model as rope_fused=False. Under flash it ignores the
    positions it is given (the kernels rotate at 0..L-1)."""
    cfg = TransformerConfig(dtype=torch.float32, **dict(LC_SMALL,
                                                        attention="dense"))
    fused = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(4))
    plain = Transformer(dataclasses.replace(cfg, rope_fused=False),
                        device="cpu")
    plain.load_state_dict(fused.state_dict())
    x = torch.randint(0, 128, (1, 64), generator=torch.Generator(
        ).manual_seed(5))
    shifted = torch.arange(64).expand(1, 64) + 7
    assert torch.equal(fused(x, shifted), plain(x, shifted))
    flash = Transformer(dataclasses.replace(cfg, attention="flash"),
                        device="cpu")
    flash.load_state_dict(fused.state_dict())
    np.testing.assert_allclose(flash(x, shifted).detach().numpy(),
                               plain(x).detach().numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


# Every field of the JAX config with a value other than its default (the
# axes only name mesh axes: the model is built, not run).
FIELDS = {"attention": "ulysses", "sp_axis": "sp", "sp_schedule": "zigzag",
          "tp_axis": "tp", "head_dim": 32, "moe_experts": 4,
          "moe_every": 3, "moe_capacity_factor": 2.0, "moe_top_k": 2,
          "ep_axis": "ep", "ep_size": 2, "num_kv_heads": 2,
          "rope_fused": True, "rope_base": 500.0, "max_seq_len": 128}


def test_config_has_every_jax_field():
    port = {f.name for f in dataclasses.fields(TransformerConfig)}
    ref = {f.name for f in dataclasses.fields(jax_models.TransformerConfig)}
    assert port == ref
    assert set(FIELDS) <= port


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_config_accepts_every_field(field):
    """The fields the earlier slices refused (attention="ulysses", tp_axis,
    moe_experts, ep_axis) build a model like the others; MoE with tp raises
    the reference's ValueError."""
    kw = dict(SMALL, **{field: FIELDS[field]})
    if field == "attention":
        kw["sp_axis"] = "sp"
    if field in ("moe_every", "moe_capacity_factor", "moe_top_k",
                 "ep_size"):
        kw["moe_experts"] = 4
    if field == "tp_axis":
        with pytest.raises(ValueError, match="cannot be combined"):
            TransformerConfig(moe_experts=4, **kw)
    cfg = TransformerConfig(dtype=torch.float32, **kw)
    assert getattr(cfg, field) == FIELDS[field]
    model = Transformer(cfg, device="cpu")
    moe = [i for i, b in enumerate(model.blocks) if b.moe]
    every = cfg.moe_every
    assert moe == ([i for i in range(cfg.num_layers)
                    if i % every == every - 1] if cfg.moe_experts else [])


# bench.py's MoE row (--moe-experts 8 --fused-xent: Switch top-1 every
# second block, capacity factor 1.25, flash attention, the streaming loss)
# cut to 2 layers and narrow widths; 16 x 8 = 128 tokens on 4 experts, 40
# slots each, so some tokens drop on both sides.
MOE_SMALL = dict(SMALL, num_layers=2, mlp_dim=128, moe_experts=4,
                 attention="flash")


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_lm_slice_matches_jax(top_k):
    """The slice as a whole at a small size: the MoE LM with flash
    attention (the plain versions here) and the streaming loss plus 0.01
    times the aux loss, converted from flax weights: the loss and every
    parameter's gradient against the JAX model's, in float32."""
    from horovod_tpu.ops.losses import chunked_softmax_cross_entropy
    from horovod_tpu_torch.parallel import moe_aux_loss
    kw = dict(MOE_SMALL, moe_top_k=top_k)
    tokens = np.random.RandomState(12).randint(
        0, kw["vocab_size"], (16, 8)).astype(np.int32)
    model = jax_models.Transformer(jax_models.TransformerConfig(
        dtype=jnp.float32, **kw))
    x = jnp.asarray(tokens)
    params = model.init(jax.random.PRNGKey(5), x)["params"]

    def loss_fn(params):
        hidden, state = model.apply({"params": params}, x,
                                    return_hidden=True,
                                    mutable=["intermediates"])
        aux = sum(jax.tree_util.tree_leaves(state["intermediates"]))
        return chunked_softmax_cross_entropy(
            hidden, params["lm_head"]["kernel"], jnp.roll(x, -1, axis=1),
            chunk=8) + 0.01 * aux

    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    cfg = TransformerConfig(dtype=torch.float32, **kw)
    port = Transformer(cfg, device="cpu")
    port.load_state_dict(transformer_state_dict_from_jax(to_np(params), cfg))
    loss = (lm_loss_streaming(port, torch.from_numpy(tokens).long()) +
            0.01 * moe_aux_loss(port))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-6)
    loss.backward()
    expected = transformer_state_dict_from_jax(to_np(grads_j), cfg)
    names = dict(port.named_parameters())
    assert set(names) == set(expected)
    assert "blocks.1.moe_mlp.w_in" in names
    for name, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), expected[name].numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the model would build on it")
    with pytest.raises(CudaUnavailableError):
        Transformer(TransformerConfig(**SMALL))
    from horovod_tpu_torch.models import ResNet50Lean
    from horovod_tpu_torch.ops import LeanBatchNorm
    with pytest.raises(CudaUnavailableError):
        ResNet50Lean(num_classes=1000)
    with pytest.raises(CudaUnavailableError):
        LeanBatchNorm(64)
    with pytest.raises(CudaUnavailableError):
        ResNet50Lean(num_classes=1000, bn_remat=True)
    from horovod_tpu_torch.parallel import (lm_loss, make_fsdp_train_step,
                                            make_train_step)
    model = torch.nn.Linear(2, 2)
    with pytest.raises(CudaUnavailableError):
        make_train_step(model, lm_loss, torch.optim.Adam(model.parameters()),
                        zero1=True)
    with pytest.raises(CudaUnavailableError):
        make_fsdp_train_step(model, lm_loss, torch.optim.Adam)
    from horovod_tpu_torch.parallel import MoeMlp
    with pytest.raises(CudaUnavailableError):
        MoeMlp(768, 8, 3072)
    # a serve replica's forward: the GPU of its local slot by default
    from horovod_tpu_torch.serve import model as serve_model
    with pytest.raises(CudaUnavailableError):
        serve_model.resolve_device(None, slot=3)
    for kw in (dict(moe_experts=8), dict(attention="ulysses", sp_axis="sp"),
               dict(tp_axis="tp")):
        with pytest.raises(CudaUnavailableError):
            Transformer(TransformerConfig(**dict(SMALL, **kw)))
