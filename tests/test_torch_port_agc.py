"""The port's adaptive gradient clipping against the JAX package's, on the
CPU.

- ``agc_clip`` against ``horovod_tpu.ops.agc.agc_clip`` on the converted
  parameters and gradients of three flax models whose leaves the port
  stores in other layouts: a small ``ResNet(norm="none")`` (conv HWIO ->
  OIHW, dense [in, out] -> [out, in]: the unit moves to dim 0), a small
  Transformer with MoE blocks (the embedding, the router and the expert
  weights kept as they are: the unit stays last; q, k, v reshaped from
  [E, H, D] to [H * D, E]: the unit is d across the heads and E), and a
  small SkipGram (``nce_weight`` [V, D] as it is);
- ``make_train_step(agc=)`` on a small norm-free ResNet against
  ``horovod_tpu.parallel.make_train_step(agc=)`` for 3 SGD steps;
- bench.py's NF + AGC convergence check (``_nf_agc_convergence``) at its
  sizes on the port;
- ``adaptive_grad_clip`` and the guards.

Inputs from numpy seeds; float32 on both sides, JAX at its highest matmul
precision.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu_torch as hvd
from horovod_tpu import models as jax_models
from horovod_tpu.ops import agc as jax_agc
from horovod_tpu.parallel import data_parallel_mesh
from horovod_tpu.parallel import make_train_step as jax_make_train_step
from horovod_tpu.parallel.train import cross_entropy_loss as jax_xent
from horovod_tpu_torch.convert import (resnet_state_dict_from_jax,
                                       skipgram_state_dict_from_jax,
                                       transformer_state_dict_from_jax)
from horovod_tpu_torch.models import (BottleneckBlock, ResNet, SkipGram,
                                      Transformer, TransformerConfig)
from horovod_tpu_torch.ops import agc
from horovod_tpu_torch.parallel import classification_loss, make_train_step

jax.config.update("jax_default_matmul_precision", "highest")

# agc_clip against the reference, ||port - ref||_2 / ||ref||_2 per leaf:
# the same f32 norms summed in another order
CLIP_TOL = 1e-6
# three SGD steps of the norm-free ResNet, per parameter, norm-relative
STEP_TOL = 1e-5
# bench.py's convergence gate: NF + AGC ends within 0.15 (absolute) of the
# BN run, and below 0.3 of its first loss
CONVERGE_TOL = 0.15

NF_SMALL = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8)
LM_SMALL = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64,
                mlp_dim=128, max_seq_len=64, moe_experts=4,
                attention="dense")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads_like(params, seed):
    """Gradients of the flax shapes: per leaf a random scale around each
    unit's clip threshold, so some units clip and some do not."""
    rng = np.random.RandomState(seed)

    def one(p):
        g = rng.randn(*np.shape(p)).astype(np.float32)
        return g * np.float32(10.0 ** rng.uniform(-4, 0))
    return jax.tree_util.tree_map(one, params)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _check(port_model, convert, params, grads, clipping=0.01):
    """Clips the converted gradients against the converted parameters in
    the port and the flax ones in the reference; compares every leaf and
    returns the share of the reference's units that clipped."""
    ref = _np(jax_agc.agc_clip(grads, params, clipping=clipping))
    port_model.load_state_dict(convert(params))
    named = dict(port_model.named_parameters())
    port_grads = {k: v for k, v in convert(grads).items() if k in named}
    assert set(port_grads) == set(named)
    out = agc.agc_clip(port_grads, named, clipping=clipping)
    want = convert(ref)
    for name, g in out.items():
        rel = _rel(g.numpy(), want[name].numpy())
        assert rel <= CLIP_TOL, (name, rel)
    changed = [not np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(grads))]
    return out, np.mean(changed)


def test_agc_clip_matches_the_reference_on_the_nf_resnet():
    jm = jax_models.ResNet(dtype=jnp.float32, norm="none",
                           block_cls=jax_models.resnet.BottleneckBlock,
                           **NF_SMALL)
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                         train=False)["params"])
    port = ResNet(dtype=torch.float32, norm="none", device="cpu",
                  block_cls=BottleneckBlock, **NF_SMALL)
    convert = lambda t: resnet_state_dict_from_jax(  # noqa: E731
        {"params": t}, port)
    _, share = _check(port, convert, params, _grads_like(params, 1))
    assert 0.1 < share < 1.0, share


def test_agc_clip_matches_the_reference_on_the_moe_transformer():
    """The embedding, router, expert and q/k/v leaves: their port layout is
    not torch's [out, in], and a plain "all but dim 0" rule would clip them
    per row where the reference clips per column."""
    jcfg = jax_models.TransformerConfig(dtype=jnp.float32, **LM_SMALL)
    params = _np(jax_models.Transformer(jcfg).init(
        jax.random.PRNGKey(3), jnp.zeros((2, 8), jnp.int32))["params"])
    cfg = TransformerConfig(dtype=torch.float32, **LM_SMALL)
    port = Transformer(cfg, device="cpu")
    convert = lambda t: transformer_state_dict_from_jax(t, cfg)  # noqa: E731
    grads = _grads_like(params, 2)
    out, share = _check(port, convert, params, grads)
    assert 0.1 < share < 1.0, share
    # the tags are what makes it right: untagged copies (torch's default
    # unit, dim 0) of these leaves clip otherwise
    named = dict(port.named_parameters())
    port_grads = convert(grads)
    for name in ("embed.weight", "blocks.1.moe_mlp.router",
                 "blocks.1.moe_mlp.w_in", "blocks.0.attn.query.weight"):
        assert agc.unit_of(named[name]) != (0, None), name
        bare = agc.agc_clip(port_grads[name], named[name].detach().clone())
        assert not torch.equal(bare, out[name]), name


def test_agc_clip_matches_the_reference_on_skipgram():
    jm = jax_models.SkipGram(vocab_size=96, embedding_dim=16)
    params = _np(jm.init(jax.random.PRNGKey(4), jnp.zeros((2,), jnp.int32))[
        "params"])
    port = SkipGram(96, 16, device="cpu")
    convert = lambda t: skipgram_state_dict_from_jax(  # noqa: E731
        {"params": t})
    # nce_bias starts at 0: its unit's threshold is clipping * eps
    _, share = _check(port, convert, params, _grads_like(params, 5))
    assert 0.0 < share, share


def test_unitwise_norm_matches_the_reference():
    rng = np.random.RandomState(6)
    for shape, unit, ref_view in (((5,), (0, None), None),
                                  ((4, 3, 2, 2), (0, None), (2, 3, 1, 0)),
                                  ((6, 5), (-1, None), None),
                                  ((12, 5), (1, (-1, 4, 5)), None)):
        x = rng.randn(*shape).astype(np.float32)
        got = agc.unitwise_norm(torch.from_numpy(x), unit).numpy()
        if ref_view is not None:  # OIHW -> HWIO
            ref = jax_agc.unitwise_norm(np.transpose(x, ref_view))
            got = got.reshape(-1)
        elif unit[1] is not None:  # [H * D, E] -> [E, H, D]
            ref = jax_agc.unitwise_norm(
                x.reshape(3, 4, 5).transpose(2, 0, 1))
            got = got.reshape(-1)
        else:
            ref = jax_agc.unitwise_norm(x)
        np.testing.assert_allclose(got.reshape(np.shape(ref))
                                   if np.ndim(ref) else got,
                                   np.asarray(ref).reshape(np.shape(ref)),
                                   rtol=1e-6)


@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _jax_run(norm, agc_factor, x, y, steps, lr, model_kw, seed=0):
    """bench.py's ``_nf_agc_convergence.run``: losses and final params."""
    jm = jax_models.ResNet(dtype=jnp.float32, norm=norm,
                           block_cls=jax_models.resnet.BottleneckBlock,
                           **model_kw)
    variables = jm.init(jax.random.PRNGKey(seed), x[:1], train=False)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})

    def loss_fn(p, b):
        if batch_stats:
            logits, _ = jm.apply({"params": p, "batch_stats": batch_stats},
                                 b["x"], train=True,
                                 mutable=["batch_stats"])
        else:
            logits = jm.apply({"params": p}, b["x"], train=True)
        return jax_xent(logits, b["y"])

    mesh = data_parallel_mesh(devices=jax.devices("cpu")[:1])
    opt = optax.sgd(lr, momentum=0.9)
    step = jax_make_train_step(loss_fn, opt, mesh, donate=False,
                               agc=agc_factor)
    pp, os_, batch = step.place(params, opt.init(params), {"x": x, "y": y})
    losses = []
    for _ in range(steps):
        pp, os_, loss = step(pp, os_, batch)
        losses.append(float(loss))
    return losses, _np(jax.device_get(pp)), _np(variables)


def _port_run(norm, agc_factor, variables, x, y, steps, lr, model_kw):
    model = ResNet(dtype=torch.float32, norm=norm, device="cpu",
                   block_cls=BottleneckBlock, **model_kw)
    model.load_state_dict(resnet_state_dict_from_jax(variables, model))
    step = make_train_step(model, classification_loss,
                           torch.optim.SGD(model.parameters(), lr=lr,
                                           momentum=0.9),
                           device="cpu", agc=agc_factor)
    batch = {"x": torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2),
             "y": torch.from_numpy(np.asarray(y)).long()}
    return [float(step(batch)) for _ in range(steps)], model


def test_nf_step_with_agc_matches_the_jax_step(one_rank):
    """Three SGD steps (momentum 0.9) with AGC 0.01 on the norm-free
    ResNet from the same flax weights: every parameter after them, and the
    losses, equal the JAX step's; the clip changed the run."""
    rng = np.random.RandomState(7)
    x = jnp.asarray(rng.randn(8, 32, 32, 3).astype(np.float32))
    y = jnp.asarray(rng.randint(0, 10, 8).astype(np.int32))
    losses_j, params_j, variables = _jax_run("none", 0.01, x, y, 3, 0.1,
                                             NF_SMALL)
    losses, model = _port_run("none", 0.01, variables, x, y, 3, 0.1,
                              NF_SMALL)
    np.testing.assert_allclose(losses, losses_j, rtol=STEP_TOL)
    want = resnet_state_dict_from_jax({"params": params_j}, model)
    for name, p in model.named_parameters():
        rel = _rel(p.detach().numpy(), want[name].numpy())
        assert rel <= STEP_TOL, (name, rel)
    unclipped, _ = _port_run("none", None, variables, x, y, 3, 0.1,
                             NF_SMALL)
    assert abs(unclipped[-1] - losses[-1]) > 1e-3


def test_nf_with_agc_converges_like_bn(one_rank):
    """bench.py's ``_nf_agc_convergence`` on the port, at its sizes (a
    ResNet of one stage of 2 bottleneck blocks, 8 filters, 32 images of 16
    x 16, 30 SGD steps at lr 0.5, momentum 0.9, AGC 0.02): the NF + AGC
    run ends within 0.15 of the BN run, below 0.3 of its first loss."""
    kw = dict(stage_sizes=[2], num_classes=10, num_filters=8)
    rng = np.random.RandomState(0)
    x = rng.randn(32, 16, 16, 3).astype(np.float32)
    y = rng.randint(0, 10, size=32).astype(np.int32)
    finals = {}
    for norm, clip in (("batch", None), ("none", 0.02)):
        jm = jax_models.ResNet(dtype=jnp.float32, norm=norm,
                               block_cls=jax_models.resnet.BottleneckBlock,
                               **kw)
        variables = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                                train=False))
        losses, _ = _port_run(norm, clip, variables, x, y, 30, 0.5, kw)
        assert np.isfinite(losses).all(), (norm, losses)
        finals[norm] = (losses[0], losses[-1])
    first, last = finals["none"]
    assert last <= finals["batch"][1] + CONVERGE_TOL, finals
    assert last < first * 0.3, finals


def test_adaptive_grad_clip_and_the_guards(one_rank):
    """The transformation clips .grad in place as agc_clip does; without
    params it raises the reference's ValueError; under the sharded update
    and zero1 agc= raises ValueError."""
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    (model(torch.randn(5, 4)) * 1e3).sum().backward()
    want = agc.agc_clip({n: p.grad for n, p in model.named_parameters()},
                        dict(model.named_parameters()), 0.02)
    clip = agc.adaptive_grad_clip(0.02)
    clip(model.parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, want[n]), n
    with pytest.raises(ValueError, match="needs params"):
        clip()
    sgd = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(ValueError, match="sharded_update"):
        hvd.DistributedOptimizer(sgd, sharded_update=True, agc=0.01)
    with pytest.raises(ValueError, match="zero1"):
        make_train_step(model, classification_loss, sgd, device="cpu",
                        zero1=True, agc=0.01)
    wrapped = hvd.DistributedOptimizer(sgd, model.named_parameters())
    with pytest.raises(ValueError, match="already wrapped"):
        make_train_step(model, classification_loss, wrapped, device="cpu",
                        agc=0.01)
