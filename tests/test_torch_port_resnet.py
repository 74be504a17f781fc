"""The port's ResNet against the JAX package's flax ResNet, on the CPU.

A small ResNet (two stages of one block, 8 filters, 32 x 32 images, 10
classes): the second stage's first block has stride 2, so flax's "SAME"
padding of a stride-2 3x3 convolution is exercised. The flax variables go
into the port through ``convert.resnet_state_dict_from_jax``; both run in
float32 (JAX at its highest matmul precision). The block-final BN scales
start at zero in both packages, which zeroes every gradient upstream of
them inside a block, so each gradient check first sets them to nonzero
values from a seed, the same on both sides.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu_torch as hvd
from horovod_tpu.models import resnet as jax_resnet
from horovod_tpu.parallel import data_parallel_mesh
from horovod_tpu.parallel import make_train_step as jax_make_train_step
from horovod_tpu.parallel.train import cross_entropy_loss as jax_xent
from horovod_tpu_torch.convert import resnet_state_dict_from_jax
from horovod_tpu_torch.models import (BottleneckBlock, ResNet, ResNet50PBN,
                                      ResNetBlock)
from horovod_tpu_torch.parallel import classification_loss, make_train_step

import torch_port_bn_worker as worker

# Two f32 models through 7-10 conv and BN layers: the same arithmetic in
# another order.
LOGIT_TOL = 1e-5
# ||g_port - g_flax||_2 / ||g_flax||_2 of each parameter.
GRAD_TOL = 1e-4

BLOCKS = {"bottleneck": (jax_resnet.BottleneckBlock, BottleneckBlock),
          "basic": (jax_resnet.ResNetBlock, ResNetBlock)}
SMALL = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8)


@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _batch(seed=0, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


def _torch_batch(x, y):
    return {"x": torch.from_numpy(x).permute(0, 3, 1, 2),
            "y": torch.from_numpy(y).long()}


def _flax_model(block, norm, seed=0):
    """The flax model and its variables as numpy, with the block-final
    scales drawn from ``seed``."""
    jm = jax_resnet.ResNet(block_cls=BLOCKS[block][0], dtype=jnp.float32,
                           norm=norm, **SMALL)
    x, _ = _batch()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                        train=False)
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.RandomState(seed + 100)
    for name, p in sorted(variables["params"].items()):
        norms = sorted((k for k in p if re.fullmatch(r"\w*Norm_\d+", k)),
                       key=lambda k: int(k.rsplit("_", 1)[1]))
        if "Block_" in name:
            last = p[norms[-1]]
            assert not last["scale"].any()  # flax's zero init
            last["scale"] = rng.uniform(0.5, 1.5, last["scale"].shape
                                        ).astype(np.float32)
    return jm, variables


def _port_model(block, norm, variables):
    model = ResNet(block_cls=BLOCKS[block][1], dtype=torch.float32,
                   norm=norm, device="cpu", **SMALL)
    model.load_state_dict(resnet_state_dict_from_jax(variables, model))
    return model


def _flax_loss_fn(jm, batch_stats):
    """bench.py's loss: train-mode logits, the batch-stat update dropped."""
    def loss_fn(params, batch):
        logits, _ = jm.apply({"params": params, "batch_stats": batch_stats},
                             batch["x"], train=True,
                             mutable=["batch_stats"])
        return jax_xent(logits, batch["y"])
    return loss_fn


@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("norm", ["batch", "pallas"])
def test_logits_and_gradients_match_flax(block, norm):
    jm, variables = _flax_model(block, norm)
    x, y = _batch()
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    loss_fn = _flax_loss_fn(jm, variables["batch_stats"])
    with jax.default_matmul_precision("highest"):
        logits_j, upd = jm.apply(variables, batch["x"], train=True,
                                 mutable=["batch_stats"])
        loss_j, grads_j = jax.value_and_grad(loss_fn)(variables["params"],
                                                      batch)

    model = _port_model(block, norm, variables)
    tb = _torch_batch(x, y)
    model.train()
    logits = model(tb["x"])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # The running statistics after one train-mode forward: flax's update.
    after = resnet_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, {"params": variables["params"],
                                            **upd}), model)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), after[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)

    loss = classification_loss(model, tb)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    expected = resnet_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, {
            "params": grads_j, "batch_stats": variables["batch_stats"]}),
        model)
    for name, p in model.named_parameters():
        ref = expected[name]
        assert ref.norm() > 0, name  # the nonzero scales reach every leaf
        rel = ((p.grad - ref).norm() / ref.norm()).item()
        assert rel <= GRAD_TOL, (name, rel)


@pytest.mark.parametrize("norm", ["batch", "pallas"])
def test_gradients_match_a_float64_evaluation(norm):
    """On a batch where flax's jit-compiled BN gradients stand 4.6e-3
    (norm-relative, worst leaf) from a float64 evaluation of the same
    model, the port's f32 gradients through either norm stay within 1e-5
    of the stock-BN model run in float64."""
    _, variables = _flax_model("bottleneck", norm)
    x, y = _batch(seed=1)
    model = _port_model("bottleneck", norm, variables)
    classification_loss(model, _torch_batch(x, y)).backward()
    ref = _port_model("bottleneck", "batch", variables).double()
    for m in ref.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    batch = _torch_batch(x, y)
    batch["x"] = batch["x"].double()
    classification_loss(ref, batch).backward()
    refs = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        g = refs[name].grad
        rel = ((p.grad.double() - g).norm() / g.norm()).item()
        assert rel <= 1e-5, (name, rel)


def test_state_dict_conversion_round_trip():
    """Every flax leaf lands on exactly one port tensor, in the port's
    layout, and strict loading takes the converted dict."""
    _, variables = _flax_model("bottleneck", "pallas")
    model = _port_model("bottleneck", "pallas", variables)
    sd = resnet_state_dict_from_jax(variables, model)
    assert set(sd) == set(model.state_dict())
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(variables))
    assert n_flax == sum(t.numel() for t in sd.values())
    p = variables["params"]
    np.testing.assert_array_equal(
        model.conv_init.weight.detach().permute(2, 3, 1, 0).numpy(),
        p["conv_init"]["kernel"])
    np.testing.assert_array_equal(model.head.weight.detach().T.numpy(),
                                  p["Dense_0"]["kernel"])
    np.testing.assert_array_equal(
        model.blocks[1].norms[2].weight.detach().numpy(),
        p["BottleneckBlock_1"]["PallasBatchNorm_2"]["scale"])
    np.testing.assert_array_equal(
        model.blocks[1].norm_proj.running_var.numpy(),
        variables["batch_stats"]["BottleneckBlock_1"]["norm_proj"]["var"])
    # The same flax tree under the stock norm's class names.
    stock = _port_model("bottleneck", "batch", variables)
    for name, t in stock.state_dict().items():
        assert torch.equal(t, sd[name]), name


def test_three_sgd_momentum_steps_match_jax(one_rank):
    """make_train_step with a dict batch against the JAX step with
    optax.sgd(0.01, momentum=0.9), as bench.py trains the ResNet."""
    import optax
    jm, variables = _flax_model("bottleneck", "pallas")
    x, y = _batch()
    params = variables["params"]
    with jax.default_matmul_precision("highest"):
        opt = optax.sgd(0.01, momentum=0.9)
        mesh = data_parallel_mesh(devices=jax.devices("cpu")[:1])
        jstep = jax_make_train_step(
            _flax_loss_fn(jm, variables["batch_stats"]), opt, mesh,
            donate=False)
        p, s, b = jstep.place(params, opt.init(params),
                              {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        losses_j = []
        for _ in range(3):
            p, s, loss = jstep(p, s, b)
            losses_j.append(float(loss))
        final_j = jax.tree_util.tree_map(np.asarray, p)

    model = _port_model("bottleneck", "pallas", variables)
    step = make_train_step(model, classification_loss,
                           torch.optim.SGD(model.parameters(), lr=0.01,
                                           momentum=0.9), device="cpu")
    batch = _torch_batch(x, y)
    losses = [step(batch).item() for _ in range(3)]
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    assert losses[-1] < losses[0]
    expected = resnet_state_dict_from_jax(
        {"params": final_j, "batch_stats": variables["batch_stats"]}, model)
    for name, t in model.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(),
                                   expected[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_sync_bn_on_two_gloo_ranks_gives_the_full_batch_gradient(tmp_path):
    """Training-mode BN synchronized over 2 ranks (bn_group=): each rank's
    loss on its half of the batch, then DistributedOptimizer's average,
    equals the gradient of one process on the whole batch; the running
    statistics are the whole batch's on both ranks."""
    outs = worker.spawn(worker.run_resnet, tmp_path)
    model, batch = worker.resnet_and_batch()
    loss = classification_loss(model, batch)
    loss.backward()
    for out in outs:
        assert abs(out["loss"].item() - loss.item()) <= 1e-5
        for name, p in model.named_parameters():
            g = out["grads"][name]
            rel = ((g - p.grad).norm() / p.grad.norm()).item()
            assert rel <= 1e-5, (name, rel)
        for name, b in model.named_buffers():
            torch.testing.assert_close(out["buffers"][name], b, rtol=1e-5,
                                       atol=1e-6)


def test_later_norms_and_ghost_bn_name_their_slice(one_rank):
    """GroupNorm and no norm (ported since ROADMAP A6), bn_remat, sync BN
    on the stock path, norm="lean" and ghost BN construct and run; the BN
    options are refused beside GroupNorm and no norm."""
    for norm in ("group", "none"):
        model = ResNet(block_cls=BottleneckBlock, norm=norm, device="cpu",
                       **dict(SMALL, num_filters=32))
        assert model(torch.zeros(2, 3, 32, 32)).shape == (2, 10)
        with pytest.raises(ValueError, match="BN norms"):
            ResNet50PBN(norm=norm, bn_group=hvd.WORLD, device="cpu")
    remat = ResNet(block_cls=BottleneckBlock, norm="lean", bn_remat=True,
                   device="cpu", **SMALL)
    assert remat(torch.zeros(2, 3, 32, 32)).shape == (2, 10)
    stock = ResNet(block_cls=BottleneckBlock, norm="batch",
                   bn_group=hvd.WORLD, device="cpu", **SMALL)
    assert stock(torch.zeros(2, 3, 32, 32)).shape == (2, 10)
    with pytest.raises(ValueError, match="ghost"):
        ResNet(block_cls=BottleneckBlock, norm="batch",
               bn_virtual_batch_size=2, device="cpu", **SMALL)
    for norm in ("lean", "pallas"):
        model = ResNet(block_cls=BottleneckBlock, norm=norm,
                       bn_virtual_batch_size=2, device="cpu", **SMALL)
        assert model(torch.zeros(4, 3, 32, 32)).shape == (4, 10)


def test_resnet50_shape_and_bn_layer_count():
    """ResNet-50's 53 BN layers (bn_init, 3 per block, 4 projections),
    each one K7 launch forward and one K8 launch backward on the card."""
    model = ResNet50PBN(num_classes=1000, dtype=torch.float32, device="cpu")
    from horovod_tpu_torch.ops import FusedBatchNorm
    assert sum(isinstance(m, FusedBatchNorm) for m in model.modules()) == 53
    n = sum(p.numel() for p in model.parameters())
    assert n == 25_557_032  # torchvision's resnet50 count
