"""The rest of the port's model zoo against the JAX package's flax models,
on the CPU.

Each flax model is initialised from a seed, its variables go into the
port through ``convert.py``, and the same numpy batch runs through both
in float32 (JAX at its highest matmul precision) in training mode: the
logits, the loss, every parameter's gradient and, where there is BN, the
running statistics after one forward.

- ``ResNet(norm="group"|"none")`` at a small depth (GroupNorm's 32 groups
  need 32 filters), basic and bottleneck blocks;
- ``VGG16`` at 64 x 64: 2 x 2 x 512 at the flatten, so fc0's (h, w, c)
  order shows (at 32 x 32 it is 1 x 1 and would hide it);
- ``InceptionV3`` at 75 x 75 (its smallest size): with ``norm="batch"``
  the whole model in float64 (94 ConvBN blocks, rectangular kernels,
  "VALID" convolutions and pools, the counting average pool; in float32
  the comparison is ill-conditioned, see the test), with ``"pallas"``
  (the plain versions here) block by block in float32;
- ``MnistCNN`` at 28 x 28; SkipGram's ``nce_loss`` and ``nearest``.

Dropout is neutralised on both sides for the comparisons, in this test
process only (flax's ``Dropout.__call__`` patched to the identity, the
port's rate set to 0); the port's dropout is tested on its own.
"""

import re

import flax.linen as flax_nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu import models as jax_models
from horovod_tpu.parallel.train import cross_entropy_loss as jax_xent
from horovod_tpu_torch.convert import (inception_v3_state_dict_from_jax,
                                       mnist_state_dict_from_jax,
                                       resnet_state_dict_from_jax,
                                       skipgram_state_dict_from_jax,
                                       vgg16_state_dict_from_jax)
from horovod_tpu_torch.models import (VGG16, BottleneckBlock, InceptionV3,
                                      MnistCNN, ResNet, ResNetBlock,
                                      SkipGram)
from horovod_tpu_torch.models.imagenet_extras import ConvBN, Dropout
from horovod_tpu_torch.parallel import cross_entropy_loss

jax.config.update("jax_default_matmul_precision", "highest")

# f32 models, the same arithmetic in another order: logits, and
# ||g_port - g_flax||_2 / ||g_flax||_2 per parameter
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4
# tests/test_models.py: the canonical VGG-16 count; InceptionV3 without
# the aux head (flax's count from its tree)
VGG16_PARAMS = 138_357_544
INCEPTION_PARAMS = 23_834_568

BLOCKS = {"bottleneck": (jax_models.resnet.BottleneckBlock, BottleneckBlock),
          "basic": (jax_models.resnet.ResNetBlock, ResNetBlock)}


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, x, *args, **kwargs: x)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _images(n, size, channels=3, seed=0, classes=10):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, size, size, channels).astype(np.float32),
            rng.randint(0, classes, n).astype(np.int32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _compare(jm, variables, port, convert, x, y, dtype=torch.float32):
    """Logits, loss and every gradient of the flax model ``jm`` (with
    ``variables``) and the port's ``port`` on the NHWC batch ``x``; returns
    the flax batch_stats after the forward (or None)."""
    stats = variables.get("batch_stats")

    def loss_fn(params):
        v = {"params": params}
        if stats:
            v["batch_stats"] = stats
            logits, upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
        else:
            logits, upd = jm.apply(v, x, train=True), None
        return jax_xent(logits, y), (logits, upd)

    (loss_j, (logits_j, upd)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    port.load_state_dict(convert(variables))
    port.train()
    logits = port(torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2).to(
        dtype))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    loss = cross_entropy_loss(logits, torch.from_numpy(np.asarray(y)).long())
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-6)
    loss.backward()
    want = convert(dict(variables, params=_np(grads_j)))
    for name, p in port.named_parameters():
        rel = _rel(p.grad.numpy(), want[name].numpy())
        assert rel <= GRAD_TOL, (name, rel)
    return None if upd is None else _np(upd["batch_stats"])


def _check_running(port, convert, variables, new_stats):
    want = convert(dict(variables, batch_stats=new_stats))
    for name, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("norm", ["group", "none"])
def test_gn_and_nf_resnets_match_flax(block, norm):
    kw = dict(stage_sizes=[1, 1], num_classes=10, num_filters=32)
    jm = jax_models.ResNet(block_cls=BLOCKS[block][0], dtype=jnp.float32,
                           norm=norm, **kw)
    x, y = _images(4, 32)
    variables = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]),
                            train=False))
    assert "batch_stats" not in variables
    rng = np.random.RandomState(2)
    if norm == "group":
        # flax starts the block-final GroupNorm scale at 0 as well: nonzero
        # scales let the gradients reach every layer
        for name, p in variables["params"].items():
            gns = sorted((k for k in p if re.fullmatch(r"GroupNorm_\d+", k)),
                         key=lambda k: int(k.rsplit("_", 1)[1]))
            if gns:
                assert not p[gns[-1]]["scale"].any()
                p[gns[-1]]["scale"] = rng.uniform(
                    0.5, 1.5, p[gns[-1]]["scale"].shape).astype(np.float32)
    port = ResNet(block_cls=BLOCKS[block][1], dtype=torch.float32, norm=norm,
                  device="cpu", **kw)
    if norm == "none":
        assert not any("norm" in n for n, _ in port.named_parameters())
    convert = lambda v: resnet_state_dict_from_jax(v, port)  # noqa: E731
    _compare(jm, variables, port, convert, jnp.asarray(x), jnp.asarray(y))


def test_vgg16_matches_flax_at_64(no_dropout):
    jm = jax_models.VGG16(num_classes=10, dtype=jnp.float32)
    x, y = _images(2, 64, seed=3)
    variables = _np(jm.init(jax.random.PRNGKey(3), jnp.asarray(x[:1]),
                            train=False))
    port = VGG16(num_classes=10, dtype=torch.float32, image_size=64,
                 device="cpu")
    port.dropout.rate = 0.0
    assert port.fc[0].in_features == 2 * 2 * 512
    convert = lambda v: vgg16_state_dict_from_jax(v, port)  # noqa: E731
    _compare(jm, variables, port, convert, jnp.asarray(x), jnp.asarray(y))


def test_inception_v3_matches_flax_at_75(no_dropout):
    """The whole model with the stock BN, in float64 on both sides: in
    float32 the comparison is ill-conditioned at initialisation (flax's own
    logits move 1.6e-3 when the input moves by 1e-7 relative at 75 x 75,
    3e-4 at batch 64 and 2e-5 at 299 x 299), so two sound f32
    implementations stand 1e-3 apart. In float64 every convolution, pool,
    concatenation and BN is compared."""
    with jax.enable_x64(True):
        jm = jax_models.InceptionV3(norm="batch", num_classes=10,
                                    dtype=jnp.float64)
        x, y = _images(2, 75, seed=4)
        x = x.astype(np.float64)
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            jm.init(jax.random.PRNGKey(4), jnp.asarray(x[:1]), train=False))
        port = InceptionV3(norm="batch", num_classes=10,
                           dtype=torch.float64, device="cpu").double()
        port.dropout.rate = 0.0
        assert sum(isinstance(m, ConvBN) for m in port.modules()) == 94
        assert all(m.bn.eps == 1e-3 for m in port.modules()
                   if isinstance(m, ConvBN))
        convert = lambda v: {  # noqa: E731
            k: t.double() for k, t in
            inception_v3_state_dict_from_jax(v, port).items()}
        new_stats = _compare(jm, variables, port, convert, jnp.asarray(x),
                             jnp.asarray(y), dtype=torch.float64)
    _check_running(port, convert, variables, new_stats)


# ConvBN blocks of InceptionV3 checked alone (index in flax's order): the
# five of the stem (3x3 stride-2 and stride-1 "VALID", "SAME", 1x1
# "VALID"), an A block's 1x1 and 5x5, B's 3x3 stride-2 "VALID", a C
# block's (1, 7) and (7, 1), D's stride-2 3x3, an E block's (1, 3),
# (3, 1) and its last 1x1
PALLAS_LAYERS = (0, 1, 2, 3, 4, 5, 6, 26, 34, 35, 71, 77, 78, 93)


def test_inception_v3_pallas_blocks_match_flax_at_75():
    """norm="pallas" (``FusedBatchNorm``'s plain versions against flax's
    ``PallasBatchNorm``), block by block in float32, so the comparison is
    well-conditioned: each ConvBN of PALLAS_LAYERS takes the input the
    port's model gives it at 75 x 75 (batch 4), and its output, its running
    statistics and the gradients of a random cotangent with respect to its
    input, kernel, scale and bias are held against flax's ``_ConvBN`` with
    the same variables."""
    from horovod_tpu.models.imagenet_extras import _ConvBN
    jm = jax_models.InceptionV3(norm="pallas", num_classes=10,
                                dtype=jnp.float32)
    x, _ = _images(4, 75, seed=4)
    variables = _np(jm.init(jax.random.PRNGKey(4), jnp.asarray(x[:1]),
                            train=False))
    port = InceptionV3(norm="pallas", num_classes=10, dtype=torch.float32,
                       device="cpu")
    port.load_state_dict(inception_v3_state_dict_from_jax(variables, port))
    blocks = [m for m in port.modules() if isinstance(m, ConvBN)]
    inputs = {}
    hooks = [blocks[i].register_forward_pre_hook(
        lambda m, args, i=i: inputs.setdefault(i, args[0].detach().clone()))
        for i in PALLAS_LAYERS]
    port.train()
    with torch.no_grad():
        port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    # the running statistics as flax's, before each block's own forward
    port.load_state_dict(inception_v3_state_dict_from_jax(variables, port))
    rng = np.random.RandomState(8)
    for i in PALLAS_LAYERS:
        block, xin = blocks[i], inputs[i]
        conv = block.conv
        stride = conv.stride if isinstance(conv.stride, tuple) else \
            (conv.stride,) * 2
        jb = _ConvBN(conv.weight.shape[0], tuple(conv.weight.shape[2:]),
                     stride, conv.padding, dtype=jnp.float32, norm="pallas")
        name = "_ConvBN_%d" % i
        v = {"params": variables["params"][name],
             "batch_stats": variables["batch_stats"][name]}
        xj = jnp.asarray(xin.permute(0, 2, 3, 1).numpy())

        def fwd(params, xj, v=v, jb=jb):
            return jb.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xj, True,
                            mutable=["batch_stats"])

        yj, vjp, upd = jax.vjp(fwd, v["params"], xj, has_aux=True)
        ct = rng.randn(*yj.shape).astype(np.float32)
        gp, gx = vjp(jnp.asarray(ct))
        xt = xin.clone().requires_grad_()
        block.zero_grad()
        y = block(xt)
        # norm-relative: a block's output, not logits (at 1 x 1 x 4 values
        # a channel's BN divides f32 roundings by a small deviation)
        rel = _rel(y.permute(0, 2, 3, 1).detach().numpy(), np.asarray(yj))
        assert rel <= LOGIT_TOL, (name, rel)
        y.backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
        gp = _np(gp)
        bn = "PallasBatchNorm_0"
        for got, want, what in (
                (xt.grad.permute(0, 2, 3, 1), np.asarray(gx), "x"),
                (conv.weight.grad.permute(2, 3, 1, 0),
                 gp["Conv_0"]["kernel"], "kernel"),
                (block.bn.weight.grad, gp[bn]["scale"], "scale"),
                (block.bn.bias.grad, gp[bn]["bias"], "bias")):
            rel = _rel(got.numpy(), want)
            assert rel <= GRAD_TOL, (name, what, rel)
        new = _np(upd["batch_stats"])[bn]
        np.testing.assert_allclose(block.bn.running_mean.numpy(),
                                   new["mean"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(block.bn.running_var.numpy(),
                                   new["var"], rtol=1e-5, atol=1e-6)


def test_mnist_cnn_matches_flax():
    jm = jax_models.MnistCNN(dtype=jnp.float32)
    x, y = _images(4, 28, channels=1, seed=5)
    variables = _np(jm.init(jax.random.PRNGKey(5), jnp.asarray(x[:1]),
                            train=False))
    port = MnistCNN(dtype=torch.float32, device="cpu")
    convert = mnist_state_dict_from_jax
    _compare(jm, variables, port, convert, jnp.asarray(x), jnp.asarray(y))


def test_skipgram_nce_loss_and_nearest_match_flax():
    V, D, B, K = 200, 32, 16, 8
    jm = jax_models.SkipGram(vocab_size=V, embedding_dim=D)
    rng = np.random.RandomState(6)
    center, context = (rng.randint(0, V, B).astype(np.int32)
                       for _ in range(2))
    neg = rng.randint(0, V, K).astype(np.int32)
    variables = _np(jm.init(jax.random.PRNGKey(6), jnp.asarray(center)))
    # nonzero biases so their gradients and the logits' offsets show
    variables["params"]["nce_bias"] = rng.randn(V).astype(np.float32) * 0.1

    def loss_fn(params):
        return jm.apply({"params": params}, center, context, neg,
                        method=jax_models.SkipGram.nce_loss)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(variables["params"])
    port = SkipGram(V, D, device="cpu")
    port.load_state_dict(skipgram_state_dict_from_jax(variables))
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731
    loss = port.nce_loss(t(center), t(context), t(neg))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-6)
    loss.backward()
    want = skipgram_state_dict_from_jax({"params": _np(grads_j)})
    for name, p in port.named_parameters():
        rel = _rel(p.grad.numpy(), want[name].numpy())
        assert rel <= GRAD_TOL, (name, rel)
    ids = np.arange(12, dtype=np.int32)
    near_j = jm.apply(variables, ids, k=5, method=jax_models.SkipGram.nearest)
    assert torch.equal(port.nearest(t(ids), k=5), t(np.asarray(near_j)))
    np.testing.assert_allclose(port(t(center)).detach().numpy(),
                               np.asarray(jm.apply(variables, center)))


def test_parameter_counts_equal_flax_and_the_canonical_counts():
    for jm, port, shape, canonical in (
            (jax_models.VGG16(num_classes=1000, dtype=jnp.float32),
             VGG16(dtype=torch.float32, device="cpu"), (1, 224, 224, 3),
             VGG16_PARAMS),
            (jax_models.InceptionV3(num_classes=1000, dtype=jnp.float32),
             InceptionV3(dtype=torch.float32, device="cpu"),
             (1, 299, 299, 3), INCEPTION_PARAMS)):
        variables = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros(shape), train=False))
        n = sum(p.size for p in jax.tree_util.tree_leaves(
            variables["params"]))
        assert sum(p.numel() for p in port.parameters()) == n == canonical


def test_dropout_keeps_half_scaled_and_is_seeded():
    """Training mode: each element kept with probability 1/2 from the
    module's own generator and doubled, the rest 0; eval mode the identity;
    two modules with one seed draw the same masks."""
    x = torch.ones(4096)
    a, b = Dropout(0.5, seed=3), Dropout(0.5, seed=3)
    ya, yb = a(x), b(x)
    assert torch.equal(ya, yb)
    assert set(ya.unique().tolist()) == {0.0, 2.0}
    assert abs(ya.mean().item() - 1.0) < 0.1
    assert not torch.equal(a(x), ya)  # the generator moves on
    a.eval()
    assert torch.equal(a(x), x)


def test_the_zoo_trains_channels_last_through_fused_bn():
    """InceptionV3(norm="pallas") in bf16 at 75 x 75: every BN input is a
    channels-last convolution output (FusedBatchNorm raises otherwise), the
    concatenations stay channels-last, and one step's loss falls."""
    torch.manual_seed(0)
    model = InceptionV3(norm="pallas", num_classes=10, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    x, y = _images(4, 75, seed=7)
    x = torch.from_numpy(x).permute(0, 3, 1, 2)
    y = torch.from_numpy(y).long()
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = cross_entropy_loss(model(x), y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
