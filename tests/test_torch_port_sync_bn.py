"""The rest of the port's BN against the JAX package's, on the CPU.

- Sync BN on the stock path (``StockBatchNorm(group=)``,
  ``stock_sync_batch_norm_train``) on 2 and 4 gloo ranks
  (tests/torch_port_api_worker.py, spawned once per world size) against
  flax's ``nn.BatchNorm`` over the whole batch, on the inputs of
  tests/test_batch_norm.py::test_sync_bn_matches_global_batch and under
  its loss contract (a local loss sum(y * w) on each shard, no loss sum
  over the ranks): outputs, batch statistics, dx per shard, and dgamma and
  dbeta summed over the ranks, within 1e-5.
- ``sync_batch_norm_stats`` against ``horovod_tpu.jax.
  sync_batch_norm_stats`` in-jit under ``shard_map`` on the same partial
  sums.
- ``ResNet(norm="lean", bn_remat=True)`` on a small model: gradients and
  running statistics against the flax ``ResNet(norm="lean",
  bn_remat=True)`` and, bit for bit, against the port's own
  ``bn_remat=False``; what it keeps for the backward.
- ``bn_apply`` and ``bn_dx`` through their custom-op registrations against
  their plain versions, bit for bit.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu.jax as hvd_jax
from horovod_tpu.models import resnet as jax_resnet
from horovod_tpu_torch.convert import resnet_state_dict_from_jax
from horovod_tpu_torch.models import ResNet
from horovod_tpu_torch.ops import batch_norm as tbn
from horovod_tpu_torch.parallel import classification_loss

import test_torch_port_resnet as rn
import torch_port_api_worker as worker

jax.config.update("jax_default_matmul_precision", "highest")

# f32 on both sides, the sums in another order
TOL = 1e-5


@pytest.fixture(scope="module")
def stock_ranks(tmp_path_factory):
    base = tmp_path_factory.mktemp("sync_bn")
    out = {}
    for size in (2, 4):
        (base / str(size)).mkdir()
        out[size] = worker.spawn_sync_bn(base / str(size), size)
    return out


def _flax_global():
    """flax nn.BatchNorm over the whole batch: y, the batch mean and
    variance, and the gradients of sum(y * w) for x, scale and bias."""
    x, w, gamma, beta = (jnp.asarray(a) for a in worker.sync_bn_inputs())
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {"mean": jnp.zeros(worker.BN_C), "var": jnp.ones(worker.BN_C)}

    def loss(x, scale, bias):
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": stats}, x, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd["batch_stats"])

    (_, (y, upd)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(x, gamma, beta)
    return dict(y=np.asarray(y), mean=np.asarray(jnp.mean(x, 0)),
                var=np.asarray(jnp.var(x, 0)), dx=np.asarray(grads[0]),
                dgamma=np.asarray(grads[1]), dbeta=np.asarray(grads[2]),
                running=(np.asarray(upd["mean"]), np.asarray(upd["var"])))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b, rtol=TOL,
                               atol=TOL * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("what", ["y", "statistics", "dx", "dgamma_dbeta",
                                  "running"])
def test_stock_sync_bn_matches_the_global_batch(stock_ranks, size, what):
    ref = _flax_global()
    outs = stock_ranks[size]
    if what in ("y", "dx"):
        _close(torch.cat([o[what] for o in outs]).numpy(), ref[what])
    elif what == "statistics":
        for o in outs:
            _close(o["mean"].numpy(), ref["mean"])
            _close(o["var"].numpy(), ref["var"])
    elif what == "dgamma_dbeta":
        # each rank's are local; the gradient allreduce sums them
        for name in ("dgamma", "dbeta"):
            _close(sum(o[name] for o in outs).numpy(), ref[name])
            assert not torch.allclose(outs[0][name], outs[1][name])
    else:
        for o in outs:
            _close(o["running"][0].numpy(), ref["running"][0])
            _close(o["running"][1].numpy(), ref["running"][1])


@pytest.mark.parametrize("size", [2, 4])
def test_sync_batch_norm_stats_matches_the_jax_wrapper(stock_ranks, size):
    """The ranks' (mean, var, global count) from their partial sums, against
    the JAX wrapper with the same sums in-jit over a mapped axis."""
    x = worker.sync_bn_inputs()[0].reshape(size, -1, worker.BN_C)
    mesh = Mesh(np.array(jax.devices("cpu")[:size]), ("hvd",))
    count = x.shape[1]

    def fn(xs):
        mean, var, n = hvd_jax.sync_batch_norm_stats(
            xs[0].sum(0), (xs[0] * xs[0]).sum(0), count)
        assert n == count * size
        return mean[None], var[None]

    mean, var = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P("hvd"), out_specs=(P("hvd"), P("hvd")),
        check_vma=False))(jnp.asarray(x))
    for r, o in enumerate(stock_ranks[size]):
        got_mean, got_var, n = o["stats"]
        assert n == count * size
        _close(got_mean.numpy(), np.asarray(mean)[r])
        _close(got_var.numpy(), np.asarray(var)[r])


def test_stock_sync_bn_takes_every_kind_of_group():
    """A port ProcessGroup, WORLD and a torch process group reach the same
    collective; None is no sync (F.batch_norm)."""
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        x = torch.randn(4, 3, 2, 2)
        ys = [tbn.StockBatchNorm(3, group=g, device="cpu")(x) for g in (
            hvd.WORLD, hvd.new_group([0]), hvd.process_group())]
        plain = tbn.StockBatchNorm(3, device="cpu")(x)
        for y in ys:
            torch.testing.assert_close(y, ys[0], rtol=0, atol=0)
            torch.testing.assert_close(y, plain, rtol=1e-5, atol=1e-5)
    finally:
        hvd.shutdown()


# ------------------------------------------------------------- bn_remat


def _flax_remat_grads(block):
    """The flax lean ResNet with bn_remat: (loss, grads, batch stats after
    one train-mode forward) on rn._batch(), on rn._flax_model's weights."""
    jm, variables = rn._flax_model(block, "lean")
    remat = jax_resnet.ResNet(block_cls=rn.BLOCKS[block][0],
                              dtype=jnp.float32, norm="lean", bn_remat=True,
                              **rn.SMALL)

    def renamed(tree):  # nn.remat names the blocks Checkpoint<Block>_i
        return {("Checkpoint" + k if "Block_" in k else k): v
                for k, v in tree.items()}

    rv = {k: renamed(v) for k, v in variables.items()}
    x, y = rn._batch()
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    with jax.default_matmul_precision("highest"):
        _, upd = remat.apply(rv, batch["x"], train=True,
                             mutable=["batch_stats"])
        loss, grads = jax.value_and_grad(rn._flax_loss_fn(
            remat, rv["batch_stats"]))(rv["params"], batch)
    return variables, float(loss), grads, upd


def _port_pair(block, variables, dtype=torch.float32):
    models = [ResNet(block_cls=rn.BLOCKS[block][1], dtype=dtype,
                     norm="lean", bn_remat=remat, device="cpu", **rn.SMALL)
              for remat in (False, True)]
    for m in models:
        m.load_state_dict(resnet_state_dict_from_jax(variables, m))
    return models


@pytest.mark.parametrize("block", sorted(rn.BLOCKS))
def test_bn_remat_matches_flax_and_equals_no_remat(block):
    variables, loss_j, grads_j, upd = _flax_remat_grads(block)
    plain, remat = _port_pair(block, variables)
    x, y = rn._batch()
    tb = rn._torch_batch(x, y)
    losses = []
    for m in (plain, remat):
        loss = classification_loss(m, tb)
        loss.backward()
        losses.append(loss.item())
    assert losses[0] == losses[1]
    assert abs(losses[1] - loss_j) <= 1e-5 * abs(loss_j)
    expected = resnet_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": {k.replace("Checkpoint", ""): v
                                for k, v in grads_j.items()},
                     "batch_stats": variables["batch_stats"]}), remat)
    for (name, p), q in zip(remat.named_parameters(), plain.parameters()):
        assert torch.equal(p.grad, q.grad), name
        ref = expected[name]
        rel = ((p.grad - ref).norm() / ref.norm()).item()
        assert rel <= rn.GRAD_TOL, (name, rel)
    # the running statistics: updated once, as flax's
    after = resnet_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": variables["params"],
                     "batch_stats": {k.replace("Checkpoint", ""): v
                                     for k, v in upd["batch_stats"].items()}}),
        remat)
    for (name, b), c in zip(remat.named_buffers(), plain.buffers()):
        assert torch.equal(b, c), name
        np.testing.assert_allclose(b.numpy(), after[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("block", sorted(rn.BLOCKS))
def test_bn_remat_in_bfloat16_equals_no_remat(block):
    """bf16 convolutions and the lean passes in bf16: still the same
    operations on the same values, so the same bits."""
    _, variables = rn._flax_model(block, "lean")
    plain, remat = _port_pair(block, variables, torch.bfloat16)
    tb = rn._torch_batch(*rn._batch())
    for m in (plain, remat):
        classification_loss(m, tb).backward()
    for (name, p), q in zip(remat.named_parameters(), plain.parameters()):
        assert torch.equal(p.grad, q.grad), name


def _saved_numel(model, x):
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        model(x)
    return sum(saved)


@pytest.mark.parametrize("block", sorted(rn.BLOCKS))
def test_bn_remat_keeps_no_normalize_output(block):
    """What bn_remat=True keeps for the backward is bn_remat=False's less
    the inputs of every convolution after a norm inside a block (each
    norm's output, padded where the convolution pads it asymmetrically),
    plus each such norm's per-channel a and b, which the backward's
    recomputation reads as the forward formed them."""
    _, variables = rn._flax_model(block, "lean")
    plain, remat = _port_pair(block, variables)
    x = rn._torch_batch(*rn._batch())["x"]
    conv_inputs, channels = [], []

    def record(mod, args):
        conv_inputs.append(_padded_numel(mod, args[0]))
        channels.append(args[0].shape[1])
    hooks = [conv.register_forward_pre_hook(record)
             for b in plain.blocks for conv in b.convs[1:]]
    before = _saved_numel(plain, x)
    for h in hooks:
        h.remove()
    assert len(conv_inputs) == len(plain.blocks) * (len(plain.blocks[0].convs)
                                                    - 1)
    assert _saved_numel(remat, x) == (before - sum(conv_inputs)
                                      + 2 * sum(channels))


def _padded_numel(conv, x):
    pad, _ = conv.pads(x.shape)
    if not pad:
        return x.numel()
    lf, r, t, b = pad
    n, c, h, w = x.shape
    return n * c * (h + t + b) * (w + lf + r)


def test_bn_remat_is_accepted_and_changes_nothing_for_other_norms():
    """As in the reference, only the lean norms' outputs are tagged: with
    norm="batch" or "pallas" bn_remat builds the same blocks."""
    for norm in ("batch", "pallas"):
        model = ResNet(block_cls=rn.BLOCKS["bottleneck"][1], norm=norm,
                       bn_remat=True, device="cpu", **rn.SMALL)
        assert not any(b.bn_remat for b in model.blocks)
        assert model(torch.zeros(2, 3, 32, 32)).shape == (2, 10)
    lean = ResNet(block_cls=rn.BLOCKS["bottleneck"][1], norm="lean",
                  bn_remat=True, device="cpu", **rn.SMALL)
    assert all(b.bn_remat for b in lean.blocks)


@pytest.mark.parametrize("mode", tbn.MODES)
@pytest.mark.parametrize("relu,groups", [(False, 1), (True, 1), (True, 3)])
def test_custom_ops_equal_the_plain_versions(mode, relu, groups):
    """torch.ops.horovod_tpu_torch.bn_apply and .bn_dx on CPU tensors: the
    plain versions, bit for bit, with the cotangents of mean and var."""
    rng = np.random.RandomState(3)
    M, C = 12, 5
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    x = t(M, C).to(torch.bfloat16)
    dy = t(M, C).to(torch.bfloat16)
    shape = (C,) if groups == 1 else (groups, C)
    mean, rstd = t(*shape), t(*shape).abs() + 0.5
    gamma, beta = t(C), t(C)
    a, b = t(*shape), t(*shape)
    y = torch.ops.horovod_tpu_torch.bn_apply(x, a, b, groups, relu, mode)
    assert torch.equal(y, tbn.bn_apply_ref(x, a, b, groups, relu, mode))
    args = (dy, x, mean, rstd, gamma, beta, t(*shape), t(*shape), M // groups,
            groups, relu, mode, t(*shape), t(*shape))
    dx = torch.ops.horovod_tpu_torch.bn_dx(*args)
    assert torch.equal(dx, tbn.bn_dx_ref(*args))
