"""The port's traffic-lean BN (``lean_batch_norm_train``, ``LeanBatchNorm``,
ghost BN through ``FusedBatchNorm``, ``ResNet(norm="lean")``) against the
JAX package's, on the CPU, where the kernels' plain versions run. Inputs
are made with numpy from a seed and handed to both packages as the same
numbers (bf16 inputs rounded once in torch)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import resnet as jax_resnet
from horovod_tpu.ops import batch_norm as jbn
from horovod_tpu_torch.convert import resnet_state_dict_from_jax
from horovod_tpu_torch.models import ResNet50Lean
from horovod_tpu_torch.ops import batch_norm as tbn
from horovod_tpu_torch.parallel import classification_loss

import test_torch_port_resnet as rn
import torch_port_bn_worker as worker

jax.config.update("jax_default_matmul_precision", "highest")

# float32: the same f32 arithmetic, the sums in another order; measured
# 7.1e-7 (max |port - jax| / max |jax| over y, mean, var, dx, dgamma,
# dbeta and the cases below).
F32_TOL = 1e-5
# bfloat16: y and dx are rounded to bf16 after every operation on both
# sides (XLA's CPU rounds each bf16 op as the port's lean mode does), and
# measured equal bit for bit; the f32 statistics and dgamma, dbeta are sums
# in another order, measured 2.8e-7.
BF16_STATS_TOL = 1e-5


def _jnp(t):
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(512, 128), (392, 64), (96, 12),
                                   (6, 5, 7, 13)])
def test_lean_batch_norm_train_matches_jax(shape, relu, groups, dtype):
    """(y, mean, var) and the VJP (dx, dgamma, dbeta) under nonzero
    cotangents of y, mean and var, against the JAX custom_vjp."""
    dt = getattr(torch, dtype)
    C = shape[-1]
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 2 + 0.5
                         ).to(dt)
    gamma = rng.rand(C).astype(np.float32) + 0.5
    beta = rng.randn(C).astype(np.float32)
    gy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dt)
    stat = (C,) if groups == 1 else (groups, C)
    gm = rng.randn(*stat).astype(np.float32)
    gv = rng.randn(*stat).astype(np.float32)

    def f(x, gamma, beta):
        return jbn.lean_batch_norm_train(x, gamma, beta, 1e-5, relu, groups)

    outs_j, vjp = jax.vjp(f, _jnp(x), jnp.asarray(gamma), jnp.asarray(beta))
    grads_j = vjp((_jnp(gy), jnp.asarray(gm), jnp.asarray(gv)))

    leaves = [x.clone().requires_grad_(), torch.from_numpy(gamma)
              .requires_grad_(), torch.from_numpy(beta).requires_grad_()]
    outs = tbn.lean_batch_norm_train(*leaves, 1e-5, relu, groups)
    grads = torch.autograd.grad(outs, leaves, [gy, torch.from_numpy(gm),
                                               torch.from_numpy(gv)])
    assert outs[0].dtype == dt and outs[0].shape == x.shape
    assert outs[1].shape == outs[2].shape == stat
    for name, a, b in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"),
                          list(outs) + list(grads),
                          list(outs_j) + list(grads_j)):
        a = a.detach().float().numpy()
        if dtype == "bfloat16" and name in ("y", "dx"):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32),
                                          err_msg=name)
        else:
            tol = F32_TOL if dtype == "float32" else BF16_STATS_TOL
            assert _rel(a, b) <= tol, (name, _rel(a, b))


def test_lean_module_matches_flax_lean_batch_norm():
    """Two training steps update the running statistics as flax's
    LeanBatchNorm does, eval mode (with and without the fused ReLU) uses
    them, ghost BN's running statistics are the mean of the group
    statistics, and a virtual batch that does not divide the batch raises.
    The port's module takes [N, C, H, W] channels_last; flax's [N, H, W,
    C]."""
    rng = np.random.RandomState(6)
    xs = [rng.randn(8, 4, 4, 16).astype(np.float32) * 1.5 + 0.3
          for _ in range(2)]
    scale = rng.rand(16).astype(np.float32) + 0.5
    bias = rng.randn(16).astype(np.float32)

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    def nhwc(t):
        return t.detach().permute(0, 2, 3, 1).numpy()

    for fuse_relu, vbs in ((False, None), (True, None), (True, 2)):
        ours = jbn.LeanBatchNorm(momentum=0.9, epsilon=1e-5,
                                 fuse_relu=fuse_relu, virtual_batch_size=vbs)
        variables = ours.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
        variables = {"params": {"scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)},
                     "batch_stats": variables["batch_stats"]}
        bn = tbn.LeanBatchNorm(16, eps=1e-5, momentum=0.9,
                               fuse_relu=fuse_relu, virtual_batch_size=vbs,
                               device="cpu")
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
        for x in xs:
            y_j, upd = ours.apply(variables, jnp.asarray(x),
                                  mutable=["batch_stats"])
            variables = {"params": variables["params"], **upd}
            y = bn(nchw(x))
            assert y.is_contiguous(memory_format=torch.channels_last)
            assert _rel(nhwc(y), y_j) <= F32_TOL
            for ours_k, flax_k in (("running_mean", "mean"),
                                   ("running_var", "var")):
                np.testing.assert_allclose(
                    getattr(bn, ours_k).numpy(),
                    np.asarray(variables["batch_stats"][flax_k]), rtol=1e-6,
                    atol=1e-6, err_msg=(ours_k, fuse_relu, vbs))

        bn.eval()
        before = tbn.launch_counts()
        y_e = bn(nchw(xs[0]))
        assert tbn.launch_counts() == before
        ours_e = jbn.LeanBatchNorm(use_running_average=True, epsilon=1e-5,
                                   fuse_relu=fuse_relu)
        assert _rel(nhwc(y_e), ours_e.apply(variables, jnp.asarray(xs[0]))
                    ) <= F32_TOL
        if fuse_relu:
            assert (y_e >= 0).all()

    bad = tbn.LeanBatchNorm(16, virtual_batch_size=3, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        bad(nchw(xs[0]))


def test_fused_batch_norm_ghost_matches_pallas_batch_norm():
    """FusedBatchNorm(virtual_batch_size=) against
    PallasBatchNorm(virtual_batch_size=): y, the running statistics and the
    VJP (dx, dscale, dbias), both through the lean path without the ReLU."""
    rng = np.random.RandomState(7)
    x = rng.randn(8, 4, 4, 24).astype(np.float32) * 1.5 + 0.3
    w = rng.randn(*x.shape).astype(np.float32)
    scale = rng.rand(24).astype(np.float32) + 0.5
    bias = rng.randn(24).astype(np.float32)
    ours = jbn.PallasBatchNorm(momentum=0.9, epsilon=1e-5,
                               virtual_batch_size=2)
    stats = ours.init(jax.random.PRNGKey(0), jnp.asarray(x))["batch_stats"]

    def f(x, scale, bias):
        v = {"params": {"scale": scale, "bias": bias}, "batch_stats": stats}
        return ours.apply(v, x, mutable=["batch_stats"])

    (y_j, upd), vjp = jax.vjp(f, *map(jnp.asarray, (x, scale, bias)))
    grads_j = vjp((jnp.asarray(w), jax.tree_util.tree_map(jnp.zeros_like,
                                                          upd)))

    bn = tbn.FusedBatchNorm(24, eps=1e-5, momentum=0.9, virtual_batch_size=2,
                            device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = bn(xt)
    grads = torch.autograd.grad(
        y, (xt, bn.weight, bn.bias),
        torch.from_numpy(w).permute(0, 3, 1, 2))
    assert _rel(y.detach().permute(0, 2, 3, 1).numpy(), y_j) <= F32_TOL
    assert _rel(grads[0].permute(0, 2, 3, 1).numpy(), grads_j[0]) <= F32_TOL
    for name, a, b in (("dscale", grads[1], grads_j[1]),
                       ("dbias", grads[2], grads_j[2]),
                       ("running_mean", bn.running_mean,
                        upd["batch_stats"]["mean"]),
                       ("running_var", bn.running_var,
                        upd["batch_stats"]["var"])):
        assert _rel(a.detach().numpy(), b) <= F32_TOL, name


@pytest.mark.parametrize("block", sorted(rn.BLOCKS))
def test_small_lean_resnet_matches_flax(block):
    """ResNet(norm="lean") against the flax ResNet(norm="lean"), the flax
    variables carried in by ``resnet_state_dict_from_jax``: logits, the
    running statistics after one train-mode forward, the loss and every
    parameter's gradient."""
    jm, variables = rn._flax_model(block, "lean")
    x, y = rn._batch()
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    with jax.default_matmul_precision("highest"):
        logits_j, upd = jm.apply(variables, batch["x"], train=True,
                                 mutable=["batch_stats"])
        loss_j, grads_j = jax.value_and_grad(
            rn._flax_loss_fn(jm, variables["batch_stats"]))(
                variables["params"], batch)

    model = rn._port_model(block, "lean", variables)
    n_fused = sum(m.fuse_relu for m in model.modules()
                  if isinstance(m, tbn.LeanBatchNorm))
    assert n_fused == 1 + len(model.blocks) * (len(model.blocks[0].norms) - 1)
    tb = rn._torch_batch(x, y)
    logits = model(tb["x"])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=rn.LOGIT_TOL, atol=rn.LOGIT_TOL)
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
        assert ref.norm() > 0, name
        rel = ((p.grad - ref).norm() / ref.norm()).item()
        assert rel <= rn.GRAD_TOL, (name, rel)


def test_lean_state_dict_conversion_round_trip():
    """The converter carries flax lean weights across unchanged: every flax
    leaf lands on one port tensor, and the same tree loads into the stock
    and pallas models under the same keys."""
    _, variables = rn._flax_model("bottleneck", "lean")
    model = rn._port_model("bottleneck", "lean", variables)
    sd = resnet_state_dict_from_jax(variables, model)
    assert set(sd) == set(model.state_dict())
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(variables))
    assert n_flax == sum(t.numel() for t in sd.values())
    p = variables["params"]["BottleneckBlock_1"]
    np.testing.assert_array_equal(
        model.blocks[1].norms[2].weight.detach().numpy(),
        p["LeanBatchNorm_2"]["scale"])
    for norm in ("batch", "pallas"):
        other = rn._port_model("bottleneck", norm, variables)
        for name, t in other.state_dict().items():
            assert torch.equal(t, sd[name]), (norm, name)


def test_resnet50_lean_shape_and_bn_layer_count():
    """ResNet-50 with norm="lean": torchvision's parameter count, 53 lean
    BN layers, 33 of them (the stem's and the first two of each block)
    with the ReLU fused."""
    model = ResNet50Lean(num_classes=1000, dtype=torch.float32, device="cpu")
    lean = [m for m in model.modules() if isinstance(m, tbn.LeanBatchNorm)]
    assert len(lean) == 53
    assert sum(m.fuse_relu for m in lean) == 33
    assert model.bn_init.fuse_relu
    assert not any(b.norms[-1].fuse_relu for b in model.blocks)
    assert sum(p.numel() for p in model.parameters()) == 25_557_032


def test_lean_layer_saves_only_x_mean_rstd_and_the_parameters():
    """A lean layer with the fused ReLU keeps for its backward x (the conv
    output, already alive), gamma, beta, mean and rstd, and nothing of
    its output: the backward recomputes x_hat and the mask."""
    bn = tbn.LeanBatchNorm(12, fuse_relu=True, device="cpu")
    x = torch.randn(4, 12, 5, 5).to(memory_format=torch.channels_last)
    x.requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = bn(x)
    assert len(saved) == 5, [tuple(t.shape) for t in saved]
    xs, gamma, beta, mean, rstd = saved
    assert xs.data_ptr() == x.data_ptr() and xs.shape == (4, 5, 5, 12)
    assert gamma.data_ptr() == bn.weight.data_ptr()
    assert beta.data_ptr() == bn.bias.data_ptr()
    assert mean.shape == rstd.shape == (12,)
    assert sum(t.numel() for t in saved) == x.numel() + 4 * 12
    y.sum().backward()
    assert x.grad.shape == x.shape


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    """On CPU tensors the four wrappers are their plain versions and count
    no launch; a mode they do not know and groups that do not divide the
    rows raise."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    a, b = torch.rand(2, 8), torch.randn(2, 8)
    before = tbn.launch_counts()
    assert torch.equal(tbn.bn_apply(x, a, b, 2, True, "lean"),
                       tbn.bn_apply_ref(x, a, b, 2, True, "lean"))
    assert torch.equal(tbn.batch_norm_stats(x, 2)[1],
                       tbn.batch_norm_stats_ref(x, 2)[1])
    assert tbn.launch_counts() == before
    y = tbn.bn_apply(x, a[0], b[0])
    assert torch.equal(y, (x * a[0] + b[0]))
    with pytest.raises(ValueError, match="does not divide"):
        tbn.lean_batch_norm_train(x, a[0], b[0], groups=3)
    with pytest.raises(ValueError, match="mask needs"):
        tbn.bn_dx(x, x, a[0], a[0], a[0], None, a[0], a[0], 16, relu=True)


@pytest.mark.parametrize("groups", [1, 2])
def test_lean_sync_bn_on_two_gloo_ranks_equals_global_batch_bn(tmp_path,
                                                               groups):
    """Each of 2 ranks holds half the rows, in ``groups`` ghost groups of
    its own; with group= and the fused ReLU, the statistics, y and dx equal
    the lean BN of one process over the whole batch whose ghost group g is
    the two ranks' groups g, and the ranks' local dgamma and dbeta sum to
    its (the gradient allreduce's job)."""
    outs = worker.spawn(functools.partial(worker.run_lean, groups=groups),
                        tmp_path)
    x, gamma, beta, gy = worker.bn_inputs()
    size, M = len(outs), x.shape[0]
    # rows in the global order of the ghost groups: (rank 0 group 0, rank 1
    # group 0, rank 0 group 1, ...)
    order = torch.arange(M).view(size, groups, -1).transpose(0, 1).reshape(-1)
    leaves = [t.clone().requires_grad_() for t in (x[order], gamma, beta)]
    y, mean, var = tbn.lean_batch_norm_train(*leaves, 1e-5, True, groups)
    dx, dgamma, dbeta = torch.autograd.grad(y, leaves, gy[order])
    back = torch.empty_like(order)
    back[order] = torch.arange(M)
    tol = dict(rtol=1e-5, atol=1e-5)
    for out in outs:
        torch.testing.assert_close(out["mean"], mean, **tol)
        torch.testing.assert_close(out["var"], var, **tol)
    torch.testing.assert_close(torch.cat([o["y"] for o in outs]),
                               y.detach()[back], **tol)
    torch.testing.assert_close(torch.cat([o["dx"] for o in outs]),
                               dx[back], **tol)
    torch.testing.assert_close(sum(o["dgamma"] for o in outs), dgamma, **tol)
    torch.testing.assert_close(sum(o["dbeta"] for o in outs), dbeta, **tol)


@pytest.mark.parametrize("cot", ["none", "gmean", "gvar"])
@pytest.mark.parametrize("groups,shared", [(1, False), (3, False),
                                           (3, True)])
@pytest.mark.parametrize("M,C", [(303, 32), (261, 48), (129, 80),
                                 (75, 192), (33, 448)])
def test_lean_dx_plain_version_matches_lean_bwd(M, C, groups, shared, cot):
    """bn_dx_ref in lean mode (each division by the row count a product
    with the f32 reciprocal the kernel is handed) against _lean_bwd at the
    widths of Inception's launches, odd M, with the ReLU mask: dx bit for
    bit. With ghost groups the statistics are (G, C), or one (C,) vector
    for every group (``shared``, tiled to (G, C) on the JAX side); the mean
    and var cotangents one at a time (zeros on the JAX side)."""
    rng = np.random.RandomState(C + groups)
    x = torch.from_numpy(rng.randn(M, C).astype(np.float32) * 2 + 0.5).to(
        torch.bfloat16)
    gy = torch.from_numpy(rng.randn(M, C).astype(np.float32)).to(
        torch.bfloat16)
    gamma = torch.from_numpy(rng.rand(C).astype(np.float32) + 0.5)
    beta = torch.from_numpy(rng.randn(C).astype(np.float32))
    xg = x.float().view(groups, -1, C)
    var, mean = torch.var_mean(xg[0] if shared or groups == 1 else xg, -2,
                               correction=0)
    rstd = torch.rsqrt(var + 1e-5)
    stat = (groups, C) if groups > 1 else (C,)

    def full(t):
        return t.expand(stat).contiguous()
    gm = torch.from_numpy(rng.randn(*stat).astype(np.float32))
    gv = torch.from_numpy(rng.randn(*stat).astype(np.float32))
    cots = {"gmean": gm if cot == "gmean" else None,
            "gvar": gv if cot == "gvar" else None}
    dx_j, dgamma_j, dbeta_j = jbn._lean_bwd(
        1e-5, True, groups, None, None, None,
        (_jnp(x), jnp.asarray(gamma.numpy()), jnp.asarray(beta.numpy()),
         jnp.asarray(full(mean).numpy()), jnp.asarray(full(rstd).numpy())),
        (_jnp(gy), *(jnp.asarray(np.zeros(stat, np.float32) if t is None
                                 else t.numpy()) for t in cots.values())))
    if groups == 1:  # the sums _lean_bwd took
        dbeta = torch.from_numpy(np.asarray(dbeta_j))
        dgamma = torch.from_numpy(np.asarray(dgamma_j))
    else:
        dbeta, dgamma = tbn.batch_norm_grad_stats_ref(
            gy, x, mean, rstd, groups, gamma, beta, "lean")
    dx = tbn.bn_dx_ref(gy, x, mean, rstd, gamma, beta, dbeta, dgamma,
                       M // groups, groups, True, "lean", **cots)
    assert dx.dtype == torch.bfloat16
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(dx_j, np.float32))


@pytest.mark.parametrize("groups", [2, 4, 8])
@pytest.mark.parametrize("C", [32, 80, 448])
def test_lean_terms_with_ghost_groups_match_jax(C, groups):
    """The lean forward with ghost groups (K7's terms per group, then the
    normalize pass in lean mode) against lean_batch_norm_train's y, mean
    and var, float32, at the widths of Inception's launches."""
    M = 8 * 9
    rng = np.random.RandomState(40 + C + groups)
    x = rng.randn(M, C).astype(np.float32) * 2 + 0.5
    gamma = rng.rand(C).astype(np.float32) + 0.5
    beta = rng.randn(C).astype(np.float32)
    outs_j = jbn.lean_batch_norm_train(*map(jnp.asarray, (x, gamma, beta)),
                                       1e-5, True, groups)
    xt = torch.from_numpy(x)
    mean, var, rstd, a, b = tbn.batch_norm_stats_terms_ref(
        xt, torch.from_numpy(gamma), torch.from_numpy(beta), 1e-5, groups)
    assert mean.shape == (groups, C)
    y = tbn.bn_apply_ref(xt, a, b, groups, True, "lean")
    for name, got, want in zip(("y", "mean", "var"), (y, mean, var),
                               outs_j):
        assert _rel(got.numpy(), want) <= F32_TOL, (name, _rel(got.numpy(),
                                                               want))
    ours = tbn.lean_batch_norm_train(xt, torch.from_numpy(gamma),
                                     torch.from_numpy(beta), 1e-5, True,
                                     groups)
    for got, want in zip(ours, (y, mean, var)):
        assert torch.equal(got, want)
