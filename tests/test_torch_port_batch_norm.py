"""The port's BatchNorm (K7 and K8 plain versions, the training-mode
autograd function, the module, sync BN) against the JAX package's, on the
CPU. The Pallas kernels run in interpret mode, as tests/test_batch_norm.py
runs them; inputs are made with numpy from a seed and handed to both."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu_torch as hvd
from horovod_tpu.ops import batch_norm as jbn
from horovod_tpu_torch.ops import batch_norm as tbn

import torch_port_bn_worker as worker

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

# f32 sums of a few hundred terms in another order.
SUM_RTOL, SUM_ATOL = 1e-5, 1e-4
# The normalize and dx passes: f32 elementwise math in another order.
BN_TOL = 2e-5


def _inputs(M, C, seed, x_bf16=False, dy_bf16=False):
    """x, dy as (torch, numpy f32 of the same values); bf16 inputs are
    rounded once in torch, so both packages read the same numbers."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(M, C).astype(np.float32) * 2.0 + 0.5)
    dy = torch.from_numpy(rng.randn(M, C).astype(np.float32))
    if x_bf16:
        x = x.to(torch.bfloat16)
    if dy_bf16:
        dy = dy.to(torch.bfloat16)
    return x, dy


def _jnp(t):
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


@pytest.mark.parametrize("M,C,x_bf16", [
    (512, 64, False),    # lane-packed on the TPU (4 rows a 128-lane row)
    (256, 256, False),   # wide
    (1024, 64, True),    # bf16 read, f32 accumulation
    (392, 96, True),     # 8 * 49 rows, 64 < C < 128: not packed
])
def test_stats_plain_version_matches_jax(M, C, x_bf16):
    x, _ = _inputs(M, C, 0, x_bf16)
    s_j, ss_j = jbn.batch_norm_stats(_jnp(x), interpret=True)
    s, ss = tbn.batch_norm_stats(x)
    assert s.dtype == ss.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=SUM_RTOL,
                               atol=SUM_ATOL)
    np.testing.assert_allclose(ss.numpy(), np.asarray(ss_j), rtol=SUM_RTOL,
                               atol=SUM_ATOL)


@pytest.mark.parametrize("M,C,x_bf16,dy_bf16", [
    (512, 64, False, False),
    (256, 256, False, False),
    (1024, 64, True, True),
    (512, 128, True, False),     # f32 dy with bf16 x
])
def test_grad_stats_plain_version_matches_jax(M, C, x_bf16, dy_bf16):
    x, dy = _inputs(M, C, 1, x_bf16, dy_bf16)
    xf = x.float()
    mean = xf.mean(0)
    rstd = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
    db_j, dg_j = jbn.batch_norm_grad_stats(
        _jnp(dy), _jnp(x), jnp.asarray(mean.numpy()),
        jnp.asarray(rstd.numpy()), interpret=True)
    db, dg = tbn.batch_norm_grad_stats(dy, x, mean, rstd)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), rtol=SUM_RTOL,
                               atol=SUM_ATOL)
    np.testing.assert_allclose(dg.numpy(), np.asarray(dg_j), rtol=SUM_RTOL,
                               atol=SUM_ATOL)


@pytest.mark.parametrize("M,C", [(512, 128), (392, 64)])
def test_fused_batch_norm_train_forward_and_vjp_match_jax(M, C):
    """(y, mean, var) and the VJP (dx, dgamma, dbeta) under nonzero
    cotangents of y, mean and var, against the JAX custom_vjp."""
    rng = np.random.RandomState(3)
    x = rng.randn(M, C).astype(np.float32) * 2.0 + 0.5
    gamma = rng.rand(C).astype(np.float32) + 0.5
    beta = rng.randn(C).astype(np.float32)
    gy = rng.randn(M, C).astype(np.float32)
    gm = rng.randn(C).astype(np.float32)
    gv = rng.randn(C).astype(np.float32)

    def f(x, gamma, beta):
        return jbn.fused_batch_norm_train(x, gamma, beta, 1e-5, True)

    outs_j, vjp = jax.vjp(f, *map(jnp.asarray, (x, gamma, beta)))
    grads_j = vjp(tuple(map(jnp.asarray, (gy, gm, gv))))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    outs = tbn.fused_batch_norm_train(*leaves, 1e-5)
    grads = torch.autograd.grad(outs, leaves, [torch.from_numpy(a)
                                               for a in (gy, gm, gv)])
    for name, a, b in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"),
                          list(outs) + list(grads),
                          list(outs_j) + list(grads_j)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=BN_TOL, atol=BN_TOL, err_msg=name)


def test_fused_batch_norm_module_matches_pallas_batch_norm():
    """Two training steps update the running statistics as flax does
    (ra = 0.9 ra + 0.1 batch, biased variance), then eval mode uses
    them; against PallasBatchNorm(interpret=True). The port's module takes
    [N, C, H, W] channels_last; the flax one [N, H, W, C]."""
    rng = np.random.RandomState(4)
    xs = [rng.randn(4, 8, 8, 32).astype(np.float32) * 1.5 + 0.3
          for _ in range(2)]
    ours = jbn.PallasBatchNorm(use_running_average=False, momentum=0.9,
                               epsilon=1e-5, interpret=True)
    variables = ours.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    scale = rng.rand(32).astype(np.float32) + 0.5
    bias = rng.randn(32).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}

    bn = tbn.FusedBatchNorm(32, eps=1e-5, momentum=0.9, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    for x in xs:
        y_j, upd = ours.apply(variables, jnp.asarray(x),
                              mutable=["batch_stats"])
        variables = {"params": variables["params"], **upd}
        y = bn(nchw(x))
        assert y.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(y_j), rtol=BN_TOL, atol=BN_TOL)
        for ours_k, flax_k in (("running_mean", "mean"),
                               ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(bn, ours_k).numpy(),
                np.asarray(variables["batch_stats"][flax_k]), rtol=1e-6,
                atol=1e-6, err_msg=ours_k)

    ours_e = jbn.PallasBatchNorm(use_running_average=True, epsilon=1e-5)
    bn.eval()
    before = tbn.launch_counts()
    y_e = bn(nchw(xs[0]))
    assert tbn.launch_counts() == before
    np.testing.assert_allclose(
        y_e.detach().permute(0, 2, 3, 1).numpy(),
        np.asarray(ours_e.apply(variables, jnp.asarray(xs[0]))), rtol=BN_TOL,
        atol=BN_TOL)


def test_module_refuses_what_it_does_not_take():
    """NCHW activations and a virtual batch that does not divide the
    batch; ghost BN, and sync BN on the stock path, construct and run."""
    bn = tbn.FusedBatchNorm(4, device="cpu")
    with pytest.raises(ValueError, match="channels-last"):
        bn(torch.zeros(2, 4, 3, 3))  # contiguous NCHW, not channels_last
    x = torch.randn(4, 4, 3, 3).to(memory_format=torch.channels_last)
    ghost = tbn.FusedBatchNorm(4, virtual_batch_size=2, device="cpu")
    assert ghost(x).shape == x.shape
    with pytest.raises(ValueError, match="does not divide"):
        tbn.FusedBatchNorm(4, virtual_batch_size=3, device="cpu")(x)
    hvd.init(device="cpu")
    try:
        stock = tbn.StockBatchNorm(4, group=hvd.WORLD, device="cpu")
        torch.testing.assert_close(
            stock(x), tbn.StockBatchNorm(4, device="cpu")(x), rtol=1e-5,
            atol=1e-5)
    finally:
        hvd.shutdown()


def test_sync_bn_on_two_gloo_ranks_equals_global_batch_bn(tmp_path):
    """Each of 2 ranks holds half the rows; with group= the statistics,
    y and dx equal BN over the whole batch, and the ranks' local dgamma
    and dbeta sum to the global ones (the gradient allreduce's job)."""
    outs = worker.spawn(worker.run_bn, tmp_path)
    x, gamma, beta, gy = worker.bn_inputs()
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    y, mean, var = tbn.fused_batch_norm_train(*leaves, 1e-5)
    dx, dgamma, dbeta = torch.autograd.grad(y, leaves, gy)
    tol = dict(rtol=1e-5, atol=1e-5)
    for out in outs:
        torch.testing.assert_close(out["mean"], mean, **tol)
        torch.testing.assert_close(out["var"], var, **tol)
    torch.testing.assert_close(torch.cat([o["y"] for o in outs]),
                               y.detach(), **tol)
    torch.testing.assert_close(torch.cat([o["dx"] for o in outs]), dx,
                               **tol)
    torch.testing.assert_close(sum(o["dgamma"] for o in outs), dgamma, **tol)
    torch.testing.assert_close(sum(o["dbeta"] for o in outs), dbeta, **tol)


def _bwd_inputs(M, C, seed):
    """x, dy, gmean, gvar f32 and x's mean and rstd, gamma, from a seed."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(M, C).astype(np.float32) * 2.0 + 0.5)
    dy = torch.from_numpy(rng.randn(M, C).astype(np.float32))
    gamma = torch.from_numpy(rng.rand(C).astype(np.float32) + 0.5)
    gm = torch.from_numpy(rng.randn(C).astype(np.float32))
    gv = torch.from_numpy(rng.randn(C).astype(np.float32))
    var, mean = torch.var_mean(x, 0, correction=0)
    return x, dy, gamma, mean, torch.rsqrt(var + 1e-5), gm, gv


@pytest.mark.parametrize("cot", ["none", "gmean", "gvar", "both"])
@pytest.mark.parametrize("M,C", [(301, 32), (257, 48), (129, 80),
                                 (77, 192), (33, 448)])
def test_dx_plain_version_with_its_reciprocal_matches_jax(M, C, cot):
    """bn_dx_ref (each division by the row count a product with the f32
    reciprocal the kernel is handed) against _bn_train_bwd at the widths
    of Inception's launches and odd M, with each of the mean and var
    cotangents alone, both, or neither (zeros on the JAX side)."""
    x, dy, gamma, mean, rstd, gm, gv = _bwd_inputs(M, C, 20 + C)
    gmean = gm if cot in ("gmean", "both") else None
    gvar = gv if cot in ("gvar", "both") else None
    zeros = torch.zeros(C)
    dx_j, dgamma_j, dbeta_j = jbn._bn_train_bwd(
        1e-5, True, None, tuple(jnp.asarray(t.numpy())
                                for t in (x, gamma, mean, rstd)),
        tuple(jnp.asarray(t.numpy()) for t in (
            dy, zeros if gmean is None else gmean,
            zeros if gvar is None else gvar)))
    dbeta, dgamma = tbn.batch_norm_grad_stats_ref(dy, x, mean, rstd)
    dx = tbn.bn_dx_ref(dy, x, mean, rstd, gamma, None, dbeta, dgamma, M,
                       gmean=gmean, gvar=gvar)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), rtol=BN_TOL,
                               atol=BN_TOL)
    inv, two = tbn.count_scales(M)
    assert np.float32(inv) == np.float32(1) / np.float32(M)
    assert np.float32(two) == np.float32(2.0 / M)


@pytest.mark.parametrize("mode", tbn.MODES)
def test_pass_plain_versions_take_shared_terms_with_ghost_groups(mode):
    """With ghost groups a (C,) term is every group's: the plain passes
    give what they give on the same term repeated to (G, C)."""
    M, C, G = 96, 24, 4
    x, dy, gamma, _, _, gm, gv = _bwd_inputs(M, C, 5)
    x = x.to(torch.bfloat16)
    var, mean = torch.var_mean(x.float(), 0, correction=0)
    rstd = torch.rsqrt(var + 1e-5)
    beta = gm.clone()
    db, dg = tbn.batch_norm_grad_stats_ref(dy, x, mean, rstd, G)

    def rep(t):
        return t.expand(G, C).contiguous()
    a, b = gamma * rstd, beta - mean * gamma * rstd
    for relu in (False, True):
        assert torch.equal(tbn.bn_apply_ref(x, a, b, G, relu, mode),
                           tbn.bn_apply_ref(x, rep(a), rep(b), G, relu, mode))
        shared = tbn.bn_dx_ref(dy, x, mean, rstd, gamma, beta, db, dg, M // G,
                               G, relu, mode, gm, gv)
        full = tbn.bn_dx_ref(dy, x, rep(mean), rep(rstd), gamma, beta, db,
                             dg, M // G, G, relu, mode, rep(gm), rep(gv))
        assert torch.equal(shared, full)


# Inception's launches (chip_smoke.INCEPTION_BN_LAUNCHES) at batch 128 and
# the ResNet-50 stem, plain and in 8 ghost groups: (Mg, C, groups)
_PLAN_SHAPES = sorted({(128 * hw, C, 1) for hw, C in
                       chip_smoke.INCEPTION_BN_LAUNCHES}
                      | {(256 * 112 * 112, 64, 1), (32 * 112 * 112, 64, 8)})


@pytest.mark.parametrize("Mg,C,groups", _PLAN_SHAPES)
def test_pass_plan_fills_the_card_and_amortises_the_terms(Mg, C, groups,
                                                          monkeypatch):
    """The passes' split at each launch: at least one block for each of the
    132 SMs, at most _PASS_BLOCKS (plus one split's worth), a whole
    multiple of 132 with one split a group, every thread at least
    _PASS_ROWS rows unless the 132-block floor takes them, every row in
    one split; and the split is worked out from (M, C, G, vec) alone: the
    same with every query of the device refused."""
    tbn._pass_plan.cache_clear()

    def refuse(*args, **kwargs):
        raise AssertionError("the plan asked the device")
    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    splits = tbn._pass_plan(Mg, C, 8, groups)
    col_tiles, tx, ty = tbn._pass_shape(C, 8)
    per = col_tiles * groups
    blocks = splits * per
    assert tx * 8 >= min(C, tbn._PASS_TILE) and tx * ty <= 256
    assert 132 <= blocks <= max(tbn._PASS_BLOCKS, 132) + per
    rows_a_thread = Mg // splits // ty   # the shortest split's, floored
    assert rows_a_thread >= tbn._PASS_ROWS or blocks < 132 + per
    assert rows_a_thread >= 1
    assert per > 1 or blocks % 132 == 0
    # split_rows: split s takes [Mg * s / splits, Mg * (s + 1) / splits)
    ends = [Mg * s // splits for s in range(splits + 1)]
    assert ends[0] == 0 and ends[-1] == Mg
    assert all(b > a for a, b in zip(ends, ends[1:]))
    monkeypatch.undo()
    tbn._pass_plan.cache_clear()
    assert tbn._pass_plan(Mg, C, 8, groups) == splits


def test_inception_launch_table_counts_the_models_norms():
    """chip_smoke's INCEPTION_BN_LAUNCHES is the port's InceptionV3 at 299:
    94 FusedBatchNorm layers, by (H * W, C), counted with forward hooks."""
    from collections import Counter
    from horovod_tpu_torch.models import InceptionV3
    model = InceptionV3(norm="pallas", dtype=torch.float32,
                        device="cpu").eval()
    seen = Counter()
    for mod in model.modules():
        if isinstance(mod, tbn.FusedBatchNorm):
            mod.register_forward_hook(lambda m, args, out: seen.update(
                [(args[0].shape[2] * args[0].shape[3], args[0].shape[1])]))
    with torch.no_grad():
        model(torch.zeros(1, 3, 299, 299))
    assert dict(seen) == chip_smoke.INCEPTION_BN_LAUNCHES
    assert sum(seen.values()) == chip_smoke.INCEPTION_BN_LAYERS == 94


@pytest.mark.parametrize("M,C", [(301, 32), (257, 48), (129, 80), (77, 192),
                                 (33, 448)])
def test_stats_terms_plain_version_matches_jax(M, C):
    """batch_norm_stats_terms_ref (K7's sums and the forward's torch ops)
    against _bn_train_fwd at the widths of Inception's launches and odd M:
    mean and var, and y = x * a + b from its a and b."""
    rng = np.random.RandomState(30 + C)
    x = rng.randn(M, C).astype(np.float32) * 2.0 + 0.5
    gamma = rng.rand(C).astype(np.float32) + 0.5
    beta = rng.randn(C).astype(np.float32)
    (y_j, mean_j, var_j), _ = jbn._bn_train_fwd(
        *map(jnp.asarray, (x, gamma, beta)), 1e-3, True)
    xt = torch.from_numpy(x)
    mean, var, rstd, a, b = tbn.batch_norm_stats_terms_ref(
        xt, torch.from_numpy(gamma), torch.from_numpy(beta), 1e-3)
    for name, got, want in (("mean", mean, mean_j), ("var", var, var_j),
                            ("y", tbn.bn_apply_ref(xt, a, b), y_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=BN_TOL, atol=BN_TOL, err_msg=name)
    assert torch.equal(rstd, torch.rsqrt(var + 1e-3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 4])
def test_stats_terms_are_the_forward_sequence_bit_for_bit(groups, dtype):
    """The terms (plain version, and _batch_stats without a sync group)
    equal bit for bit the sequence the forwards ran on K7's sums before
    K7 formed them: s / count, clamp(ss / count - mean^2, 0), rsqrt(var +
    eps), gamma * rstd, beta - mean * a."""
    M, C = 96, 24
    x, _ = _inputs(M, C, 31, x_bf16=dtype == torch.bfloat16)
    rng = np.random.RandomState(32)
    gamma = torch.from_numpy(rng.rand(C).astype(np.float32) + 0.5)
    beta = torch.from_numpy(rng.randn(C).astype(np.float32))
    s, ss = tbn.batch_norm_stats(x, groups)
    count = M // groups
    mean = s / count
    var = torch.clamp(ss / count - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + 1e-5)
    a = gamma * rstd
    want = (mean, var, rstd, a, beta - mean * a)
    got = tbn.batch_norm_stats_terms(x, gamma, beta, 1e-5, groups)
    stats = tbn._batch_stats(x, gamma, beta, 1e-5, groups, None)
    assert stats[5] == count
    for name, g1, g2, w in zip(("mean", "var", "rstd", "a", "b"), got,
                               stats, want):
        assert torch.equal(g1, w) and torch.equal(g2, w), name


@pytest.mark.parametrize("Mg,C,groups", _PLAN_SHAPES)
def test_stats_plan_fills_the_card_and_bounds_the_last_block(
        Mg, C, groups, monkeypatch):
    """K7's and K8's split at each launch: tiles that cover C with at most
    128 channels each (one tile up to _STATS_ONE_TILE); one block for each
    of the 132 SMs where the rows allow it, fewer by what the splits of
    every tile and group leave over, never two on an SM in the first 132,
    a whole multiple of 132 with one tile and one group; at most
    _STATS_BLOCKS blocks (one
    wave at two an SM) unless a group's one split takes more, so the last
    block reads at most _STATS_BLOCKS * 2 * 128 partial sums; every
    thread at least _STATS_ROWS[kernel] rows unless the 132-block floor or
    the blocks' ceiling takes them; every row in one split; and the plan is worked out from (M, C,
    G, vec) alone: the same with every query of the device refused."""
    tbn._stats_plan.cache_clear()

    def refuse(*args, **kwargs):
        raise AssertionError("the plan asked the device")
    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    plans = {(vec, k): tbn._stats_plan(Mg, C, vec, groups, k)
             for vec in (8, 1) for k in ("K7", "K8")}
    for (vec, kernel), (tx, tiles, splits, stride) in plans.items():
        ty = 256 // tx
        width = tx * vec
        assert width <= 128 and tiles * width >= C > (tiles - 1) * width
        assert tiles == 1 or C > tbn._STATS_ONE_TILE
        assert stride % 4 == 0 and 2 * width <= stride < 2 * width + 4
        per = tiles * groups
        blocks = splits * per
        assert 1 <= splits and (blocks <= tbn._STATS_BLOCKS or splits == 1)
        assert blocks > 132 - per or splits == Mg // ty
        assert blocks <= 132 or blocks >= 264 - per
        assert per > 1 or blocks % 132 == 0 or splits == Mg // ty
        rows_a_thread = Mg // splits // ty   # the shortest split's, floored
        assert (rows_a_thread >= tbn._STATS_ROWS[kernel]
                or blocks <= 132 or blocks > tbn._STATS_BLOCKS - per)
        assert rows_a_thread >= 1
        # split_rows: split s takes [Mg * s / splits, Mg * (s + 1) / splits)
        ends = [Mg * s // splits for s in range(splits + 1)]
        assert ends[0] == 0 and ends[-1] == Mg
        assert all(b > a for a, b in zip(ends, ends[1:]))
    monkeypatch.undo()
    tbn._stats_plan.cache_clear()
    assert all(tbn._stats_plan(Mg, C, vec, groups, k) == plan
               for (vec, k), plan in plans.items())
