"""The port's data-parallel train step against the JAX package's, and its
gradient averaging over 2 gloo ranks, on the CPU."""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

import horovod_tpu_torch as hvd
from horovod_tpu import models as jax_models
from horovod_tpu.parallel import data_parallel_mesh
from horovod_tpu.parallel import make_train_step as jax_make_train_step
from horovod_tpu_torch.convert import transformer_state_dict_from_jax
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.parallel import (cross_entropy_loss, lm_loss,
                                        make_train_step)

SMALL = dict(vocab_size=96, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=128, attention="flash")


@pytest.fixture
def one_rank():
    """A one-rank gloo group for the port (no launcher env)."""
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_three_adam_steps_match_jax(one_rank):
    import optax
    tokens = np.random.RandomState(0).randint(
        0, SMALL["vocab_size"], (4, 32)).astype(np.int32)
    jcfg = jax_models.TransformerConfig(dtype=jnp.float32, **SMALL)
    jmodel = jax_models.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(tokens[:1]))["params"]
    params_np = jax.tree_util.tree_map(np.asarray, params)

    def loss_fn(params, batch):
        logits = jmodel.apply({"params": params}, batch["x"])
        tgt = jnp.roll(batch["x"], -1, axis=1)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], axis=-1))

    with jax.default_matmul_precision("highest"):
        opt = optax.adam(1e-3)
        mesh = data_parallel_mesh(devices=jax.devices("cpu")[:1])
        jstep = jax_make_train_step(loss_fn, opt, mesh, donate=False)
        p, s, b = jstep.place(params, opt.init(params),
                              {"x": jnp.asarray(tokens)})
        losses_j = []
        for _ in range(3):
            p, s, loss = jstep(p, s, b)
            losses_j.append(float(loss))
        final_j = jax.tree_util.tree_map(np.asarray, p)

    cfg = TransformerConfig(dtype=torch.float32, **SMALL)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(transformer_state_dict_from_jax(params_np, cfg))
    step = make_train_step(model, lm_loss,
                           torch.optim.Adam(model.parameters(), lr=1e-3),
                           device="cpu")
    x = torch.from_numpy(tokens).long()
    losses = [step(x).item() for _ in range(3)]

    # f32 on both sides: the losses agree to rounding.
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    assert losses[-1] < losses[0]
    # Adam moves each weight by about lr per step whatever the gradient's
    # size, so the params agree to a small fraction of lr = 1e-3.
    expected = transformer_state_dict_from_jax(final_j, cfg)
    for name, t in model.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(),
                                   expected[name].numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)


def test_accumulation_matches_one_pass(one_rank):
    """accum_steps=2 takes the mean of the two microbatch gradients: the
    same update as one pass over the shard (mean loss, SGD)."""
    cfg = TransformerConfig(dtype=torch.float32, **SMALL)
    x = torch.randint(0, SMALL["vocab_size"], (4, 16),
                      generator=torch.Generator().manual_seed(2))
    results = []
    for accum in (1, 2):
        model = Transformer(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        step = make_train_step(model, lm_loss,
                               torch.optim.SGD(model.parameters(), lr=0.5),
                               accum_steps=accum, device="cpu")
        loss = step(x).item()
        results.append((loss, [p.detach().clone()
                               for p in model.parameters()]))
    (l1, p1), (l2, p2) = results
    assert abs(l1 - l2) <= 1e-6 * abs(l1)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="accum_steps=3"):
        make_train_step(model, lm_loss, torch.optim.SGD(
            model.parameters(), lr=0.5), accum_steps=3, device="cpu")(x)


@pytest.mark.parametrize("kind", ["dict", "tuple"])
def test_pytree_batches_split_every_leaf(one_rank, kind):
    """A dict or tuple batch, as the JAX step takes a pytree: every leaf is
    moved, split along dim 0 for accum_steps, and checked to divide."""
    seen = []

    def loss_fn(model, batch):
        x, y = (batch["x"], batch["y"]) if kind == "dict" else batch
        seen.append((x.shape[0], y.shape[0]))
        return cross_entropy_loss(model(x), y)

    g = torch.Generator().manual_seed(3)
    x, y = torch.randn(6, 4, generator=g), torch.randint(0, 3, (6,),
                                                         generator=g)
    results = []
    for accum in (1, 2):
        model = torch.nn.Linear(4, 3)
        with torch.no_grad():
            model.weight.copy_(torch.arange(12.0).view(3, 4) / 10)
            model.bias.zero_()
        step = make_train_step(model, loss_fn,
                               torch.optim.SGD(model.parameters(), lr=0.5),
                               accum_steps=accum, device="cpu")
        batch = {"x": x, "y": y} if kind == "dict" else (x, y)
        results.append((step(batch).item(), model.weight.detach().clone()))
    assert seen == [(6, 6), (3, 3), (3, 3)]
    assert abs(results[0][0] - results[1][0]) <= 1e-6
    torch.testing.assert_close(results[0][1], results[1][1])
    bad = {"x": x, "y": y[:5]} if kind == "dict" else (x, y[:5])
    with pytest.raises(ValueError, match="5 rows"):
        step(bad)


def test_cross_entropy_loss_matches_jax():
    from horovod_tpu.parallel.train import cross_entropy_loss as jax_xent
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 10).astype(np.float32)
    labels = rng.randint(0, 10, 6).astype(np.int32)
    ref = float(jax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    out = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels).long()).item()
    assert abs(out - ref) <= 1e-6 * abs(ref)


@pytest.mark.parametrize("B,L,chunk", [(2, 192, 64), (1, 96, 96)])
def test_chunked_softmax_cross_entropy_matches_jax(B, L, chunk):
    """The streaming loss (ops/losses.py) and its gradients with respect to
    the hidden states and the lm-head weight against the JAX function; the
    port's weight is [V, E], the JAX kernel its transpose."""
    from horovod_tpu.ops.losses import chunked_softmax_cross_entropy as jx
    from horovod_tpu_torch.ops import chunked_softmax_cross_entropy
    rng = np.random.RandomState(5)
    E, V = 24, 50
    hidden = rng.randn(B, L, E).astype(np.float32)
    weight = (rng.randn(V, E) / 5).astype(np.float32)
    targets = rng.randint(0, V, (B, L)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.value_and_grad(
            lambda h, w: jx(h, w, jnp.asarray(targets), chunk=chunk),
            argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(weight.T))
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(weight).requires_grad_()
    loss = chunked_softmax_cross_entropy(
        h, w, torch.from_numpy(targets).long(), chunk=chunk)
    loss.backward()
    # the same f32 sums in another order
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-6)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(grads_j[0]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(grads_j[1]).T,
                               rtol=1e-5, atol=1e-7)
    # and the dense loss over the full logits
    dense = cross_entropy_loss(h @ w.t(), torch.from_numpy(targets).long())
    np.testing.assert_allclose(loss.item(), dense.item(), rtol=1e-6)


def test_chunked_softmax_cross_entropy_needs_chunks_that_divide_l():
    from horovod_tpu.ops.losses import chunked_softmax_cross_entropy as jx
    from horovod_tpu_torch.ops import chunked_softmax_cross_entropy
    h, t = np.zeros((1, 100, 8), np.float32), np.zeros((1, 100), np.int32)
    with pytest.raises(ValueError, match="not divisible") as port:
        chunked_softmax_cross_entropy(torch.from_numpy(h), torch.zeros(5, 8),
                                      torch.from_numpy(t).long(), chunk=64)
    with pytest.raises(ValueError, match="not divisible") as ref:
        jx(jnp.asarray(h), jnp.zeros((8, 5)), jnp.asarray(t), chunk=64)
    assert str(port.value) == str(ref.value)


def test_two_gloo_ranks_average_to_the_full_batch_gradient(tmp_path):
    """Each of 2 ranks takes half the batch; after DistributedOptimizer
    their gradients equal the single-process full-batch gradient."""
    import torch_port_dp_worker as worker
    size = 2
    ranks = mp.start_processes(
        worker.run, args=(size, str(tmp_path / "store"), str(tmp_path)),
        nprocs=size, start_method="spawn", join=False)
    deadline = time.monotonic() + 180
    while not ranks.join(timeout=5):  # raises if a rank failed
        if time.monotonic() > deadline:
            for proc in ranks.processes:
                proc.kill()
            pytest.fail("the gloo ranks did not finish in 180 s")
    outs = [torch.load(str(tmp_path / ("rank%d.pt" % r)))
            for r in range(size)]

    model, tokens = worker.model_and_batch()
    full = lm_loss(model, tokens)
    full.backward()
    for name, p in model.named_parameters():
        for r, out in enumerate(outs):
            g = out["grads"][name]
            err = (g - p.grad).abs().max() / p.grad.abs().max()
            assert err <= 1e-5, (name, r, float(err))
        torch.testing.assert_close(outs[0]["params"][name],
                                   outs[1]["params"][name], rtol=0, atol=0)
    assert torch.equal(outs[0]["exp_avg"], outs[1]["exp_avg"])
    for out in outs:
        assert abs(out["loss_avg"].item() - full.item()) <= 1e-5
        assert out["summed"].item() == 3.0
        assert out["gathered"].shape == (3, 3)
        assert out["gathered"].tolist() == [[0.0] * 3, [1.0] * 3, [1.0] * 3]
        assert out["bcast"].item() == 6.0

