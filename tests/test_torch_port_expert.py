"""The port's expert parallelism against the JAX package's, on the CPU.

Counterparts of tests/test_expert.py:

- in this process: Switch and top-2 routing (``switch_dispatch``,
  ``topk_dispatch``) against JAX's dispatch, combine and aux loss, with
  ties and drops; ``moe_ffn`` against JAX's and against the per-token
  computation; ``MoeMlp`` with flax weights; ``moe_capacity``;
  ``ep_param_specs``;
- on 4 gloo ranks (tests/torch_port_parallel_worker.py, spawned once for
  the module) against JAX under ``shard_map`` on 4 virtual CPU devices, a
  (dp=2, ep=2) mesh: ``moe_ffn`` with ``ep_axis`` (top-1 and top-2), its
  raw per-rank gradients (the all-to-all's transpose) and
  ``ep_grad_sync``'s, the dp x ep MoE LM step (xent + 0.01 * aux,
  ``ep_grad_sync(average=True)``, one SGD step); and on an (ep=2, sp=2)
  mesh the MoE LM with ring and with Ulysses attention against the
  unsharded flax model.

Inputs come from numpy; both sides run in float32, JAX at its highest
matmul precision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_port_parallel_worker as worker
from horovod_tpu import models as jax_models
from horovod_tpu.parallel import expert as jexp
from horovod_tpu_torch.convert import (shard_state_dict,
                                       transformer_state_dict_from_jax)
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.parallel import (MoeMlp, ep_param_specs,
                                        moe_aux_loss, moe_ffn,
                                        switch_dispatch)
from horovod_tpu_torch.parallel.expert import moe_capacity, topk_dispatch

jax.config.update("jax_default_matmul_precision", "highest")

# tests/test_expert.py's tolerance for values and gradients: the same f32
# arithmetic in another order
TOL = 2e-4
# its ep gradient check's
GRAD_TOL = 3e-4
# routing: the same f32 softmax, rounded apart
ROUTE_TOL = 1e-6


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices("cpu")[:n]).reshape(shape), names)


def _layer(seed, T, D, F, E, router_scale=0.3):
    rng = np.random.RandomState(seed)
    return (rng.randn(T, D).astype(np.float32),
            rng.randn(D, E).astype(np.float32) * router_scale,
            rng.randn(E, D, F).astype(np.float32) * 0.2,
            rng.randn(E, F, D).astype(np.float32) * 0.2)


# the rank cases of one MoE layer: (seed, T, D, F, E, capacity factor,
# top_k, router scale), tests/test_expert.py's shapes (E = 4 for ep = 2)
LAYER_CASES = {"ep1": (1, 32, 16, 24, 4, 4.0, 1, 0.3),
               "ep2": (6, 32, 8, 12, 4, 8.0, 2, 0.4),
               "epgrad": (2, 32, 8, 12, 4, 4.0, 1, 0.3)}


def _layer_case(name):
    seed, T, D, F, E, cf, top_k, scale = LAYER_CASES[name]
    x, router, w_in, w_out = _layer(seed, T, D, F, E, scale)
    return dict(x=_t(x), router=_t(router), w_in=_t(w_in), w_out=_t(w_out),
                cf=cf, top_k=top_k)


def _dispatch_agrees(logits, capacity, k):
    d_j, c_j, a_j = jexp.topk_dispatch(jnp.asarray(logits), capacity, k=k)
    d, c, a = topk_dispatch(_t(logits), capacity, k=k)
    assert np.array_equal(_np(d), np.asarray(d_j))
    np.testing.assert_allclose(_np(c), np.asarray(c_j), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    np.testing.assert_allclose(float(a), float(a_j), rtol=ROUTE_TOL)
    return _np(d), _np(c), float(a)


def test_switch_dispatch_routing_and_capacity():
    # tokens 0, 1, 3 -> expert 1 (token 3 dropped: capacity 2), 2 -> 0
    logits = np.asarray([[0.0, 2.0], [0.0, 3.0], [4.0, 0.0], [0.0, 1.0]],
                        np.float32)
    d, c, aux = _dispatch_agrees(logits, 2, 1)
    assert d[0, 1, 0] == 1 and d[1, 1, 1] == 1
    assert d[3].sum() == 0 and d[2, 0, 0] == 1
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    np.testing.assert_allclose(c[0, 1, 0], probs[0, 1], rtol=1e-6)
    assert aux > 0
    d1, _, _ = switch_dispatch(_t(logits), 2)
    assert torch.equal(d1, _t(d))


def test_ties_take_the_first_expert():
    """argmax breaks ties at the first index, as jnp.argmax: equal logits
    route to expert 0 (top-1) and expert 0 then 1 (top-2)."""
    logits = np.zeros((3, 4), np.float32)
    logits[1, 2:] = 1.0
    d, _, _ = _dispatch_agrees(logits, 4, 1)
    assert d[0, 0].sum() == 1 and d[1, 2].sum() == 1
    d, _, _ = _dispatch_agrees(logits, 4, 2)
    assert d[0, 1].sum() == 1 and d[1, 3].sum() == 1


def test_top2_dispatch_routing():
    """Both choices get slots, the gates renormalize to 1, second choices
    queue after all first choices (GShard)."""
    logits = np.asarray([[3.0, 2.0, -5.0], [2.5, 3.5, -5.0]], np.float32)
    d, c, aux = _dispatch_agrees(logits, 4, 2)
    assert d[0, 0, 0] == 1 and d[1, 1, 0] == 1
    assert d[0, 1, 1] == 1 and d[1, 0, 1] == 1
    np.testing.assert_allclose(c[0].sum(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(c[1].sum(), 1.0, rtol=1e-6)
    assert aux > 0


@pytest.mark.parametrize("top_k", [1, 2])
def test_dispatch_with_drops_matches_jax(top_k):
    """64 tokens on 8 experts at capacity factor 1 (8 slots): many queues
    overflow; the drop set and every slot equal JAX's."""
    logits = np.random.RandomState(11).randn(64, 8).astype(np.float32) * 2
    d, _, _ = _dispatch_agrees(logits, 8, top_k)
    assert d.sum() < 64 * top_k  # some choices dropped


def _per_token(x, router, w_in, w_out, k):
    """Each token through its top-k experts, gate-weighted (renormalized
    for k > 1), in numpy float64."""
    x, router, w_in, w_out = (np.asarray(a, np.float64)
                              for a in (x, router, w_in, w_out))
    logits = x @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(x)
    for t in range(x.shape[0]):
        order = np.argsort(-probs[t], kind="stable")[:k]
        g = probs[t, order]
        if k > 1:
            g = g / g.sum()
        for e, gate in zip(order, g):
            h = x[t] @ w_in[e]
            out[t] += gate * ((h / (1 + np.exp(-h))) @ w_out[e])
    return out


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_per_token_expert_computation(top_k):
    """With capacity for every token, the einsums equal each token through
    its chosen experts, scaled by the gate; and JAX's moe_ffn."""
    T, D, F, E = (32, 16, 24, 4) if top_k == 1 else (16, 8, 12, 4)
    x, router, w_in, w_out = _layer(0 if top_k == 1 else 5, T, D, F, E,
                                    0.3 if top_k == 1 else 0.5)
    cf = float(E) * top_k
    y, aux = moe_ffn(_t(x), _t(router), _t(w_in), _t(w_out),
                     capacity_factor=cf, top_k=top_k)
    y_j, aux_j = jexp.moe_ffn(*(jnp.asarray(a) for a in (x, router, w_in,
                                                        w_out)),
                              capacity_factor=cf, top_k=top_k)
    np.testing.assert_allclose(_np(y), np.asarray(y_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=ROUTE_TOL)
    np.testing.assert_allclose(_np(y), _per_token(x, router, w_in, w_out,
                                                  top_k), rtol=TOL, atol=TOL)


def test_moe_mlp_module_and_param_specs():
    """MoeMlp with flax's MoeMlp weights (the identity a leaf): y and the
    aux loss; the default capacity factor 1.25 drops tokens on both sides
    alike. ep_param_specs shards only the expert weights."""
    model = jexp.MoeMlp(num_experts=4, mlp_dim=32, dtype=jnp.float32)
    x = np.random.RandomState(3).randn(2, 8, 16).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_j, state = model.apply(variables, jnp.asarray(x),
                             mutable=["intermediates"])
    aux_j = state["intermediates"]["moe_aux_loss"][0]
    port = MoeMlp(16, 4, 32, dtype=torch.float32, device="cpu")
    port.load_state_dict({k: _t(v) for k, v in
                          variables["params"].items()})
    y = port(_t(x))
    np.testing.assert_allclose(_np(y), np.asarray(y_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port.aux_loss.item(), float(aux_j),
                               rtol=ROUTE_TOL)
    assert port.aux_loss.item() > 0
    specs = ep_param_specs(port)
    assert specs == {"router": None, "w_in": 0, "w_out": 0}
    with pytest.raises(ValueError, match="must divide"):
        MoeMlp(16, 4, 32, ep_size=3, device="cpu")


def test_capacity_helper():
    assert moe_capacity(64, 8, 1.0) == 8
    assert moe_capacity(64, 8, 1.25) == 10
    assert moe_capacity(3, 8, 1.0) == 1
    # bench.py's MoE row: 8 x 2048 tokens on 8 experts
    assert moe_capacity(16384, 8, 1.25) == 2560


# ------------------------------------------------ the 4 gloo ranks


def _flax_lm(cfg_kwargs, tokens, seed):
    cfg = jax_models.TransformerConfig(dtype=jnp.float32, **cfg_kwargs)
    model = jax_models.Transformer(cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(tokens))[
        "params"]
    return cfg, model, params


def _state(params, cfg_kwargs):
    cfg = TransformerConfig(dtype=torch.float32, **cfg_kwargs)
    return transformer_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX side of every rank case, then the port's 4 ranks on the
    same inputs: (inputs, {case: JAX result}, [what each rank saved])."""
    inputs = {name: _layer_case(name) for name in LAYER_CASES}
    tokens = np.random.RandomState(7).randint(0, 64, (8, 16))
    _, _, params = _flax_lm(worker.MOE_LM, tokens[:1], 0)
    inputs["lm_dp_ep"] = dict(state=_state(params, worker.MOE_LM),
                              tokens=_t(tokens), params=params)
    for name, seed in (("sp_ep_ring", 17), ("sp_ep_ulysses", 23)):
        tokens = np.random.RandomState(seed - 4).randint(0, 97, (2, 32))
        _, _, params = _flax_lm(worker.MOE_SP, tokens, seed)
        inputs[name] = dict(state=_state(params, worker.MOE_SP),
                            tokens=_t(tokens), params=params)
    want = {name: fn(inputs[name]) for name, fn in (
        ("ep1", _jax_layer), ("ep2", _jax_layer), ("epgrad", _jax_grads),
        ("lm_dp_ep", _jax_lm_step), ("sp_ep_ring", _jax_full),
        ("sp_ep_ulysses", _jax_full))}
    sent = {name: {k: v for k, v in case.items() if k != "params"}
            for name, case in inputs.items()}
    got = worker.spawn(worker.run_expert, tmp_path_factory.mktemp("expert"),
                       sent)
    return inputs, want, got


def _jnp(case):
    return [jnp.asarray(case[k].numpy()) for k in ("x", "router", "w_in",
                                                    "w_out")]


def _jax_layer(case):
    """y [T, D] of moe_ffn under shard_map on (dp=2, ep=2), tokens over
    (dp, ep), experts over ep."""
    def f(x, router, w_in, w_out):
        return jexp.moe_ffn(x, router, w_in, w_out,
                            capacity_factor=case["cf"], ep_axis="ep",
                            top_k=case["top_k"])[0]

    return np.asarray(jax.jit(jax.shard_map(
        f, mesh=_mesh((2, 2), ("dp", "ep")),
        in_specs=(P(("dp", "ep")), P(), P("ep"), P("ep")),
        out_specs=P(("dp", "ep")), check_vma=False))(*_jnp(case)))


def _jax_grads(case):
    """Per rank (stacked over (dp, ep)): the raw gradients of the local
    sum(y^2) and ep_grad_sync's over dp."""
    def f(x, router, w_in, w_out):
        def loss(w_in, w_out, router, x):
            y, _ = jexp.moe_ffn(x, router, w_in, w_out,
                                capacity_factor=case["cf"], ep_axis="ep")
            return jnp.sum(y ** 2)

        g_in, g_out, g_r, g_x = jax.grad(loss, argnums=(0, 1, 2, 3))(
            w_in, w_out, router, x)
        raw = {"w_in": g_in, "w_out": g_out, "router": g_r}
        synced = jexp.ep_grad_sync(raw, ep_axis="ep", dp_axis="dp")
        stack = jax.tree_util.tree_map(lambda g: g[None], (raw, synced))
        return stack + (g_x,)

    spec = P(("dp", "ep"))
    raw, synced, gx = jax.jit(jax.shard_map(
        f, mesh=_mesh((2, 2), ("dp", "ep")),
        in_specs=(spec, P(), P("ep"), P("ep")),
        out_specs=(spec, spec, spec), check_vma=False))(*_jnp(case))
    return dict(raw=raw, synced=synced, x=np.asarray(gx))


def _jax_lm_step(case):
    """tests/test_expert.py::test_moe_transformer_train_step_dp_ep on a
    (2, 2) mesh: the loss, every rank's raw gradients and the new
    parameters after one SGD step on ep_grad_sync(average=True)'s."""
    import dataclasses
    import optax
    base = jax_models.TransformerConfig(dtype=jnp.float32, **worker.MOE_LM)
    model = jax_models.Transformer(dataclasses.replace(base, ep_axis="ep",
                                                       ep_size=2))
    params = case["params"]
    specs = jexp.ep_param_specs(params, "ep")
    opt = optax.sgd(worker.LR)
    mesh = _mesh((2, 2), ("dp", "ep"))

    def loss_fn(params, tokens):
        logits, state = model.apply({"params": params}, tokens,
                                    mutable=["intermediates"])
        logp = jax.nn.log_softmax(logits)
        tgt = jnp.roll(tokens, -1, axis=1)
        xent = -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], -1))
        aux = sum(jax.tree_util.tree_leaves(state["intermediates"]))
        return xent + 0.01 * aux

    def step(params, tokens):
        loss, grads = jax.value_and_grad(loss_fn)(params, tokens)
        synced = jexp.ep_grad_sync(grads, "ep", dp_axis="dp", average=True)
        updates, _ = opt.update(synced, opt.init(params), params)
        raw = jax.tree_util.tree_map(lambda g: g[None], grads)
        return optax.apply_updates(params, updates), raw, loss[None]

    placed = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
        specs)
    rank_spec = jax.tree_util.tree_map(lambda _: P(("dp", "ep")), params)
    new, raw, loss = jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(specs, P(("dp", "ep"))),
        out_specs=(specs, rank_spec, P(("dp", "ep"))),
        check_vma=False))(placed, jnp.asarray(case["tokens"].numpy()))
    return dict(new=new, raw=raw, loss=np.asarray(loss))


def _jax_full(case):
    """The unsharded flax MoE LM's logits (the reference's expectation)."""
    cfg = jax_models.TransformerConfig(dtype=jnp.float32, **worker.MOE_SP)
    return np.asarray(jax_models.Transformer(cfg).apply(
        {"params": case["params"]}, jnp.asarray(case["tokens"].numpy())))


@pytest.mark.parametrize("case", ["ep1", "ep2"])
def test_ep_sharded_matches_unsharded(ranks, case):
    """(dp=2 x ep=2), top-1 and top-2: each rank routes its own tokens,
    the experts' slots go through the all-to-all both ways; y equals JAX's
    under shard_map and the unsharded moe_ffn on each token shard."""
    inputs, want, got = ranks
    c = inputs[case]
    n = 32 // worker.WORLD
    for r, out in enumerate(got):
        y = _np(out[case]["y"])
        np.testing.assert_allclose(y, want[case][r * n:(r + 1) * n],
                                   rtol=TOL, atol=TOL)
        alone, _ = moe_ffn(c["x"][r * n:(r + 1) * n],
                           c["router"], c["w_in"], c["w_out"],
                           capacity_factor=c["cf"], top_k=c["top_k"])
        np.testing.assert_allclose(y, _np(alone), rtol=TOL, atol=TOL)


def test_ep_sharded_gradients_match(ranks):
    """The raw gradients of each rank's local loss equal JAX's (the expert
    weights' hold every ep peer's tokens: the all-to-all's transpose), and
    ep_grad_sync's too; the synced expert weights equal the unsharded
    gradient summed over the token shards."""
    inputs, want, got = ranks
    w = want["epgrad"]
    n = 32 // worker.WORLD
    for r, out in enumerate(got):
        g = out["epgrad"]
        for kind in ("raw", "synced"):
            for name in ("w_in", "w_out", "router"):
                np.testing.assert_allclose(
                    _np(g[kind][name]), np.asarray(w[kind][name][r]),
                    rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=kind + name)
        np.testing.assert_allclose(_np(g["x"]), w["x"][r * n:(r + 1) * n],
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    case = inputs["epgrad"]
    w_in, w_out = (case[k].clone().requires_grad_() for k in ("w_in",
                                                              "w_out"))
    total = sum(torch.sum(moe_ffn(x, case["router"], w_in, w_out,
                                  capacity_factor=4.0)[0] ** 2)
                for x in case["x"].chunk(worker.WORLD))
    total.backward()
    for r, out in enumerate(got):
        for name, p in (("w_in", w_in), ("w_out", w_out)):
            np.testing.assert_allclose(
                _np(out["epgrad"]["synced"][name]),
                _np(p.grad.chunk(2, 0)[r % 2]), rtol=GRAD_TOL,
                atol=GRAD_TOL)


def test_moe_transformer_train_step_dp_ep(ranks):
    """The dp x ep MoE LM step: every rank's loss and raw gradients, and
    the parameters after one SGD step, equal JAX's; the experts moved."""
    inputs, want, got = ranks
    w = want["lm_dp_ep"]
    cfg = TransformerConfig(dtype=torch.float32, **worker.MOE_LM)
    local = TransformerConfig(dtype=torch.float32, ep_size=2,
                              **worker.MOE_LM)
    new = transformer_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, w["new"]), cfg)
    for r, out in enumerate(got):
        res = out["lm_dp_ep"]
        np.testing.assert_allclose(float(res["loss"]), w["loss"][r],
                                   rtol=1e-5)
        raw = transformer_state_dict_from_jax(
            jax.tree_util.tree_map(lambda g: np.asarray(g[r]), w["raw"]),
            local)
        mine = shard_state_dict(new, ep_size=2, ep_rank=r % 2)
        assert set(res["raw"]) == set(raw) == set(res["new"])
        for name in raw:
            np.testing.assert_allclose(_np(res["raw"][name]),
                                       raw[name].numpy(), rtol=TOL,
                                       atol=TOL, err_msg=name)
            np.testing.assert_allclose(_np(res["new"][name]),
                                       mine[name].numpy(), rtol=TOL,
                                       atol=TOL, err_msg=name)
        before = shard_state_dict(inputs["lm_dp_ep"]["state"], ep_size=2,
                                  ep_rank=r % 2)
        name = "blocks.1.moe_mlp.w_in"
        assert (res["new"][name] - before[name]).abs().max() > 0


@pytest.mark.parametrize("case", ["sp_ep_ring", "sp_ep_ulysses"])
def test_moe_with_sequence_parallel_attention_sp_ep_mesh(ranks, case):
    """ep and sp on one (ep=2, sp=2) mesh: the batch over ep (the MoE
    all-to-all inside each sp group), the sequence over sp (ring attention,
    or Ulysses' own all-to-alls, inside each ep group); the logits equal
    the unsharded flax model's."""
    _, want, got = ranks
    for r, out in enumerate(got):
        e, s = r // 2, r % 2
        np.testing.assert_allclose(_np(out[case]),
                                   want[case][e:e + 1, s * 16:(s + 1) * 16],
                                   rtol=TOL, atol=TOL)


def test_moe_aux_loss_sums_the_blocks():
    """moe_aux_loss(model): the MoE blocks' aux losses in block order, the
    sum flax's intermediates give; before a forward it raises."""
    kw = dict(worker.MOE_LM, num_layers=4)
    tokens = np.random.RandomState(9).randint(0, 64, (2, 16))
    cfg_j, model_j, params = _flax_lm(kw, tokens, 4)
    _, state = model_j.apply({"params": params}, jnp.asarray(tokens),
                             mutable=["intermediates"])
    want = sum(float(a) for a in jax.tree_util.tree_leaves(
        state["intermediates"]))
    port = Transformer(TransformerConfig(dtype=torch.float32, **kw),
                       device="cpu")
    with pytest.raises(RuntimeError, match="forward"):
        moe_aux_loss(port)
    port.load_state_dict(_state(params, kw))
    port(_t(tokens))
    assert [i for i, b in enumerate(port.blocks) if b.moe] == [1, 3]
    np.testing.assert_allclose(float(moe_aux_loss(port)), want,
                               rtol=ROUTE_TOL)
