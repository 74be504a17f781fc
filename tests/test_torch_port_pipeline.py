"""The port's pipeline parallelism against the JAX package's, on the CPU.

Counterparts of tests/test_pipeline.py: the GPipe schedule over 2 stages of
2 transformer blocks each (the flax weights through ``convert``, stacked by
``stack_block_params``), 2 microbatches, the embedding before and the norm
and head after the pipeline on every rank. On 4 gloo ranks
(tests/torch_port_parallel_worker.py, spawned once for the module) laid out
as (dp=2, pp=2), against JAX under ``shard_map`` on 2 or 4 virtual CPU
devices:

- the logits against the full model's (each dp row the whole batch), and
  with the batch over dp;
- the in-process gradient contract: a local loss scaled by 1 / pp; every
  rank's raw gradients (staged and outside) against JAX's raw per-shard
  gradients, the staged ones against the full model's, and the outside
  ones summed over pp against the full model's;
- ``remat=True`` against ``remat=False`` and against JAX's.

Both sides run in float32, JAX at its highest matmul precision.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_port_parallel_worker as worker
from horovod_tpu import models as jax_models
from horovod_tpu.models.transformer import Block as JaxBlock
from horovod_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from horovod_tpu.parallel.pipeline import (
    stack_block_params as jax_stack)
from horovod_tpu_torch.convert import (block_state_dict_from_jax,
                                       transformer_state_dict_from_jax)
from horovod_tpu_torch.models import TransformerConfig
from horovod_tpu_torch.parallel import stack_block_params

jax.config.update("jax_default_matmul_precision", "highest")

# tests/test_pipeline.py's tolerances: forward 2e-5, gradients 5e-5
FWD_TOL = 2e-5
GRAD_TOL = 5e-5
# The remat check's loss is sum(y^2) of unnormalized blocks: its gradients
# reach 1e2, so against JAX (another implementation, not the same one with
# and without remat) GRAD_TOL applies relative to the largest element.

PP, MB, B, L = worker.PP, worker.MB, worker.PIPE_B, worker.PIPE_L
PER = worker.PIPE["num_layers"] // PP
CFG = jax_models.TransformerConfig(dtype=jnp.float32, **worker.PIPE)
PORT_CFG = TransformerConfig(dtype=torch.float32, **worker.PIPE)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _setup():
    model = jax_models.Transformer(CFG)
    tokens = jnp.asarray(np.random.RandomState(0).randint(
        0, CFG.vocab_size, (B, L)))
    params = model.init(jax.random.PRNGKey(3), tokens)["params"]
    return model, params, tokens


def _staged(params, mesh):
    stacked = jax_stack(params, CFG.num_layers)
    staged = jax.tree_util.tree_map(
        lambda x: x.reshape((PP, PER) + x.shape[1:]), stacked)
    specs = jax.tree_util.tree_map(lambda _: P("pp"), staged)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), staged,
        specs), specs


def _jax_contract(params, tokens):
    """tests/test_pipeline.py::test_pipeline_inprocess_grad_sync_contract
    on 2 devices: each rank's raw gradients (staged, and embed, norm_f,
    lm_head before their psum), stacked over pp."""
    mesh = Mesh(np.array(jax.devices("cpu")[:PP]), ("pp",))
    staged, specs = _staged(params, mesh)
    block = JaxBlock(CFG)
    positions = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None],
                                 (B // MB, L))

    def stage_fn(stage_params, x):
        def layer(x, p):
            return block.apply({"params": p}, x, positions), None
        return lax.scan(layer, x, stage_params)[0]

    def grads_fn(staged_local, embed_p, norm_p, head_p, tokens):
        def local_loss(staged_local, embed_p, norm_p, head_p):
            local = jax.tree_util.tree_map(lambda x: x[0], staged_local)
            emb = nn.Embed(CFG.vocab_size, CFG.embed_dim,
                           param_dtype=jnp.float32, dtype=CFG.dtype)
            x = emb.apply({"params": embed_p}, tokens)
            y = jax_pipeline(stage_fn, local,
                             x.reshape((MB, B // MB) + x.shape[1:]), "pp")
            y = nn.RMSNorm(dtype=CFG.dtype, param_dtype=jnp.float32).apply(
                {"params": norm_p}, y.reshape((B,) + y.shape[2:]))
            logits = (y @ head_p["kernel"]).astype(jnp.float32)
            return jnp.mean(logits ** 2) / lax.psum(1, "pp")

        g = jax.grad(local_loss, argnums=(0, 1, 2, 3))(
            staged_local, embed_p, norm_p, head_p)
        return (g[0],) + jax.tree_util.tree_map(lambda x: x[None], g[1:])

    return jax.jit(jax.shard_map(
        grads_fn, mesh=mesh, in_specs=(specs, P(), P(), P(), P()),
        out_specs=(specs, P("pp"), P("pp"), P("pp")),
        check_vma=False))(staged, params["embed"], params["norm_f"],
                          params["lm_head"], tokens)


def _jax_remat(params, tokens):
    """tests/test_pipeline.py::test_pipeline_remat_matches' sum(y^2) and its
    staged gradients, remat=True."""
    mesh = Mesh(np.array(jax.devices("cpu")[:PP]), ("pp",))
    staged, specs = _staged(params, mesh)
    block = JaxBlock(CFG)
    positions = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None],
                                 (B // MB, L))

    def stage_fn(stage_params, x):
        def layer(x, p):
            return block.apply({"params": p}, x, positions), None
        return lax.scan(layer, x, stage_params)[0]

    def fwd(staged_local, embed_p, tokens):
        local = jax.tree_util.tree_map(lambda x: x[0], staged_local)
        emb = nn.Embed(CFG.vocab_size, CFG.embed_dim,
                       param_dtype=jnp.float32, dtype=CFG.dtype)
        x = emb.apply({"params": embed_p}, tokens)
        y = jax_pipeline(stage_fn, local,
                         x.reshape((MB, B // MB) + x.shape[1:]), "pp",
                         remat=True)
        return jnp.sum(y.astype(jnp.float32) ** 2)

    f = jax.jit(jax.shard_map(fwd, mesh=mesh, in_specs=(specs, P(), P()),
                              out_specs=P(), check_vma=False))
    val = f(staged, params["embed"], tokens)
    g = jax.grad(lambda s: f(s, params["embed"], tokens))(staged)
    return float(val), g


def _state(tree):
    return transformer_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), PORT_CFG)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    model, params, tokens = _setup()

    def full_loss(p):
        return jnp.mean(model.apply({"params": p}, tokens) ** 2)

    want = dict(logits=np.asarray(model.apply({"params": params}, tokens)),
                full=_state(jax.grad(full_loss)(params)),
                contract=_jax_contract(params, tokens),
                remat=_jax_remat(params, tokens))
    inputs = dict(state=_state(params),
                  tokens=torch.from_numpy(np.array(tokens)))
    got = worker.spawn(worker.run_pipeline,
                       tmp_path_factory.mktemp("pipeline"), inputs)
    return want, got


def _stage_slice(stacked, p):
    return {k: v[p * PER:(p + 1) * PER] for k, v in stacked.items()}


def _jax_staged_to_port(tree, p):
    """JAX staged leaves [PP, PER, ...] of stage p as the port's stacked
    {name: [PER, ...]}, each layer's leaves through convert."""
    layers = [block_state_dict_from_jax(
        jax.tree_util.tree_map(lambda x: np.asarray(x)[p, i], tree),
        PORT_CFG) for i in range(PER)]
    return {k: torch.stack([sd[k] for sd in layers]) for k in layers[0]}


def test_pipeline_forward_matches_full_model(ranks):
    want, got = ranks
    for out in got:
        np.testing.assert_allclose(_np(out["fwd"]), want["logits"],
                                   rtol=FWD_TOL, atol=FWD_TOL)


def test_pipeline_composes_with_dp(ranks):
    """(dp=2 x pp=2): each dp row runs the schedule on its half of the
    batch; its logits are those rows of the full model's."""
    want, got = ranks
    for r, out in enumerate(got):
        d = r // 2
        np.testing.assert_allclose(_np(out["dp_pp"]),
                                   want["logits"][d * 2:(d + 1) * 2],
                                   rtol=FWD_TOL, atol=FWD_TOL)


def test_pipeline_gradients_flow(ranks):
    """Autograd through the schedule: the staged gradients (local loss
    scaled by 1 / pp) equal the full model's, stacked the same way."""
    want, got = ranks
    full = stack_block_params(want["full"], worker.PIPE["num_layers"])
    for r, out in enumerate(got):
        mine = _stage_slice(full, r % 2)
        staged = out["contract"]["staged"]
        assert set(staged) == set(mine)
        for name, g in staged.items():
            np.testing.assert_allclose(_np(g), mine[name].numpy(),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=name)


def test_pipeline_inprocess_grad_sync_contract(ranks):
    """The contract's raw gradients equal JAX's on every rank (the
    collection's psum transposes to a psum: the outside parameters' raw
    gradients are rank-dependent), and summed over pp they equal the full
    model's."""
    want, got = ranks
    g_staged, g_embed, g_norm, g_head = want["contract"]
    raw_j = {"embed": g_embed["embedding"], "norm_f": g_norm["scale"],
             "lm_head": g_head["kernel"]}
    full = {"embed": want["full"]["embed.weight"],
            "norm_f": want["full"]["norm_f.weight"],
            "lm_head": want["full"]["lm_head.weight"]}
    for r, out in enumerate(got):
        p = r % 2
        res = out["contract"]
        for name, g in res["raw"].items():
            exp = np.asarray(raw_j[name][p])
            if name == "lm_head":
                exp = exp.T
            np.testing.assert_allclose(_np(g), exp, rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=name)
            np.testing.assert_allclose(_np(res["synced"][name]),
                                       full[name].numpy(), rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=name)
        mine = _jax_staged_to_port(g_staged, p)
        for name, g in res["staged"].items():
            np.testing.assert_allclose(_np(g), mine[name].numpy(),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=name)


def test_pipeline_remat_matches(ranks):
    """remat=True (each stage under torch.utils.checkpoint) changes
    neither the value nor the staged gradients, and both equal JAX's."""
    want, got = ranks
    val_j, g_j = want["remat"]
    for r, out in enumerate(got):
        plain, remat = out["remat_False"], out["remat_True"]
        np.testing.assert_allclose(float(remat["val"]), float(plain["val"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(remat["val"]), val_j, rtol=1e-5)
        mine = _jax_staged_to_port(g_j, r % 2)
        for name, g in remat["grads"].items():
            np.testing.assert_allclose(_np(g), _np(plain["grads"][name]),
                                       rtol=2e-5, atol=2e-5, err_msg=name)
            exp = mine[name].numpy()
            np.testing.assert_allclose(
                _np(g), exp, rtol=GRAD_TOL,
                atol=GRAD_TOL * np.abs(exp).max(), err_msg=name)


def test_stack_block_params_matches_the_reference():
    """stack_block_params stacks the port's blocks.<i>. entries as the
    reference stacks block_<i>: layer i's slice of every stacked weight is
    layer i's converted weight."""
    _, params, _ = _setup()
    stacked = stack_block_params(_state(params), CFG.num_layers)
    mine = _jax_staged_to_port(jax.tree_util.tree_map(
        lambda x: x.reshape((PP, PER) + x.shape[1:]),
        jax_stack(params, CFG.num_layers)), 1)
    assert stacked["attn.query.weight"].shape == (4, 32, 32)
    for name, v in mine.items():
        assert torch.equal(stacked[name][PER:], v), name
