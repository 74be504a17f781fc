"""The port's Ulysses sequence parallelism against the JAX package's, on
the CPU.

Counterparts of tests/test_parallel.py's Ulysses tests (dense heads and
GQA) and of the Ulysses model: on 4 gloo ranks
(tests/torch_port_parallel_worker.py, spawned once for the module), the
"sp" axis over all 4, against JAX under ``shard_map`` on 4 virtual CPU
devices:

- ``ulysses_attention`` (the tiled all-to-alls around ``flash_attention``,
  whose plain versions run here) on contiguous sequence shards, MHA (8
  heads), GQA (8 on 4 kv heads) and GQA with fused rotary: the output and
  the gradients of q, k, v against JAX's ``ulysses_attention``;
- the ``attention="ulysses"`` Transformer with flax weights through
  ``convert``, rotary outside and fused: each rank's logits against the
  flax model's with dense attention over the whole sequence, and the
  averaged gradients of one ``make_train_step`` step against the flax
  model's gradient of the mean loss.

Inputs come from numpy; both sides run in float32, JAX at its highest
matmul precision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import torch_port_parallel_worker as worker
from horovod_tpu import models as jax_models
from horovod_tpu.parallel import ulysses_attention as jax_ulysses
from horovod_tpu_torch.convert import transformer_state_dict_from_jax
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.parallel import ulysses_attention

jax.config.update("jax_default_matmul_precision", "highest")

# tests/test_parallel.py's Ulysses and ring gradient tolerance
TOL = 2e-4
# the 2-layer model: tests/test_torch_port_transformer.py's
LOGIT_TOL = 2e-5
GRAD_TOL = 1e-4

N = worker.WORLD
# name -> (B, L, H, G, D, rotary base), tests/test_parallel.py's shapes
ATTN = {"mha": (2, 32, 8, 8, 16, None),
        "gqa": (2, 32, 8, 4, 16, None),
        "gqa_rope": (2, 32, 8, 4, 16, 10000.0)}


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _attn_inputs(name):
    B, L, H, G, D, rb = ATTN[name]
    rng = np.random.RandomState(31 + sorted(ATTN).index(name))
    return (rng.randn(B, L, H, D).astype(np.float32),
            rng.randn(B, L, G, D).astype(np.float32),
            rng.randn(B, L, G, D).astype(np.float32),
            rng.randn(B, L, H, D).astype(np.float32), rb)


def _jax_attn(q, k, v, w, rb):
    """JAX ulysses_attention under shard_map over 4 devices: out and the
    gradients of sum(out * w)."""
    mesh = Mesh(np.array(jax.devices("cpu")[:N]), ("sp",))

    def f(q, k, v, w):
        def loss(q, k, v):
            return jnp.sum(jax_ulysses(q, k, v, "sp", causal=True,
                                       rotary_base=rb) * w)

        out = jax_ulysses(q, k, v, "sp", causal=True, rotary_base=rb)
        return (out,) + jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    spec = P(None, "sp")
    return [np.asarray(a) for a in jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(spec,) * 4, out_specs=(spec,) * 4,
        check_vma=False))(*(jnp.asarray(a) for a in (q, k, v, w)))]


def _jax_lm(fused):
    """The flax model (dense attention: rotary outside) on the whole
    sequence: params, tokens, logits, and the gradient of the mean
    next-token loss."""
    cfg = jax_models.TransformerConfig(dtype=jnp.float32, **worker.ULY_LM)
    model = jax_models.Transformer(cfg)
    tokens = jnp.asarray(np.random.RandomState(13 + fused).randint(
        0, cfg.vocab_size, (2, 32)))
    params = model.init(jax.random.PRNGKey(17 + fused), tokens)["params"]

    def loss_fn(p):
        logp = jax.nn.log_softmax(model.apply({"params": p}, tokens))
        tgt = jnp.roll(tokens, -1, axis=1)
        return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], -1))

    return (params, np.asarray(tokens),
            np.asarray(model.apply({"params": params}, tokens)),
            jax.grad(loss_fn)(params))


def _state(tree):
    cfg = TransformerConfig(dtype=torch.float32, **worker.ULY_LM)
    return transformer_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), cfg)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs, want = {}, {}
    for name in ATTN:
        q, k, v, w, rb = _attn_inputs(name)
        inputs[name] = dict(q=torch.from_numpy(q), k=torch.from_numpy(k),
                            v=torch.from_numpy(v), w=torch.from_numpy(w),
                            rotary_base=rb)
        want[name] = _jax_attn(q, k, v, w, rb)
    for name, fused in (("lm", False), ("lm_rope", True)):
        params, tokens, logits, grads = _jax_lm(fused)
        inputs[name] = dict(state=_state(params),
                            tokens=torch.from_numpy(tokens.copy()))
        want[name] = dict(logits=logits, grads=_state(grads))
    got = worker.spawn(worker.run_ulysses,
                       tmp_path_factory.mktemp("ulysses"), inputs)
    return want, got


@pytest.mark.parametrize("name", sorted(ATTN))
def test_ulysses_attention_matches_jax(ranks, name):
    """Each rank's output and q, k, v gradients are its sequence shard of
    JAX's (the all-to-alls' backward is the inverse exchange; the
    contiguous head split keeps each kv head with its query heads)."""
    want, got = ranks
    out_j, dq_j, dk_j, dv_j = want[name]
    Ll = ATTN[name][1] // N
    for r, res in enumerate(got):
        sl = slice(r * Ll, (r + 1) * Ll)
        for key, exp in (("out", out_j), ("dq", dq_j), ("dk", dk_j),
                         ("dv", dv_j)):
            np.testing.assert_allclose(_np(res[name][key]), exp[:, sl],
                                       rtol=TOL, atol=TOL,
                                       err_msg="%s rank %d" % (key, r))


@pytest.mark.parametrize("name", ["lm", "lm_rope"])
def test_ulysses_transformer_matches_jax(ranks, name):
    """attention="ulysses" (rotary outside; fused in the kernels at the
    gathered sequence's positions): each rank's logits are its shard of
    the flax model's over the whole sequence, and one step's averaged
    gradients are the flax model's gradient of the mean loss."""
    want, got = ranks
    w = want[name]
    for r, out in enumerate(got):
        res = out[name]
        Ll = res["L"]
        np.testing.assert_allclose(_np(res["logits"]),
                                   w["logits"][:, r * Ll:(r + 1) * Ll],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        assert set(res["grads"]) == set(w["grads"])
        for k, g in res["grads"].items():
            np.testing.assert_allclose(_np(g), w["grads"][k].numpy(),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=k)


def test_ulysses_checks_and_one_rank():
    """The reference's check that G divides H; at one rank the all-to-alls
    are copies, so the output and gradients equal flash_attention's bit
    for bit."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import flash_attention
    from horovod_tpu_torch.parallel import hybrid_mesh
    hvd.init(device="cpu")
    try:
        hybrid_mesh((1,), ("sp",))
        rng = np.random.RandomState(5)
        q, k, v = (torch.from_numpy(rng.randn(1, 16, h, 8).astype(
            np.float32)).requires_grad_() for h in (6, 3, 3))
        k4, v4 = (torch.cat([t, t[:, :, :1]], 2) for t in (k, v))
        with pytest.raises(ValueError, match="multiple"):
            ulysses_attention(q, k4, v4, "sp")  # 6 heads on 4 kv heads
        out = ulysses_attention(q, k, v, "sp", rotary_base=10000.0)
        grads = torch.autograd.grad(out.square().sum(), (q, k, v))
        ref = flash_attention(q, k, v, causal=True, rotary_base=10000.0)
        ref_grads = torch.autograd.grad(ref.square().sum(), (q, k, v))
        assert torch.equal(out, ref)
        for a, b in zip(grads, ref_grads):
            assert torch.equal(a, b)
    finally:
        hvd.shutdown()
    with pytest.raises(ValueError, match="needs sp_axis"):
        TransformerConfig(attention="ulysses")
    cfg = TransformerConfig(attention="ulysses", sp_axis="sp",
                            dtype=torch.float32, **worker.ULY_LM)
    assert Transformer(cfg, device="cpu").cfg.attention == "ulysses"
