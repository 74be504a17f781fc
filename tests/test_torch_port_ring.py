"""The port's sequence-parallel ring attention against the JAX package's, on
the CPU.

- The plain versions of K4, K5 and K6 (through their wrappers, which take
  them on CPU tensors) against JAX ``flash_ring_step`` and
  ``flash_ring_bwd_step`` in Pallas interpret mode, the grouped-rows layout
  and 8-lane stripes converted.
- The same with fused rotary (``rotary_base``): the steps' rotated-space
  sums against the JAX kernels' ``rotary_base``.
- ``ring_attention`` on 2 and 4 gloo ranks (tests/torch_port_ring_worker.py,
  spawned once per world size) against JAX ``ring_attention`` under
  ``shard_map`` on the virtual CPU devices with
  ``HVD_TPU_PALLAS_INTERPRET=1``, contiguous and zigzag, values and
  gradients, at the shapes of tests/test_parallel.py's ring tests, and
  with fused rotary (the counter-rotation after the last step).
- The ``attention="ring"`` Transformer on 2 gloo ranks, with flax weights
  through ``convert``, against the JAX model with dense attention over the
  whole natural-order sequence: logits and the averaged gradients of one
  ``make_train_step`` step.
- Zigzag layouts, argument errors, the causal skip, ``hybrid_mesh``.

Inputs come from numpy; both sides run in float32, JAX at its highest
matmul precision.
"""

import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as hvd
import horovod_tpu_torch.ops.flash_attention  # noqa: F401
import torch_port_ring_worker as worker
from horovod_tpu import models as jax_models
from horovod_tpu.ops.flash_attention import (_from_rows, _to_rows,
                                             flash_ring_bwd_step,
                                             flash_ring_step)
from horovod_tpu.parallel import ring_attention as jax_ring_attention
from horovod_tpu.parallel import zigzag_shard as jax_zigzag_shard
from horovod_tpu_torch.convert import transformer_state_dict_from_jax
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.parallel import (axis_group, hybrid_mesh,
                                        ring_attention, zigzag_shard,
                                        zigzag_unshard)
from horovod_tpu_torch.parallel.ring import _schedule_offsets

fa = sys.modules["horovod_tpu_torch.ops.flash_attention"]

# Values and gradients: tests/test_parallel.py's ring tolerances (the same
# f32 arithmetic in another order; gradients through a longer chain).
FWD_TOL = 2e-5
BWD_TOL = 2e-4
# The 2-layer model: tests/test_torch_port_transformer.py's.
LOGIT_TOL = 2e-5
GRAD_TOL = 1e-4

# One ring step: (group, q chunk offsets, k/v chunk offsets, causal, a
# carried state or accumulators, or fresh ones). B=1, G=2 kv heads, 2 *
# group query heads, Lq = Lk = 256, D = 16. Zigzag offsets are those of
# n = 2 (chunks of 128: rank 0 holds (0, 384), rank 1 (128, 256)).
STEP_CASES = {
    "diagonal": (1, (0,), (0,), True, False),
    "past": (2, (256,), (0,), True, True),
    "rows-see-nothing": (1, (0,), (128,), True, False),
    "rows-see-nothing-carried": (2, (0,), (128,), True, True),
    "zigzag": (1, (0, 384), (128, 256), True, True),
    "zigzag-reverse": (2, (128, 256), (0, 384), True, False),
    "full": (1, (256,), (0,), False, True),
}
B, G, L, D = 1, 2, 256, 16


def _jax_offset(offset):
    return (jnp.int32(offset[0]) if len(offset) == 1
            else jnp.asarray(offset, jnp.int32))


def _stripe(x, group):
    """port f32 [B, H, L] -> JAX [B*G, L*group, 8]."""
    rows = _to_rows(jnp.asarray(x)[..., None], group)
    return jnp.broadcast_to(rows, rows.shape[:-1] + (8,))


def _unstripe(x, group):
    return np.asarray(_from_rows(x[..., :1], B, group))[..., 0]


def _step_inputs(name):
    group, _, _, _, carried = STEP_CASES[name]
    H = G * group
    rng = np.random.RandomState(sorted(STEP_CASES).index(name))
    q, dout = (rng.randn(B, H, L, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, G, L, D).astype(np.float32) for _ in range(2))
    if carried:
        state = (rng.randn(B, H, L, D), rng.randn(B, H, L),
                 rng.uniform(0.5, 2.0, (B, H, L)))
        accs = (rng.randn(B, H, L, D), rng.randn(B, G, L, D),
                rng.randn(B, G, L, D))
    else:
        state = (np.zeros((B, H, L, D)), np.full((B, H, L), -np.inf),
                 np.zeros((B, H, L)))
        accs = (np.zeros((B, H, L, D)), np.zeros((B, G, L, D)),
                np.zeros((B, G, L, D)))
    lse = rng.uniform(2.0, 4.0, (B, H, L))
    delta = rng.randn(B, H, L)
    f32 = functools.partial(np.asarray, dtype=np.float32)
    return (q, k, v, dout, [f32(s) for s in state], f32(lse), f32(delta),
            [f32(a) for a in accs])


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_ring_step_matches_jax(name):
    """K4's plain version (its CPU wrapper, in place) against JAX's kernel."""
    group, q_off, kv_off, causal, _ = STEP_CASES[name]
    q, k, v, _, state, _, _, _ = _step_inputs(name)
    scale = D ** -0.5
    with jax.default_matmul_precision("highest"):
        o_j, m_j, l_j = flash_ring_step(
            _to_rows(jnp.asarray(q), group), _to_rows(jnp.asarray(k), 1),
            _to_rows(jnp.asarray(v), 1), _to_rows(jnp.asarray(state[0]),
                                                  group),
            _stripe(state[1], group), _stripe(state[2], group),
            q_offset=_jax_offset(q_off), kv_offset=_jax_offset(kv_off),
            causal=causal, scale=scale, interpret=True, group=group)
    o, m, l = (torch.from_numpy(s.copy()) for s in state)
    got = fa.flash_ring_step(*(torch.from_numpy(x) for x in (q, k, v)), o, m,
                             l, q_off, kv_off, scale, causal)
    assert got[0] is o and got[1] is m and got[2] is l  # in place
    np.testing.assert_allclose(o.numpy(), np.asarray(_from_rows(o_j, B,
                                                                group)),
                               rtol=FWD_TOL, atol=FWD_TOL)
    # -inf where no key was visible: the same rows on both sides
    np.testing.assert_allclose(m.numpy(), _unstripe(m_j, group),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(l.numpy(), _unstripe(l_j, group),
                               rtol=FWD_TOL, atol=FWD_TOL)
    if name.startswith("rows-see-nothing") and not STEP_CASES[name][4]:
        assert torch.isneginf(m[:, :, :128]).all()


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_ring_bwd_step_matches_jax(name):
    """K5's and K6's plain versions against JAX's two backward kernels."""
    group, q_off, kv_off, causal, _ = STEP_CASES[name]
    q, k, v, dout, _, lse, delta, accs = _step_inputs(name)
    scale = D ** -0.5
    with jax.default_matmul_precision("highest"):
        dq_j, dk_j, dv_j = flash_ring_bwd_step(
            _to_rows(jnp.asarray(q), group), _to_rows(jnp.asarray(k), 1),
            _to_rows(jnp.asarray(v), 1), _to_rows(jnp.asarray(dout), group),
            _stripe(lse, group), _stripe(delta, group),
            _to_rows(jnp.asarray(accs[0]), group),
            _to_rows(jnp.asarray(accs[1]), 1),
            _to_rows(jnp.asarray(accs[2]), 1),
            q_offset=_jax_offset(q_off), kv_offset=_jax_offset(kv_off),
            causal=causal, scale=scale, interpret=True, group=group)
    tq, tk, tv, tdo, tlse, tdelta = (torch.from_numpy(x) for x in
                                     (q, k, v, dout, lse, delta))
    dq, dk, dv = (torch.from_numpy(a.copy()) for a in accs)
    assert fa.flash_ring_bwd_dq(tq, tk, tv, tdo, tlse, tdelta, dq, q_off,
                                kv_off, scale, causal) is dq
    fa.flash_ring_bwd_dkv(tq, tk, tv, tdo, tlse, tdelta, dk, dv, q_off,
                          kv_off, scale, causal)
    for got, want in ((dq, _from_rows(dq_j, B, group)),
                      (dk, dk_j.reshape(B, G, L, D)),
                      (dv, dv_j.reshape(B, G, L, D))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=BWD_TOL, atol=BWD_TOL)


ROTARY_STEP_CASES = ("diagonal", "past", "zigzag", "zigzag-reverse", "full")


@pytest.mark.parametrize("name", ROTARY_STEP_CASES)
def test_rotary_ring_steps_match_jax(name):
    """K4's, K5's and K6's plain versions with fused rotary (q and k rotated
    at the shards' global positions; dq and dk left in rotated space)
    against JAX's ring step kernels with ``rotary_base``."""
    group, q_off, kv_off, causal, _ = STEP_CASES[name]
    q, k, v, dout, state, lse, delta, accs = _step_inputs(name)
    scale = D ** -0.5
    offs = dict(q_offset=_jax_offset(q_off), kv_offset=_jax_offset(kv_off),
                causal=causal, scale=scale, interpret=True, group=group,
                rotary_base=worker.ROPE)
    with jax.default_matmul_precision("highest"):
        o_j, m_j, l_j = flash_ring_step(
            _to_rows(jnp.asarray(q), group), _to_rows(jnp.asarray(k), 1),
            _to_rows(jnp.asarray(v), 1), _to_rows(jnp.asarray(state[0]),
                                                  group),
            _stripe(state[1], group), _stripe(state[2], group), **offs)
        dq_j, dk_j, dv_j = flash_ring_bwd_step(
            _to_rows(jnp.asarray(q), group), _to_rows(jnp.asarray(k), 1),
            _to_rows(jnp.asarray(v), 1), _to_rows(jnp.asarray(dout), group),
            _stripe(lse, group), _stripe(delta, group),
            _to_rows(jnp.asarray(accs[0]), group),
            _to_rows(jnp.asarray(accs[1]), 1),
            _to_rows(jnp.asarray(accs[2]), 1), **offs)
    tq, tk, tv, tdo, tlse, tdelta = (torch.from_numpy(x) for x in
                                     (q, k, v, dout, lse, delta))
    o, m, l = (torch.from_numpy(s.copy()) for s in state)
    fa.flash_ring_step(tq, tk, tv, o, m, l, q_off, kv_off, scale, causal,
                       worker.ROPE)
    dq, dk, dv = (torch.from_numpy(a.copy()) for a in accs)
    fa.flash_ring_bwd_dq(tq, tk, tv, tdo, tlse, tdelta, dq, q_off, kv_off,
                         scale, causal, worker.ROPE)
    fa.flash_ring_bwd_dkv(tq, tk, tv, tdo, tlse, tdelta, dk, dv, q_off,
                          kv_off, scale, causal, worker.ROPE)
    for got, want, tol in (
            (o, _from_rows(o_j, B, group), FWD_TOL),
            (m, _unstripe(m_j, group), FWD_TOL),
            (l, _unstripe(l_j, group), FWD_TOL),
            (dq, _from_rows(dq_j, B, group), BWD_TOL),
            (dk, dk_j.reshape(B, G, L, D), BWD_TOL),
            (dv, dv_j.reshape(B, G, L, D), BWD_TOL)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


def test_cpu_ring_steps_launch_nothing():
    fa.reset_launch_counts()
    q, k, v, dout, state, lse, delta, accs = _step_inputs("zigzag")
    t = [torch.from_numpy(x) for x in (q, k, v, dout, lse, delta)]
    s = [torch.from_numpy(x) for x in state + accs]
    fa.flash_ring_step(*t[:3], *s[:3], (0, 384), (128, 256), 0.25, True)
    fa.flash_ring_bwd_dq(*t, s[3], (0, 384), (128, 256), 0.25, True)
    fa.flash_ring_bwd_dkv(*t, s[4], s[5], (0, 384), (128, 256), 0.25, True)
    assert set(fa.launch_counts().values()) == {0}


def test_shard_chunks_and_positions():
    assert fa.shard_chunks((5,), 10) == (5, 15, 10)
    assert fa.shard_chunks((0, 30), 10) == (0, 30, 5)
    assert fa.shard_positions((0, 30), 6).tolist() == [0, 1, 2, 30, 31, 32]
    with pytest.raises(ValueError, match="one chunk"):
        fa.shard_chunks(5, 10)
    with pytest.raises(ValueError, match="two equal chunks"):
        fa.shard_chunks((0, 30), 7)
    with pytest.raises(ValueError, match="two equal chunks"):
        fa.shard_chunks((0, 1, 2), 6)


# ------------------------------------------------------------ gloo ranks


@functools.lru_cache(maxsize=None)
def _lm_params():
    """flax params of the 2-layer LM, from its dense twin (a ring model
    cannot trace outside shard_map), as numpy."""
    cfg = jax_models.TransformerConfig(dtype=jnp.float32, **worker.LM)
    tokens = jnp.zeros((1, 16), jnp.int32)
    params = jax_models.Transformer(cfg).init(jax.random.PRNGKey(0),
                                              tokens)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_lm_config(**kw):
    return TransformerConfig(dtype=torch.float32, **worker.LM, **kw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: [what each rank saved]} of torch_port_ring_worker."""
    base = tmp_path_factory.mktemp("ring")
    state = transformer_state_dict_from_jax(_lm_params(), _port_lm_config())
    got = {}
    for size in (2, 4):
        out_dir = base / ("n%d" % size)
        out_dir.mkdir()
        torch.save(state, out_dir / "lm_state.pt")
        got[size] = worker.spawn(out_dir, size)
    return got


def _jax_ring(case):
    """JAX ring_attention under shard_map over the case's ranks: (out, dq,
    dk, dv) of sum(out * w), each the ranks' shards concatenated."""
    n, _, _, _, _, _, causal, schedule, rope = worker.ring_case(case)
    arrays = [jnp.asarray(x) for x in worker.ring_inputs(case)]
    if schedule == "zigzag":
        arrays = [jax_zigzag_shard(x, n) for x in arrays]

    def fwd_and_grads(q, k, v, w):
        def loss(q, k, v):
            out = jax_ring_attention(q, k, v, "sp", causal=causal,
                                     schedule=schedule, rotary_base=rope)
            return jnp.sum(out.astype(jnp.float32) * w), out
        (_, out), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        return (out,) + grads

    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("sp",))
    f = jax.jit(jax.shard_map(
        fwd_and_grads, mesh=mesh, in_specs=(P(None, "sp"),) * 4,
        out_specs=(P(None, "sp"),) * 4, check_vma=False))
    with jax.default_matmul_precision("highest"):
        return [np.asarray(x) for x in f(*arrays)]


@pytest.mark.parametrize("case", sorted(worker.RING_CASES) +
                         sorted(worker.ROTARY_CASES))
def test_ring_attention_matches_jax(ranks, case, monkeypatch):
    monkeypatch.setenv("HVD_TPU_PALLAS_INTERPRET", "1")
    n = worker.ring_case(case)[0]
    want = _jax_ring(case)
    for key, ref, tol in zip(("out", "dq", "dk", "dv"), want,
                             (FWD_TOL, BWD_TOL, BWD_TOL, BWD_TOL)):
        got = torch.cat([r[case][key] for r in ranks[n]], dim=1).numpy()
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol,
                                   err_msg=key)


def test_rotary_ring_backward_rotates_q_and_k_once(ranks):
    """Under rotary the ring rotates its q shard and its home k shard once
    each, in the forward, at the rank's own offsets (``rotate_shards``,
    before the loop); its backward rotates nothing (autograd kept the
    copies), and no K4, K5 or K6 step gets a rotary base (the rotated k
    travels with v). The values and gradients of the same runs are held
    against JAX in ``test_ring_attention_matches_jax``."""
    for case in worker.ROTARY_CASES:
        n, B, L, H, G, D, _, schedule, _ = worker.ring_case(case)
        Ls = L // n
        for r, got in enumerate(ranks[n]):
            off = _schedule_offsets(schedule, r, n, Ls)
            assert got[case]["rope_rotate"] == [((B, H, Ls, D), off),
                                                ((B, G, Ls, D), off)], (
                case, r)
            assert got[case]["rope_rotate_in_backward"] == 0, (case, r)
            calls, rot = got[case]["calls"], got[case]["rotary_calls"]
            assert calls["flash_ring_step_ref"] > 0, (case, r)
            assert calls["flash_ring_bwd_dq_ref"] > 0, (case, r)
            assert rot == {"flash_ring_step_ref": 0,
                           "flash_ring_bwd_dq_ref": 0,
                           "flash_ring_bwd_dkv_ref": 0}, (case, r)


def test_contiguous_causal_ring_skips_future_shards(ranks):
    """Rank r of a contiguous causal ring runs its steps for the r + 1 kv
    shards at or before its own; zigzag and non-causal rings run all n."""
    for case, (n, _, _, _, _, _, causal, schedule) in \
            worker.RING_CASES.items():
        for r, got in enumerate(ranks[n]):
            want = r + 1 if causal and schedule == "contiguous" else n
            assert got[case]["calls"] == {name: want for name in
                                          worker.COUNTED}, (case, r)


def test_hybrid_mesh_axes_on_four_ranks(ranks):
    """hybrid_mesh((2, -1), ("dp", "sp")): the trailing axis holds
    consecutive ranks."""
    for r, got in enumerate(ranks[4]):
        assert got["mesh"] == {"dp": [r % 2, r % 2 + 2],
                               "sp": [r // 2 * 2, r // 2 * 2 + 1]}


@pytest.mark.parametrize("case", sorted(worker.LM_CASES))
def test_ring_transformer_matches_jax_dense(ranks, case):
    """The ring model's shard logits and its gradients after one
    make_train_step step (averaged over the 2 ranks) against the JAX model
    with dense attention on the whole sequence."""
    n, _, _, schedule = worker.LM_CASES[case]
    tokens = jnp.asarray(worker.lm_tokens(case), jnp.int32)
    params = _lm_params()
    model = jax_models.Transformer(jax_models.TransformerConfig(
        attention="dense", dtype=jnp.float32, **worker.LM))

    def loss_fn(params):
        logits = model.apply({"params": params}, tokens)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        tgt = jnp.roll(tokens, -1, axis=1)
        return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], axis=-1))

    with jax.default_matmul_precision("highest"):
        logits = jax.jit(model.apply)({"params": params}, tokens)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    logits = torch.from_numpy(np.array(logits))
    expected = transformer_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads), _port_lm_config())
    for r, got in enumerate(ranks[n]):
        np.testing.assert_allclose(
            got[case]["logits"].numpy(),
            worker.shard(logits, n, r, schedule).numpy(), rtol=LOGIT_TOL,
            atol=LOGIT_TOL)
        np.testing.assert_allclose(got[case]["loss"].item(), float(loss),
                                   rtol=1e-5)
        assert set(got[case]["grads"]) == set(expected)
        for name, g in got[case]["grads"].items():
            np.testing.assert_allclose(g.numpy(), expected[name].numpy(),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=name)


# ------------------------------------------------------- one process


def test_zigzag_layouts_match_jax_and_invert():
    x = np.arange(2 * 1024 * 3, dtype=np.float32).reshape(2, 1024, 3)
    for n in (1, 2, 4):
        z = zigzag_shard(torch.from_numpy(x), n)
        np.testing.assert_array_equal(
            z.numpy(), np.asarray(jax_zigzag_shard(jnp.asarray(x), n)))
        np.testing.assert_array_equal(zigzag_unshard(z, n).numpy(), x)
    with pytest.raises(ValueError, match="equal chunks"):
        zigzag_shard(torch.zeros(1, 10), 4)


def test_ring_attention_argument_errors():
    """The JAX function's ValueErrors, raised before any communication."""
    q = torch.zeros(1, 256, 2, 16)
    with pytest.raises(ValueError, match="causal"):
        ring_attention(q, q, q, "sp", causal=False, schedule="zigzag")
    with pytest.raises(ValueError, match="256"):
        ring_attention(q[:, :128], q[:, :128], q[:, :128], "sp",
                       causal=True, schedule="zigzag")
    with pytest.raises(ValueError, match="unknown ring schedule"):
        ring_attention(q, q, q, "sp", schedule="stripey")
    k3 = torch.zeros(1, 256, 3, 16)
    with pytest.raises(ValueError, match="multiple of num_kv_heads"):
        ring_attention(q, k3, k3, "sp")


def test_one_rank_ring_is_plain_attention():
    """A one-rank "sp" axis: the ring is one step over the whole sequence,
    with no communication; it equals the blockwise plain attention."""
    hvd.init(device="cpu")
    try:
        mesh = hybrid_mesh((-1,), ("sp",))
        assert mesh.size("sp") == 1 and mesh.rank("sp") == 0
        assert axis_group("sp") is hvd.process_group()
        rng = np.random.RandomState(9)
        q = torch.from_numpy(rng.randn(2, 96, 4, 16).astype(np.float32))
        k, v = (torch.from_numpy(rng.randn(2, 96, 2, 16).astype(np.float32))
                for _ in range(2))
        out = ring_attention(q, k, v, "sp", causal=True)
        ref = fa.blockwise_reference(*(x.transpose(1, 2) for x in (q, k, v)),
                                     16 ** -0.5, True).transpose(1, 2)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=FWD_TOL,
                                   atol=FWD_TOL)
        with pytest.raises(ValueError, match="2 ranks|mesh shape"):
            hybrid_mesh((2,), ("sp",))
        with pytest.raises(ValueError, match="no mesh axis named 'tp'"):
            axis_group("tp")
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("schedule", ["contiguous", "zigzag"])
def test_one_rank_rotary_ring_saves_the_rotated_shards(schedule,
                                                       monkeypatch):
    """A one-rank rotary ring: its forward rotates the q shard and the home
    k shard once (at (0,), or the zigzag chunks (0, L/2), the same
    positions), its backward rotates nothing, and autograd saves the
    rotated copies in place of q and k, five tensors of the same shapes and
    bytes as without rotary. Values and gradients equal flash_attention's
    with the same rotary (the one step over the whole sequence)."""
    ring_mod = sys.modules["horovod_tpu_torch.parallel.ring"]
    calls = []
    rope_rotate = ring_mod.rope_rotate

    def counting(x, offset, base):
        calls.append((tuple(x.shape), offset))
        return rope_rotate(x, offset, base)
    monkeypatch.setattr(ring_mod, "rope_rotate", counting)
    B, L, H, G, D = 1, 256, 4, 2, 16
    rng = np.random.RandomState(10)
    q, w = (torch.from_numpy(rng.randn(B, L, H, D).astype(np.float32))
            for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(B, L, G, D).astype(np.float32))
            for _ in range(2))
    hvd.init(device="cpu")
    try:
        hybrid_mesh((-1,), ("sp",))

        def run(fn, rotary_base):
            packed = []

            def pack(t):
                packed.append(t.detach().clone())
                return t
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                out = fn(*leaves, rotary_base=rotary_base)
            in_forward = len(calls)
            (out * w).sum().backward()
            assert len(calls) == in_forward
            return out, [t.grad for t in leaves], packed

        ring = functools.partial(ring_attention, axis_name="sp",
                                 causal=True, schedule=schedule)
        _, _, plain = run(ring, None)
        assert calls == []
        out, grads, saved = run(ring, worker.ROPE)
        off = (0,) if schedule == "contiguous" else (0, L // 2)
        assert calls == [((B, H, L, D), off), ((B, G, L, D), off)]
        assert len(saved) == len(plain) == 5
        for a, b in zip(plain, saved):
            assert a.shape == b.shape and a.dtype == b.dtype
        pos = torch.arange(L)
        for x, got in ((q, saved[0]), (k, saved[1])):
            assert torch.equal(got, fa.apply_rotary(x.transpose(1, 2), pos,
                                                    worker.ROPE))
        flash = functools.partial(fa.flash_attention, causal=True)
        out_f, grads_f, _ = run(flash, worker.ROPE)
        np.testing.assert_allclose(out.detach().numpy(),
                                   out_f.detach().numpy(), rtol=FWD_TOL,
                                   atol=FWD_TOL)
        for name, a, b in zip(("dq", "dk", "dv"), grads, grads_f):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=BWD_TOL,
                                       atol=BWD_TOL, err_msg=name)
    finally:
        hvd.shutdown()


def test_ring_config_fields():
    """attention="ring" takes the flash/dense model's parameters, so flax
    weights carry over through convert unchanged."""
    ring = Transformer(_port_lm_config(attention="ring", sp_axis="sp",
                                       sp_schedule="zigzag"), device="cpu")
    dense = Transformer(_port_lm_config(), device="cpu")
    assert ({k: v.shape for k, v in ring.state_dict().items()} ==
            {k: v.shape for k, v in dense.state_dict().items()})
    ring.load_state_dict(transformer_state_dict_from_jax(_lm_params(),
                                                         ring.cfg))
    with pytest.raises(ValueError, match="sp_axis"):
        _port_lm_config(attention="ring")
