"""The port's flash attention (horovod_tpu_torch.ops.flash_attention)
against the JAX package's, on the CPU.

The port's wrappers run their plain PyTorch versions on CPU tensors; the
JAX side runs the Pallas kernels in interpret mode, as tests/test_ops.py
does. Inputs come from numpy and go to both sides in float32, with JAX
held to its highest matmul precision. The CUDA kernels themselves are
held against the same plain versions on the GPU (chip_smoke.py and
tests/test_torch_port_cuda.py).
"""

import ctypes
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu_torch.ops.flash_attention  # noqa: F401
from horovod_tpu_torch.ops import _build

from horovod_tpu.ops import flash_attention as jax_flash_attention
from horovod_tpu.ops.flash_attention import (_blockwise_reference,
                                             _from_rows, _pallas_backward,
                                             _pallas_forward_lse)
from horovod_tpu.ops.flash_attention import \
    apply_rotary as jax_apply_rotary

fa = sys.modules["horovod_tpu_torch.ops.flash_attention"]

# Forward: the same f32 arithmetic in another order (tests/test_ops.py).
FWD_TOL = 2e-5
# Gradients: a longer chain of f32 products (tests/test_ops.py:121-124).
BWD_TOL = 2e-4

CASES = [(causal, H, G, D) for causal in (True, False)
         for H, G in ((2, 2), (4, 2)) for D in (32, 64)]


def _ids(case):
    causal, H, G, D = case
    return "%s-H%dG%d-D%d" % ("causal" if causal else "full", H, G, D)


def _inputs(B, H, G, L, D, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, L, D).astype(np.float32)
    k = rng.randn(B, G, L, D).astype(np.float32)
    v = rng.randn(B, G, L, D).astype(np.float32)
    g = rng.randn(B, H, L, D).astype(np.float32)
    return q, k, v, g


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_ref_matches_pallas_forward(case):
    causal, H, G, D = case
    B, L = 1, 256
    q, k, v, _ = _inputs(B, H, G, L, D, seed=0)
    scale = D ** -0.5
    with jax.default_matmul_precision("highest"):
        out_j, lse_j = _pallas_forward_lse(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), scale, causal,
                                           interpret=True)
    # JAX keeps lse as an 8-wide stripe in the grouped-rows layout.
    lse_j = np.asarray(_from_rows(lse_j[..., :1], B, H // G))[..., 0]
    out, lse = fa.flash_forward_ref(*_t(q, k, v), scale, causal)
    assert out.shape == (B, H, L, D) and lse.shape == (B, H, L)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_backward_ref_matches_pallas_backward(case):
    causal, H, G, D = case
    B, L = 1, 256
    q, k, v, g = _inputs(B, H, G, L, D, seed=1)
    scale = D ** -0.5
    with jax.default_matmul_precision("highest"):
        qj, kj, vj = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        out_j, lse_j = _pallas_forward_lse(qj, kj, vj, scale, causal,
                                           interpret=True)
        grads_j = _pallas_backward(qj, kj, vj, out_j, lse_j, jnp.asarray(g),
                                   scale, causal, interpret=True)
    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = fa.flash_forward_ref(tq, tk, tv, scale, causal)
    grads = fa.flash_backward_ref(tq, tk, tv, out, lse, tg, scale, causal)
    for name, a, b in zip(("dq", "dk", "dv"), grads, grads_j):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=BWD_TOL,
                                   atol=BWD_TOL, err_msg=name)


@pytest.mark.parametrize("B,L,H,G,D,causal", [
    (2, 128, 2, 2, 32, True),
    (1, 128, 4, 2, 16, True),     # GQA
    (1, 128, 2, 1, 16, False),    # MQA, full attention
    (1, 160, 2, 2, 8, True),      # L = 128 + a 32-row tail
])
def test_flash_attention_and_grads_match_jax(B, L, H, G, D, causal):
    """The public [B, L, H, D] function and its autograd (_FlashFn)
    against JAX flash_attention and jax.grad."""
    rng = np.random.RandomState(3)
    q = rng.randn(B, L, H, D).astype(np.float32)
    k = rng.randn(B, L, G, D).astype(np.float32)
    v = rng.randn(B, L, G, D).astype(np.float32)
    w = rng.randn(B, L, H, D).astype(np.float32)

    def loss_j(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal=causal) * w)

    with jax.default_matmul_precision("highest"):
        out_j = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
        grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    assert out.shape == (B, L, H, D)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=FWD_TOL, atol=FWD_TOL)
    (out * torch.from_numpy(w)).sum().backward()
    for name, t, gj in zip(("dq", "dk", "dv"), (tq, tk, tv), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj),
                                   rtol=BWD_TOL, atol=BWD_TOL, err_msg=name)


ROPE = 10000.0
ROT_CASES = [(causal, H, G) for causal in (True, False)
             for H, G in ((2, 2), (4, 2))]


@pytest.mark.parametrize("case", ROT_CASES, ids=lambda c: "%s-H%dG%d" % (
    "causal" if c[0] else "full", c[1], c[2]))
def test_rotary_refs_match_pallas_kernels(case):
    """The plain versions of K1-K3 with fused rotary (q and k rotated at
    0..L-1, dQ and dK counter-rotated) against the Pallas kernels' rotary
    flag in interpret mode: out, lse, dq, dk, dv."""
    causal, H, G = case
    B, L, D = 1, 256, 32
    q, k, v, g = _inputs(B, H, G, L, D, seed=11)
    scale = D ** -0.5
    with jax.default_matmul_precision("highest"):
        qj, kj, vj = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        out_j, lse_j = _pallas_forward_lse(qj, kj, vj, scale, causal,
                                           interpret=True, rotary_base=ROPE)
        grads_j = _pallas_backward(qj, kj, vj, out_j, lse_j, jnp.asarray(g),
                                   scale, causal, interpret=True,
                                   rotary_base=ROPE)
    lse_j = np.asarray(_from_rows(lse_j[..., :1], B, H // G))[..., 0]
    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = fa.flash_fwd(tq, tk, tv, scale, causal, ROPE)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=FWD_TOL,
                               atol=FWD_TOL)
    grads = fa.flash_backward(tq, tk, tv, out, lse, tg, scale, causal, ROPE)
    for name, a, b in zip(("dq", "dk", "dv"), grads, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=BWD_TOL,
                                   atol=BWD_TOL, err_msg=name)
    # the rotation is there: without it the output is another function
    plain, _ = fa.flash_forward_ref(tq, tk, tv, scale, causal)
    assert (plain - out).abs().max() > 100 * FWD_TOL


@pytest.mark.parametrize("B,L,H,G,D", [
    (2, 128, 2, 2, 32),
    (1, 160, 4, 2, 16),     # GQA, L = 128 + a 32-row tail
    (1, 77, 6, 2, 32),      # GQA 3, a ragged L below one block
])
def test_rotary_flash_attention_and_grads_match_jax(B, L, H, G, D):
    """flash_attention(rotary_base=) and its autograd against JAX
    flash_attention(rotary_base=) and jax.grad, causal."""
    rng = np.random.RandomState(12)
    q = rng.randn(B, L, H, D).astype(np.float32)
    k = rng.randn(B, L, G, D).astype(np.float32)
    v = rng.randn(B, L, G, D).astype(np.float32)
    w = rng.randn(B, L, H, D).astype(np.float32)

    def loss_j(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal=True,
                                           rotary_base=ROPE) * w)

    with jax.default_matmul_precision("highest"):
        out_j = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    rotary_base=ROPE)
        grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=True, rotary_base=ROPE)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=FWD_TOL, atol=FWD_TOL)
    (out * torch.from_numpy(w)).sum().backward()
    for name, t, gj in zip(("dq", "dk", "dv"), (tq, tk, tv), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj),
                                   rtol=BWD_TOL, atol=BWD_TOL, err_msg=name)


@pytest.mark.parametrize("H,G", [(4, 4), (4, 2), (4, 1)])
def test_rotary_flash_attention_rotates_once_in_the_forward(H, G,
                                                            monkeypatch):
    """flash_attention(rotary_base=) rotates q and k once per call, in the
    forward (``rope_rotate``, the pass on the card; on the CPU its plain
    version, ``apply_rotary``), and its backward rotates nothing: no pass,
    and no ``apply_rotary`` but the counter-rotation of dQ and dK."""
    B, L, D = 1, 96, 32
    calls = []
    rope_rotate, apply_rotary = fa.rope_rotate, fa.apply_rotary

    def counting_rope(x, offset, base):
        calls.append(("rope_rotate", tuple(x.shape), offset))
        return rope_rotate(x, offset, base)

    def counting_apply(x, positions, base=10000.0, neg=False):
        calls.append(("apply_rotary", neg))
        return apply_rotary(x, positions, base, neg)
    monkeypatch.setattr(fa, "rope_rotate", counting_rope)
    monkeypatch.setattr(fa, "apply_rotary", counting_apply)
    rng = np.random.RandomState(13)
    q, w = (rng.randn(B, L, H, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, L, G, D).astype(np.float32) for _ in range(2))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=True, rotary_base=ROPE)
    forward = list(calls)
    calls.clear()
    (out * torch.from_numpy(w)).sum().backward()
    assert forward == [("rope_rotate", (B, H, L, D), (0,)),
                       ("apply_rotary", False),
                       ("rope_rotate", (B, G, L, D), (0,)),
                       ("apply_rotary", False)]
    assert calls == [("apply_rotary", True)] * 2  # dQ's and dK's
    assert all(t.grad is not None for t in (tq, tk, tv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rotary_flash_attention_saves_the_rotated_copies(dtype):
    """Under rotary, flash_attention's autograd saves five tensors of the
    same shapes and bytes as without rotary, q and k replaced by their
    rotated copies (``apply_rotary`` at 0..L-1, in the inputs' dtype): the
    backward reads those and rotates nothing again."""
    B, L, H, G, D = 2, 80, 6, 2, 32
    rng = np.random.RandomState(14)
    q = torch.from_numpy(rng.randn(B, L, H, D).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.randn(B, L, G, D).astype(np.float32)
                             ).to(dtype) for _ in range(2))

    def saved(rotary_base):
        packed = []

        def pack(t):
            packed.append(t.detach().clone())
            return t
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fa.flash_attention(*leaves, causal=True, rotary_base=rotary_base)
        return packed

    plain, rotated = saved(None), saved(ROPE)
    assert len(plain) == len(rotated) == 5
    for a, b in zip(plain, rotated):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.numel() * a.element_size() == b.numel() * b.element_size()
    pos = torch.arange(L)
    for x, got, unrotated in ((q, rotated[0], plain[0]),
                              (k, rotated[1], plain[1])):
        assert torch.equal(unrotated, x.transpose(1, 2))
        assert torch.equal(got, fa.apply_rotary(x.transpose(1, 2), pos,
                                                ROPE))
    assert torch.equal(rotated[2], v.transpose(1, 2))


@pytest.mark.parametrize("L,causal,dtype", [(96, True, torch.float32),
                                            (77, False, torch.float32),
                                            (130, True, torch.bfloat16)])
def test_rotary_flash_fwd_is_flash_fwd_on_rotated_operands(L, causal,
                                                           dtype):
    """``flash_fwd`` with a rotary base equals ``flash_fwd`` without one on
    q and k rotated by ``rope_rotate``, bit for bit: the card's K1_rot is
    the pass, then K1 on the copies."""
    q, k, v, _ = _inputs(1, 4, 2, L, 64, seed=15)
    tq, tk, tv = (t.to(dtype) for t in _t(q, k, v))
    scale = 64 ** -0.5
    out_r, lse_r = fa.flash_fwd(tq, tk, tv, scale, causal, ROPE)
    out, lse = fa.flash_fwd(fa.rope_rotate(tq, (0,), ROPE),
                            fa.rope_rotate(tk, (0,), ROPE), tv, scale,
                            causal)
    assert torch.equal(out_r, out) and torch.equal(lse_r, lse)
    plain, _ = fa.flash_fwd(tq, tk, tv, scale, causal)
    assert not torch.equal(plain, out_r)


# (label, shard offsets, L): one chunk at 0; one rank holding the whole
# sequence as its two zigzag chunks, the (0, 4096) of the long-context ring
# at a small L; rank 0 of a 2-rank zigzag over 192 positions; one ragged
# chunk past 0; ragged zigzag chunks of 45
ROPE_SHARDS = [("contiguous", (0,), 96), ("one-rank-zigzag", (0, 48), 96),
               ("zigzag", (0, 144), 96), ("ragged", (300,), 77),
               ("ragged-zigzag", (45, 135), 90)]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("shard", ROPE_SHARDS, ids=lambda s: s[0])
def test_rope_rotate_matches_jax_apply_rotary(shard, D):
    """The rotary pass's plain version (its wrapper on CPU tensors) against
    JAX ``apply_rotary`` at JAX ``shard_positions``, on [B, heads, L, D]
    views of the model's [B, L, heads, D] activations."""
    from horovod_tpu.ops.flash_attention import \
        shard_positions as jax_shard_positions
    _, offset, L = shard
    rng = np.random.RandomState(21)
    x = rng.randn(2, L, 3, D).astype(np.float32)
    off = offset[0] if len(offset) == 1 else np.asarray(offset, np.int32)
    pos = np.asarray(jax_shard_positions(off, L))
    np.testing.assert_array_equal(fa.shard_positions(offset, L).numpy(), pos)
    xt = np.transpose(x, (0, 2, 1, 3))
    ref = jax_apply_rotary(jnp.asarray(xt), jnp.asarray(pos)[None, None],
                           ROPE)
    got = fa.rope_rotate(torch.from_numpy(x).transpose(1, 2), offset, ROPE)
    assert got.shape == xt.shape
    # cos/sin of the same f32 angles from two libraries (as in
    # test_apply_rotary_matches_jax)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("L,causal", [(200, True), (136, False)])
def test_backward_on_rotated_operands_is_the_rotary_backward(L, causal):
    """What the card's rotary backward does: q and k rotated once by the
    rotary pass, K2 and K3 without rotary on them, dQ and dK counter-rotated
    (the epilogue of K2_rot and K3_rot). In plain versions, on the CPU, it
    equals the rotary plain versions of K2 and K3 (the same f32 operations:
    1e-6) and JAX's Pallas K2 and K3 with ``rotary_base`` in interpret mode
    (BWD_TOL). GQA 3, D = 128, L not a multiple of 64 (JAX takes the whole
    sequence as one block)."""
    B, H, G, D = 1, 6, 2, 128
    q, k, v, g = _inputs(B, H, G, L, D, seed=22)
    scale = D ** -0.5
    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = fa.flash_forward_ref(tq, tk, tv, scale, causal, ROPE)
    delta = fa._delta(out, tg)
    qr, kr = fa.rope_rotate(tq, (0,), ROPE), fa.rope_rotate(tk, (0,), ROPE)
    pos = torch.arange(L)
    dq = fa.apply_rotary(fa.flash_bwd_dq_ref(qr, kr, tv, tg, lse, delta,
                                             scale, causal), pos, ROPE,
                         neg=True)
    dk, dv = fa.flash_bwd_dkv_ref(qr, kr, tv, tg, lse, delta, scale, causal)
    dk = fa.apply_rotary(dk, pos, ROPE, neg=True)
    want = (fa.flash_bwd_dq_ref(tq, tk, tv, tg, lse, delta, scale, causal,
                                ROPE),
            *fa.flash_bwd_dkv_ref(tq, tk, tv, tg, lse, delta, scale, causal,
                                  ROPE))
    with jax.default_matmul_precision("highest"):
        qj, kj, vj = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        blocks = dict(block_q=L * H // G, block_k=L)
        out_j, lse_j = _pallas_forward_lse(qj, kj, vj, scale, causal,
                                           interpret=True, rotary_base=ROPE,
                                           **blocks)
        grads_j = _pallas_backward(qj, kj, vj, out_j, lse_j, jnp.asarray(g),
                                   scale, causal, interpret=True,
                                   rotary_base=ROPE, **blocks)
    for name, a, b, c in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                             grads_j):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=BWD_TOL,
                                   atol=BWD_TOL, err_msg=name)


def test_rope_tables_match_jax():
    """The kernels' half-width tables against the JAX kernels' full-width
    ones (C = [cos | cos], S = [-sin | sin]), and the cache: one table per
    (D, base, device), kept for shorter requests and grown for longer
    ones."""
    from horovod_tpu.ops.flash_attention import _rope_tables
    c_j, s_j = _rope_tables(jnp.arange(600, dtype=jnp.int32), 64, ROPE)
    cpu = torch.device("cpu")
    fa._rope.clear()
    t = fa.rope_tables(300, 64, ROPE, cpu)
    assert t.shape == (2, 512, 32) and t.dtype == torch.float32
    np.testing.assert_allclose(t[0].numpy(), np.asarray(c_j)[:512, :32],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(s_j)[:512, 32:],
                               rtol=1e-5, atol=1e-5)
    assert fa.rope_tables(300, 64, ROPE, cpu) is t
    assert fa.rope_tables(17, 64, ROPE, cpu) is t
    grown = fa.rope_tables(600, 64, ROPE, cpu)
    assert grown.shape == (2, 1024, 32)
    assert torch.equal(grown[:, :512], t)
    assert fa.rope_tables(300, 64, ROPE, cpu) is grown
    assert fa.rope_tables(300, 32, ROPE, cpu).shape == (2, 512, 16)
    assert len(fa._rope) == 2


@pytest.mark.parametrize("rotary_base", [None, 10000.0])
def test_blockwise_reference_matches_jax(rotary_base):
    """L=160: a 128-row block and a 32-row tail; GQA 4 over 2."""
    B, H, G, L, D = 1, 4, 2, 160, 16
    q, k, v, _ = _inputs(B, H, G, L, D, seed=4)
    with jax.default_matmul_precision("highest"):
        ref = _blockwise_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), D ** -0.5, True,
                                   rotary_base)
    out = fa.blockwise_reference(*_t(q, k, v), D ** -0.5, True, rotary_base)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("neg", [False, True])
def test_apply_rotary_matches_jax(neg):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 24, 3, 16).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)[None, :, None]
    ref = jax_apply_rotary(jnp.asarray(x), jnp.asarray(pos), neg=neg)
    out = fa.apply_rotary(torch.from_numpy(x), torch.from_numpy(pos),
                          neg=neg)
    # cos/sin of the same f32 angles from two libraries.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_analytic_flops_match_jax():
    from horovod_tpu.ops.flash_attention import analytic_attention_flops
    for causal in (True, False):
        for training in (True, False):
            args = (8, 12, 2048, 64)
            assert fa.analytic_attention_flops(
                *args, causal=causal, training=training) == \
                analytic_attention_flops(*args, causal=causal,
                                         training=training)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    fa.reset_launch_counts()
    q, k, v, g = _t(*_inputs(1, 2, 2, 64, 16, seed=6))
    out, lse = fa.flash_fwd(q, k, v, 0.25, True)
    ref_out, ref_lse = fa.flash_forward_ref(q, k, v, 0.25, True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    delta = fa._delta(out, g)
    assert torch.equal(fa.flash_bwd_dq(q, k, v, g, lse, delta, 0.25, True),
                       fa.flash_bwd_dq_ref(q, k, v, g, lse, delta, 0.25,
                                           True))
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, 0.25, True)
    rk, rv = fa.flash_bwd_dkv_ref(q, k, v, g, lse, delta, 0.25, True)
    assert torch.equal(dk, rk) and torch.equal(dv, rv)
    fa.flash_fwd(q, k, v, 0.25, True, rotary_base=10000.0)
    fa.flash_backward(q, k, v, out, lse, g, 0.25, True, rotary_base=10000.0)
    assert torch.equal(fa.rope_rotate(q, (0,), 10000.0),
                       fa.apply_rotary(q, torch.arange(64), 10000.0))
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_ring_step",
             "flash_ring_bwd_dq", "flash_ring_bwd_dkv")
    assert fa.launch_counts() == dict(
        {n + rot: 0 for n in names for rot in ("", "_rot")}, rope_rotate=0)


def test_other_devices_raise():
    q = torch.empty(1, 2, 64, 16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fa.flash_fwd(q, q, q, 0.25, True)


def test_kernel_argument_checks():
    """The checks the CUDA wrappers run before a launch, on CPU tensors."""
    def bhld(B, H, L, D, dtype=torch.bfloat16):
        return torch.zeros(B, L, H, D, dtype=dtype).transpose(1, 2)

    q, k = bhld(2, 4, 100, 64), bhld(2, 2, 100, 64)
    assert fa._check("t", q, k, {"q": q, "k": k}) == (2, 4, 2, 100, 64)
    with pytest.raises(ValueError, match="head dim"):
        fa._check("t", bhld(1, 2, 8, 48), bhld(1, 2, 8, 48), {})
    with pytest.raises(ValueError, match="divide"):
        fa._check("t", bhld(1, 3, 8, 64), bhld(1, 2, 8, 64), {})
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        f16 = bhld(1, 2, 8, 64, torch.float16)
        fa._check("t", f16, f16, {})
    with pytest.raises(ValueError, match="v is torch.float32"):
        fa._check("t", q, k, {"v": bhld(2, 2, 100, 64, torch.float32)})
    odd = torch.zeros(2, 4, 100, 66, dtype=torch.bfloat16)[..., :64]
    assert not fa._layout_ok(odd)
    with pytest.raises(ValueError, match="strides"):
        fa._check("t", odd, k, {"q": odd})
    assert fa._layout_ok(fa._kernel_layout(odd))
    lse = torch.zeros(2, 4, 100)
    fa._check("t", q, k, {}, (("lse", lse),))
    with pytest.raises(ValueError, match="lse"):
        fa._check("t", q, k, {}, (("lse", lse[:, :, :50]),))


def _bhld(B, H, L, D):
    """A [B, H, L, D] bf16 view of [B, L, H, D] memory, as the model's."""
    return torch.zeros(B, L, H, D, dtype=torch.bfloat16).transpose(1, 2)


@pytest.mark.parametrize("case", ["model_layout", "contiguous", "gqa_kv",
                                  "head_dim_128", "refused"])
def test_tensor_map_layouts(case):
    """The TMA tensor maps of the forward kernels (K1, K4), computed in
    Python: dims (D, L, heads, B), byte strides of L, heads and B, and the
    box; a layout TMA cannot read in place raises."""
    if case == "model_layout":
        # [B, L, H, D] activations seen as [B, H, L, D]: row stride H * D
        t = _bhld(2, 12, 100, 64)
        assert fa.tensor_map(t) == ((64, 100, 12, 2),
                                    (12 * 64 * 2, 64 * 2, 100 * 12 * 64 * 2),
                                    (64, 128, 1, 1))
    elif case == "contiguous":
        t = torch.zeros(3, 4, 257, 32, dtype=torch.bfloat16)
        assert fa.tensor_map(t) == ((32, 257, 4, 3),
                                    (64, 257 * 64, 4 * 257 * 64),
                                    (32, 128, 1, 1))
    elif case == "gqa_kv":
        # k and v carry G = 2 of H = 8 heads: their own map over G heads
        q, k = _bhld(1, 8, 300, 64), _bhld(1, 2, 300, 64)
        assert fa.tensor_map(q, fa.TMA_Q_BOX_ROWS) == (
            (64, 300, 8, 1), (8 * 64 * 2, 64 * 2, 300 * 8 * 64 * 2),
            (64, 64, 1, 1))
        assert fa.tensor_map(k) == ((64, 300, 2, 1),
                                    (2 * 64 * 2, 64 * 2, 300 * 2 * 64 * 2),
                                    (64, 128, 1, 1))
    elif case == "head_dim_128":
        # two boxes of 64 columns a tile; a size-1 dim's stride is never
        # stepped over and is rounded up to 16 bytes
        t = torch.zeros(1, 1, 1, 132, dtype=torch.bfloat16)[..., :128]
        assert fa.tensor_map(t) == ((128, 1, 1, 1), (272, 272, 272),
                                    (64, 128, 1, 1))
    else:
        odd = torch.zeros(1, 100, 2, 66, dtype=torch.bfloat16)[..., :64]
        with pytest.raises(ValueError, match="multiple of 16"):
            fa.tensor_map(odd.transpose(1, 2))
        flat = torch.zeros(2 * 64 * 64 + 8, dtype=torch.bfloat16)
        shifted = flat[1:1 + 2 * 64 * 64].view(1, 2, 64, 64)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.tensor_map(shifted)
        with pytest.raises(ValueError, match="bf16"):
            fa.tensor_map(torch.zeros(1, 2, 64, 64))
        with pytest.raises(ValueError, match="contiguous last dim"):
            fa.tensor_map(_bhld(1, 2, 64, 64).transpose(2, 3))


def _autograd_dout(case, B, H, L, D):
    """dO as autograd hands it to _FlashFn.backward: the gradient of the
    [B, H, L, D] output that the public function transposes back to
    [B, L, H, D], after the wrapper's ``_kernel_layout`` and ``_bf16``."""
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    o = torch.zeros(B, H, L, D, dtype=dtype, requires_grad=True)
    got = []
    o.register_hook(got.append)
    out = o.transpose(1, 2)
    if case == "sum":
        out.sum().backward()        # a stride-0 (expanded) gradient
    else:
        (out * torch.ones(B, L, H, D, dtype=dtype)).sum().backward()
    g = fa._kernel_layout(got[0])
    return fa._bf16(g)[0]


@pytest.mark.parametrize("case", ["model_layout", "sum", "float32",
                                  "head_dim_128", "gqa_head_dim_32"])
def test_backward_tensor_maps_on_autograd_layouts(case):
    """The TMA maps of K2 and K3 (q, k, v, dout; 11 values each) on the
    layouts the backward receives: q, k, v as the model's transposed
    [B, L, heads, D] activations, dO from autograd. K2's q and dout boxes
    and K3's k and v boxes are 64 rows (one consumer warpgroup's); the
    streamed tiles are 64 rows, K3's q tiles 32 at a head dim of 128."""
    B, L = 2, 100
    H, G, D = {"head_dim_128": (4, 4, 128),
               "gqa_head_dim_32": (8, 2, 32)}.get(case, (12, 12, 64))
    q = _bhld(B, H, L, D)
    k, v = _bhld(B, G, L, D), _bhld(B, G, L, D)
    dout = _autograd_dout(case, B, H, L, D)
    assert dout.dtype == torch.bfloat16 and dout.stride(-1) == 1
    if case == "sum":
        assert dout.is_contiguous()   # the expanded gradient was copied
    else:
        assert dout.stride() == q.stride()  # read in place, no copy

    def layout(t, heads, rows):
        return [D, L, heads, B, *(s * 2 for s in t.stride()[2::-1]),
                min(D, 64), rows, 1, 1]

    for dkv in (False, True):
        q_rows, kv_rows = fa.bwd_box_rows(dkv, D)
        assert (q_rows, kv_rows) == (
            (32 if D == 128 else 64, 64) if dkv else (64, 64))
        want = (layout(q, H, q_rows) + layout(k, G, kv_rows) +
                layout(v, G, kv_rows) + layout(dout, H, q_rows))
        assert list(fa._bwd_maps(q, k, v, dout, dkv)) == want
    # dims, then the byte strides of L, heads and B of the model layout
    assert layout(q, H, 64)[4:7] == [H * D * 2, D * 2, L * H * D * 2]


@pytest.mark.parametrize("case", ["lq_ne_lk", "gqa", "head_dim_128",
                                  "float32"])
def test_backward_tensor_maps_on_ring_layouts(case):
    """The TMA maps of the ring's backward steps K5 (K2's boxes) and K6
    (K3's) on the shards the ring hands them: q and dout over Lq rows and
    k, v over Lk, each with its own map (Lq != Lk), GQA k/v at G heads,
    K6's 32-row q boxes at a head dim of 128, and a float32 q and dout
    rounded to bf16 by ``_bf16`` before the maps (TMA copies bytes and
    cannot round)."""
    B, Lq, Lk = 2, 100, 72
    H, G, D = {"gqa": (8, 2, 64), "head_dim_128": (4, 4, 128)}.get(
        case, (4, 4, 64))
    if case == "float32":
        q, dout = (torch.zeros(B, Lq, H, D).transpose(1, 2)
                   for _ in range(2))
        with pytest.raises(ValueError, match="bf16"):
            fa._bwd_maps(q, _bhld(B, G, Lk, D), _bhld(B, G, Lk, D), dout,
                         False)
    else:
        q, dout = _bhld(B, H, Lq, D), _bhld(B, H, Lq, D)
    k, v = _bhld(B, G, Lk, D), _bhld(B, G, Lk, D)
    qkvd = fa._bf16(q, k, v, dout)
    assert all(t.dtype == torch.bfloat16 for t in qkvd)
    assert (qkvd[1] is k) and (qkvd[2] is v)
    if case == "float32":
        # the cast keeps the model's layout; the maps read it in place
        assert qkvd[0].stride() == q.stride()
        assert qkvd[3].stride() == dout.stride()
    else:
        assert qkvd[0] is q and qkvd[3] is dout

    def layout(t, rows):
        B_, heads, L, D_ = t.shape
        return [D_, L, heads, B_, *(s * 2 for s in t.stride()[2::-1]),
                min(D_, 64), rows, 1, 1]

    for dkv in (False, True):
        q_rows, kv_rows = fa.bwd_box_rows(dkv, D)
        if dkv and D == 128:
            assert q_rows == 32
        want = (layout(qkvd[0], q_rows) + layout(k, kv_rows) +
                layout(v, kv_rows) + layout(qkvd[3], q_rows))
        assert list(fa._bwd_maps(*qkvd, dkv)) == want
        assert want[1] == Lq and want[12] == Lk
        assert want[2] == H and want[13] == G


_C_TYPES = {"float": ctypes.c_float, "int": ctypes.c_int}


@pytest.mark.parametrize("name", sorted(fa._ENTRIES))
def test_every_entry_names_a_source_that_defines_it(name):
    """Each C entry point the wrappers bind lies in a source that
    ``_build.SOURCES`` builds, and the ctypes argument types follow its
    parameters: a pointer as c_void_p, an int as c_int, a float as
    c_float."""
    source, args = fa._ENTRIES[name]
    assert source in _build.SOURCES
    text = (_build.CSRC / (source + ".cu")).read_text()
    found = re.findall(r'extern "C" int %s\(([^)]*)\)' % name, text)
    assert len(found) == 1, (name, source)
    params = [" ".join(p.split()) for p in found[0].split(",")]
    want = [ctypes.c_void_p if "*" in p else _C_TYPES[p.split()[-2]]
            for p in params]
    assert args == want, (name, params)
