"""The port's kernels against their plain versions on a GPU.

Marked ``cuda``: they need a card and nvcc, and skip without them. They
import no JAX, so they also run where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

chip_smoke.py covers the training shapes; these cover, for the flash
kernels, the other head dims, float32 inputs, GQA, MQA, ragged lengths
(one short of and one past the forward's 128-row tiles and the backward's
32-, 64- and 192-row tiles), a strided dout view, zigzag chunks that a
tile straddles, grids of many blocks at small sizes, and fused rotary in
K1-K6 (every head dim, ragged lengths, GQA, zigzag chunks) with the rotary
pass that the backward kernels read (bit for bit its plain version), and
for the BN
statistics kernels ragged M and C, both dtypes, mixed dy and x, ghost
groups and the ReLU mask, layouts they refuse, and run-to-run determinism,
and for the normalize and dx passes the same shapes in both arithmetic
modes, with and without the ReLU and ghost groups, bit for bit their plain
versions, and the lean BN's autograd on the card; and the wire codec
kernels bit for bit their plain versions (ragged block counts, NaN,
infinities, zeros, ties, denormals), with the ring schedules over 4
virtual ranks.
"""

import sys

import pytest
import torch

import horovod_tpu_torch.ops.flash_attention  # noqa: F401
from horovod_tpu_torch.ops import batch_norm as bn

fa = sys.modules["horovod_tpu_torch.ops.flash_attention"]

pytestmark = pytest.mark.cuda

# The kernels round the products' inputs (P and dS too) to bf16 and
# accumulate in f32, so against the f32 plain version on the same values
# ||kernel - plain||_2 / ||plain||_2 is a few 1e-3; lse stays f32 through.
REL_TOL = 1e-2
LSE_TOL = 1e-3
# The BN statistics kernels and their plain versions both sum the same f32
# values, in another order: ||kernel - plain||_2 / ||plain||_2 of each
# output row is about 1e-7 to 1e-6 (chip_smoke.py uses the same limit).
BN_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    """||a - b||_2 / ||b||_2"""
    return ((a.float() - b.float()).norm() /
            b.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("B,H,G,L,D,causal,dtype", [
    (2, 4, 4, 256, 64, True, torch.bfloat16),
    (1, 4, 1, 200, 32, True, torch.bfloat16),     # MQA, ragged L
    (1, 6, 2, 97, 128, False, torch.bfloat16),    # GQA 3, ragged L
    (2, 2, 2, 130, 64, True, torch.float32),
    # 3 rows, one ragged tile (a single row would have dQ = 0 exactly)
    (1, 2, 2, 3, 64, True, torch.bfloat16),
    (1, 4, 2, 300, 128, True, torch.bfloat16),    # D = 128, GQA, causal
    (50, 4, 2, 160, 64, True, torch.bfloat16),    # B * H = 200 blocks
])
def test_kernels_match_plain_versions(cuda, B, H, G, L, D, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, dout = (torch.randn(B, H, L, D, generator=g, device=cuda
                           ).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, G, L, D, generator=g, device=cuda
                        ).to(dtype) for _ in range(2))
    scale = D ** -0.5
    # float32 inputs are rounded to bf16 for the products: the function
    # the kernels compute is the plain version on the rounded values.
    f32 = [t.to(torch.bfloat16).float() for t in (q, k, v, dout)]
    out_ref, lse_ref = fa.flash_forward_ref(*f32[:3], scale, causal)
    delta = fa._delta(out_ref, f32[3])
    dq_ref = fa.flash_bwd_dq_ref(*f32, lse_ref, delta, scale, causal)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(*f32, lse_ref, delta, scale,
                                          causal)

    before = fa.launch_counts()
    out, lse = fa.flash_fwd(q, k, v, scale, causal)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert after["flash_fwd"] == before["flash_fwd"] + 1
    assert out.dtype == dtype and (lse - lse_ref).abs().max() <= LSE_TOL
    assert _rel(out, out_ref) <= REL_TOL
    # K2 and K3 on the plain lse and delta, then chained on K1's own.
    for lse_in, delta_in in ((lse_ref, delta), (lse, fa._delta(out, dout))):
        dq = fa.flash_bwd_dq(q, k, v, dout, lse_in, delta_in, scale, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse_in, delta_in, scale,
                                  causal)
        torch.cuda.synchronize()
        assert dk.shape == (B, G, L, D)
        for name, a, b in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                           ("dv", dv, dv_ref)):
            assert _rel(a, b) <= REL_TOL, (name, _rel(a, b))
    after = fa.launch_counts()
    assert all(after[n] == before[n] + (1 if n == "flash_fwd" else 2)
               for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))


@pytest.mark.parametrize("L", [1, 127, 129, 255])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_lengths_around_the_tile(cuda, L, causal):
    """K1 one row short of and one past its 128-row tiles (and L = 1), in
    the model's [B, L, H, D] layout."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(2, L, 4, 64, generator=g, device=cuda).to(
        torch.bfloat16).transpose(1, 2) for _ in range(3))
    out, lse = fa.flash_fwd(q, k, v, 0.125, causal)
    torch.cuda.synchronize()
    out_ref, lse_ref = fa.flash_forward_ref(q.float(), k.float(), v.float(),
                                            0.125, causal)
    assert out.shape == (2, 4, L, 64) and lse.shape == (2, 4, L)
    assert _rel(out, out_ref) <= REL_TOL
    assert (lse - lse_ref).abs().max() <= LSE_TOL


def _bwd_case(cuda, B, H, G, L, D, causal, dtype, seed, dout_view=False):
    """K2 and K3 on the model's [B, L, heads, D] layout (dout a strided
    view of a wider tensor when ``dout_view``) against their plain versions
    on the bf16-rounded values; returns the three norm-relative errors."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(heads, width=D):
        return torch.randn(B, L, heads, width, generator=g, device=cuda
                           ).to(dtype).transpose(1, 2)
    q, k, v = rnd(H), rnd(G), rnd(G)
    dout = rnd(H, D + 8)[..., :D] if dout_view else rnd(H)
    scale = D ** -0.5
    f32 = [t.to(torch.bfloat16).float() for t in (q, k, v, dout)]
    out_ref, lse = fa.flash_forward_ref(*f32[:3], scale, causal)
    delta = fa._delta(out_ref, f32[3])
    dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    assert dq.shape == (B, H, L, D) and dk.shape == dv.shape == (B, G, L, D)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(*f32, lse, delta, scale, causal)
    return (_rel(dq, fa.flash_bwd_dq_ref(*f32, lse, delta, scale, causal)),
            _rel(dk, dk_ref), _rel(dv, dv_ref))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("case", ["gqa", "float32", "dout_view"])
def test_flash_bwd_kernels_at_every_head_dim(cuda, case, D, causal):
    """K2 and K3 at each head dim, causal and full: GQA (6 query heads on
    2 kv heads), float32 inputs (rounded to bf16 for the TMA loads, the
    outputs float32), and dout a strided view (row stride D + 8) that TMA
    reads in place. L = 300: K2's 192- or 128-row blocks and 64-key tiles,
    K3's 128-key blocks and 64- or 32-row q tiles, each with a ragged end."""
    before = fa.launch_counts()
    errs = _bwd_case(cuda, 2, 6, 2 if case == "gqa" else 6, 300, D, causal,
                     torch.float32 if case == "float32" else torch.bfloat16,
                     seed=7, dout_view=case == "dout_view")
    assert max(errs) <= REL_TOL, errs
    after = fa.launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1


@pytest.mark.parametrize("L", [31, 33, 63, 65, 191, 193])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_lengths_around_the_tile(cuda, L, causal, D):
    """K2 and K3 one row short of and one past their tiles: K3's 32-row q
    tiles (D = 128), the 64-row tiles and warpgroups, and K2's 192-row
    blocks (D = 64), with GQA."""
    errs = _bwd_case(cuda, 2, 4, 2, L, D, causal, torch.bfloat16, seed=8)
    assert max(errs) <= REL_TOL, errs


def test_flash_attention_autograd_on_the_gpu(cuda):
    """The public function and _FlashFn on CUDA tensors against the
    blockwise plain version's autograd."""
    B, L, H, G, D = 2, 192, 4, 2, 64
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(B, L, H, D, generator=g, device=cuda,
                    dtype=torch.bfloat16, requires_grad=True)
    k, v = (torch.randn(B, L, G, D, generator=g, device=cuda,
                        dtype=torch.bfloat16, requires_grad=True)
            for _ in range(2))
    w = torch.randn(B, L, H, D, generator=g, device=cuda)
    out = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad((out.float() * w).sum(), (q, k, v))

    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = fa.blockwise_reference(*(t.transpose(1, 2) for t in leaves),
                                 D ** -0.5, True).transpose(1, 2)
    refs = torch.autograd.grad((ref * w).sum(), leaves)
    assert _rel(out, ref) <= REL_TOL
    for a, b in zip(grads, refs):
        assert _rel(a, b) <= REL_TOL


def test_bad_layouts_raise_before_launch(cuda):
    q = torch.zeros(1, 2, 64, 66, device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="strides"):
        fa.flash_fwd(q, q, q, 0.125, True)
    h = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_fwd(h, h, h, 0.125, True)


ROPE = 10000.0


@pytest.mark.parametrize("B,H,G,L,D,causal,dtype", [
    (2, 4, 4, 256, 64, True, torch.bfloat16),
    (1, 6, 2, 300, 128, True, torch.bfloat16),    # GQA 3, ragged L
    (1, 6, 2, 97, 128, False, torch.bfloat16),
    (1, 4, 1, 200, 32, True, torch.bfloat16),     # MQA, ragged L
    (2, 2, 2, 130, 64, False, torch.float32),
    (1, 2, 2, 3, 64, True, torch.bfloat16),
    (1, 4, 2, 1100, 128, True, torch.bfloat16),   # angles past 1000 rad
])
def test_rotary_kernels_match_plain_versions(cuda, B, H, G, L, D, causal,
                                             dtype):
    """K1, K2 and K3 with fused rotary against their plain versions (q and
    k rotated at 0..L-1, dQ and dK counter-rotated) on the same values;
    K2 and K3 on the plain lse and delta, then chained on K1's own."""
    g = torch.Generator(device=cuda).manual_seed(11)

    def rnd(heads):
        return torch.randn(B, L, heads, D, generator=g, device=cuda
                           ).to(dtype).transpose(1, 2)
    q, k, v, dout = rnd(H), rnd(G), rnd(G), rnd(H)
    scale = D ** -0.5
    # The plain versions on the bf16 values the kernels load: they rotate
    # in f32 and round the rotated q and k to bf16, as the kernels do.
    bf = [t.to(torch.bfloat16) for t in (q, k, v, dout)]
    out_ref, lse_ref = fa.flash_forward_ref(*bf[:3], scale, causal, ROPE)
    delta = fa._delta(out_ref, bf[3])
    dq_ref = fa.flash_bwd_dq_ref(*bf, lse_ref, delta, scale, causal, ROPE)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(*bf, lse_ref, delta, scale,
                                          causal, ROPE)
    # the rotation matters: without it the function differs
    plain_out, _ = fa.flash_forward_ref(*bf[:3], scale, causal)
    assert L < 8 or _rel(plain_out, out_ref) > 10 * REL_TOL

    before = fa.launch_counts()
    out, lse = fa.flash_fwd(q, k, v, scale, causal, ROPE)
    torch.cuda.synchronize()
    assert out.dtype == dtype and (lse - lse_ref).abs().max() <= LSE_TOL
    assert _rel(out, out_ref) <= REL_TOL, _rel(out, out_ref)
    for lse_in, delta_in in ((lse_ref, delta), (lse, fa._delta(out, dout))):
        dq = fa.flash_bwd_dq(q, k, v, dout, lse_in, delta_in, scale, causal,
                             ROPE)
        dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse_in, delta_in, scale,
                                  causal, ROPE)
        torch.cuda.synchronize()
        for name, a, b in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                           ("dv", dv, dv_ref)):
            assert a.dtype == dtype and _rel(a, b) <= REL_TOL, (
                name, _rel(a, b))
    after = fa.launch_counts()
    assert all(after[n + "_rot"] == before[n + "_rot"] +
               (1 if n == "flash_fwd" else 2) and after[n] == before[n]
               for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    # called alone, each wrapper rotates its own q and k: K1_rot once, K2_rot
    # and K3_rot twice each
    assert after["rope_rotate"] == before["rope_rotate"] + 2 * 5


@pytest.mark.parametrize("shape,offset", [
    ((2, 6, 8192, 128), (0,)),             # the lc launch's q
    ((2, 6, 8192, 128), (4096, 12288)),    # a 2-rank zigzag shard of it
    ((2, 2, 8192, 128), (0,)),             # the lc launch's k
    ((1, 6, 333, 128), (0,)),              # ragged L
    ((1, 6, 333, 128), (5000,)),           # ragged L, one chunk past 0
    ((1, 6, 334, 128), (167, 501)),        # ragged zigzag chunks
    ((3, 4, 100, 64), (40, 200)),
    ((2, 1, 72, 32), (0,)),
])
@pytest.mark.parametrize("layout", ["model", "contiguous"])
def test_rope_rotate_equals_plain_bit_for_bit(cuda, shape, offset, layout):
    """The rotary pass against ``apply_rotary`` at the shard's positions on
    the same bf16 values: every element equal (both round each product and
    the sum apart and the result once). ``model``: a [B, heads, L, D] view
    of [B, L, heads, D] activations; ``contiguous``: [B, heads, L, D]."""
    B, heads, L, D = shape
    g = torch.Generator(device=cuda).manual_seed(31)
    if layout == "model":
        x = torch.randn(B, L, heads, D, generator=g, device=cuda).to(
            torch.bfloat16).transpose(1, 2)
    else:
        x = torch.randn(B, heads, L, D, generator=g, device=cuda).to(
            torch.bfloat16)
    before = fa.launch_counts()["rope_rotate"]
    got = fa.rope_rotate(x, offset, ROPE)
    want = fa.apply_rotary(x, fa.shard_positions(offset, L, cuda), ROPE)
    torch.cuda.synchronize()
    assert fa.launch_counts()["rope_rotate"] == before + 1
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    assert not torch.equal(got, x)


def test_rope_rotate_takes_float32_and_refuses_what_it_cannot(cuda):
    """float32 in: rotated as its bf16 rounding, returned as float32;
    float16, a head dim of 48 and a strided last dim raise."""
    x = torch.randn(1, 2, 40, 64, device=cuda)
    got = fa.rope_rotate(x, (0,), ROPE)
    bf = x.to(torch.bfloat16)
    want = fa.apply_rotary(bf, torch.arange(40, device=cuda), ROPE)
    assert got.dtype == torch.float32 and torch.equal(got, want.float())
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.rope_rotate(x.half(), (0,), ROPE)
    with pytest.raises(ValueError, match="head dim"):
        fa.rope_rotate(x[..., :48].contiguous(), (0,), ROPE)
    with pytest.raises(ValueError, match="strides"):
        fa.rope_rotate(bf[..., ::2], (0,), ROPE)


@pytest.mark.parametrize("B,H,G,L,D", [
    (2, 6, 2, 1000, 128),    # GQA 3, L not a multiple of any tile
    (1, 4, 4, 256, 64),
    (2, 4, 1, 130, 32),      # MQA
])
def test_rotary_backward_rotates_once(cuda, B, H, G, L, D):
    """flash_backward with rotary (the model's backward): one rotary pass
    over q and one over k, then K2_rot and K3_rot on the copies, against
    the rotary plain versions on the same bf16 values, on K1_rot's own
    out and lse."""
    g = torch.Generator(device=cuda).manual_seed(32)

    def rnd(heads):
        return torch.randn(B, L, heads, D, generator=g, device=cuda
                           ).to(torch.bfloat16).transpose(1, 2)
    q, k, v, dout = rnd(H), rnd(G), rnd(G), rnd(H)
    scale = D ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale, True, ROPE)
    delta = fa._delta(out, dout)
    refs = (fa.flash_bwd_dq_ref(q, k, v, dout, lse, delta, scale, True,
                                ROPE),
            *fa.flash_bwd_dkv_ref(q, k, v, dout, lse, delta, scale, True,
                                  ROPE))
    before = fa.launch_counts()
    grads = fa.flash_backward(q, k, v, out, lse, dout, scale, True, ROPE)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]
            } == {"rope_rotate": 2, "flash_bwd_dq_rot": 1,
                  "flash_bwd_dkv_rot": 1}
    for name, a, b in zip(("dq", "dk", "dv"), grads, refs):
        assert a.dtype == torch.bfloat16 and _rel(a, b) <= REL_TOL, (
            name, _rel(a, b))


@pytest.mark.parametrize("B,L,H,G,D,causal,dtype", [
    (2, 300, 6, 2, 128, True, torch.bfloat16),    # GQA 3, ragged L
    (1, 130, 4, 4, 64, False, torch.bfloat16),
    (2, 97, 4, 1, 32, True, torch.float32),       # MQA, float32
])
def test_rotary_flash_attention_rotates_once_in_the_forward_on_the_gpu(
        cuda, B, L, H, G, D, causal, dtype):
    """flash_attention(rotary_base=) forward and backward against the
    rotary plain versions on the same bf16 values. The forward launches the
    pass over q and over k and then K1 on the copies (out bit for bit
    ``flash_fwd`` with the base); autograd keeps the copies (five saved
    tensors, as many bytes as without rotary), and the backward launches
    K2_rot and K3_rot on them and no pass."""
    g = torch.Generator(device=cuda).manual_seed(33)

    def rnd(heads):
        return torch.randn(B, L, heads, D, generator=g, device=cuda
                           ).to(dtype)
    q, k, v, dout = rnd(H), rnd(G), rnd(G), rnd(H)
    scale = D ** -0.5
    bf = [t.transpose(1, 2).to(torch.bfloat16) for t in (q, k, v, dout)]
    out_ref, lse_ref = fa.flash_forward_ref(*bf[:3], scale, causal, ROPE)
    refs = fa.flash_backward_ref(*bf[:3], out_ref, lse_ref, bf[3], scale,
                                 causal, ROPE)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    saved = []

    def pack(t):
        saved.append((t.shape, t.dtype, t.numel() * t.element_size()))
        return t
    before = fa.launch_counts()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fa.flash_attention(*leaves, causal=causal, rotary_base=ROPE)
    torch.cuda.synchronize()
    mid = fa.launch_counts()
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert {n: mid[n] - before[n] for n in mid if mid[n] != before[n]} == {
        "rope_rotate": 2, "flash_fwd_rot": 1}
    assert {n: after[n] - mid[n] for n in after if after[n] != mid[n]} == {
        "flash_bwd_dq_rot": 1, "flash_bwd_dkv_rot": 1}
    alone, _ = fa.flash_fwd(*(t.transpose(1, 2) for t in (q, k, v)), scale,
                            causal, ROPE)
    assert torch.equal(out.transpose(1, 2), alone)
    assert _rel(out.transpose(1, 2), out_ref) <= REL_TOL
    for name, a, b in zip(("dq", "dk", "dv"), grads, refs):
        err = _rel(a.transpose(1, 2), b)
        assert a.dtype == dtype and err <= REL_TOL, (name, err)
    plain = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: plain.append((t.shape, t.dtype, t.numel() *
                                    t.element_size())) or t, lambda t: t):
        fa.flash_attention(*leaves, causal=causal)
    assert len(saved) == 5 and saved == plain


def test_rotary_flash_attention_autograd_on_the_gpu(cuda):
    """flash_attention(rotary_base=) and its autograd against the blockwise
    plain version's with the same rotary, GQA, D = 128."""
    B, L, H, G, D = 2, 320, 6, 2, 128
    g = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn(B, L, H, D, generator=g, device=cuda,
                    dtype=torch.bfloat16, requires_grad=True)
    k, v = (torch.randn(B, L, G, D, generator=g, device=cuda,
                        dtype=torch.bfloat16, requires_grad=True)
            for _ in range(2))
    w = torch.randn(B, L, H, D, generator=g, device=cuda)
    out = fa.flash_attention(q, k, v, causal=True, rotary_base=ROPE)
    grads = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = fa.blockwise_reference(*(t.transpose(1, 2) for t in leaves),
                                 D ** -0.5, True, ROPE).transpose(1, 2)
    refs = torch.autograd.grad((ref * w).sum(), leaves)
    assert _rel(out, ref) <= REL_TOL
    for a, b in zip(grads, refs):
        assert _rel(a, b) <= REL_TOL


def _ring_state(cuda, q, k, v, scale, seed):
    """A carried (o, m, l), nonzero in every row: the plain step of a full
    (non-causal) pass over another random k/v shard."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    k0, v0 = (torch.randn(k.shape, generator=g, device=cuda) for _ in range(2))
    B, H, Lq, D = q.shape
    fresh = (torch.zeros(B, H, Lq, D, device=cuda),
             torch.full((B, H, Lq), float("-inf"), device=cuda),
             torch.zeros(B, H, Lq, device=cuda))
    return fa.flash_ring_step_ref(q.float(), k0, v0, *fresh, (0,), (0,),
                                  scale, False)


def _m_err(a, b):
    """max |a - b| of two running maxima, -inf where both are -inf."""
    assert torch.equal(torch.isneginf(a), torch.isneginf(b))
    fin = ~torch.isneginf(b)
    return (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0


@pytest.mark.parametrize("B,H,G,Lq,Lk,D,q_off,kv_off,causal,dtype", [
    (2, 4, 4, 256, 256, 64, (256,), (0,), True, torch.bfloat16),  # past
    (2, 4, 4, 256, 256, 64, (0,), (0,), True, torch.bfloat16),    # diagonal
    (1, 4, 2, 160, 160, 64, (160,), (0,), False, torch.bfloat16),  # GQA
    (1, 4, 2, 160, 160, 64, (0,), (0,), True, torch.bfloat16),
    (1, 4, 1, 200, 136, 32, (136,), (64,), True, torch.bfloat16),  # MQA
    # zigzag chunks: n = 2, chunks of 256; rank 0's q, rank 1's k/v
    (1, 2, 2, 512, 512, 128, (0, 768), (256, 512), True, torch.bfloat16),
    (1, 2, 2, 512, 512, 64, (256, 512), (0, 768), True, torch.float32),
    # chunks of 48: tiles straddle the chunk boundary
    (1, 2, 2, 96, 96, 64, (0, 144), (48, 96), True, torch.bfloat16),
    # Lq != Lk, both ragged against K4's 128-row tiles: past, overlapping
    (1, 4, 2, 300, 200, 64, (200,), (0,), True, torch.bfloat16),
    (1, 4, 2, 300, 200, 64, (100,), (150,), True, torch.bfloat16),
    # zigzag chunks of 200 (n = 2, global 800): a 128-row tile straddles
    # the chunk boundary
    (1, 4, 2, 400, 400, 64, (0, 600), (200, 400), True, torch.bfloat16),
    (1, 4, 2, 400, 400, 64, (200, 400), (0, 600), True, torch.bfloat16),
    (1, 4, 2, 400, 400, 64, (0, 600), (0, 600), True, torch.bfloat16),
    # D = 128, GQA, zigzag chunks of 48: K6's 32-row q tiles and K5's
    # 64-row key tiles straddle the chunk boundary
    (1, 4, 2, 96, 96, 128, (0, 144), (48, 96), True, torch.bfloat16),
])
def test_ring_kernels_match_plain_versions(cuda, B, H, G, Lq, Lk, D, q_off,
                                           kv_off, causal, dtype):
    """K4 on a fresh and on a carried state, K5 and K6 on carried
    accumulators, each against its plain version on the same values."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, dout = (torch.randn(B, H, Lq, D, generator=g, device=cuda).to(dtype)
               for _ in range(2))
    k, v = (torch.randn(B, G, Lk, D, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    scale = D ** -0.5
    f32 = [t.to(torch.bfloat16).float() for t in (q, k, v, dout)]
    carried = _ring_state(cuda, f32[0], f32[1], f32[2], scale, seed=4)
    fresh = (torch.zeros(B, H, Lq, D, device=cuda),
             torch.full((B, H, Lq), float("-inf"), device=cuda),
             torch.zeros(B, H, Lq, device=cuda))
    before = fa.launch_counts()
    for state in (fresh, carried):
        ref = fa.flash_ring_step_ref(*f32[:3], *state, q_off, kv_off, scale,
                                     causal)
        got = fa.flash_ring_step(q, k, v, *(t.clone() for t in state), q_off,
                                 kv_off, scale, causal)
        torch.cuda.synchronize()
        assert _rel(got[0], ref[0]) <= REL_TOL
        assert _m_err(got[1], ref[1]) <= LSE_TOL
        assert _rel(got[2], ref[2]) <= REL_TOL

    # The backward steps on the lse of the carried state plus this step.
    o, m, l = fa.flash_ring_step_ref(*f32[:3], *carried, q_off, kv_off,
                                     scale, causal)
    lse = m + torch.log(l)
    delta = fa._delta(o / l[..., None], f32[3])
    dq0 = torch.randn(B, H, Lq, D, generator=g, device=cuda)
    dk0, dv0 = (torch.randn(B, G, Lk, D, generator=g, device=cuda)
                for _ in range(2))
    dq = fa.flash_ring_bwd_dq(q, k, v, dout, lse, delta, dq0.clone(), q_off,
                              kv_off, scale, causal)
    dk, dv = fa.flash_ring_bwd_dkv(q, k, v, dout, lse, delta, dk0.clone(),
                                   dv0.clone(), q_off, kv_off, scale, causal)
    torch.cuda.synchronize()
    ref_dq = fa.flash_ring_bwd_dq_ref(*f32, lse, delta, dq0, q_off, kv_off,
                                      scale, causal)
    ref_dk, ref_dv = fa.flash_ring_bwd_dkv_ref(*f32, lse, delta, dk0, dv0,
                                               q_off, kv_off, scale, causal)
    # What this step added, against what the plain version added.
    for name, a, b, a0 in (("dq", dq, ref_dq, dq0), ("dk", dk, ref_dk, dk0),
                           ("dv", dv, ref_dv, dv0)):
        assert _rel(a, b) <= REL_TOL, name
        assert _rel(a - a0, b - a0) <= REL_TOL, name
    after = fa.launch_counts()
    assert after["flash_ring_step"] == before["flash_ring_step"] + 2
    assert after["flash_ring_bwd_dq"] == before["flash_ring_bwd_dq"] + 1
    assert after["flash_ring_bwd_dkv"] == before["flash_ring_bwd_dkv"] + 1


@pytest.mark.parametrize("B,H,G,Lq,Lk,D,q_off,kv_off,causal", [
    (2, 4, 4, 256, 256, 64, (256,), (0,), True),         # past
    (2, 4, 4, 256, 256, 64, (0,), (0,), True),           # diagonal
    (1, 6, 2, 160, 160, 128, (160,), (0,), False),       # GQA, D = 128
    (1, 4, 1, 200, 136, 32, (136,), (64,), True),        # MQA, D = 32
    # zigzag chunks: n = 2, chunks of 256, and of 48 (tiles straddle)
    (1, 2, 2, 512, 512, 128, (0, 768), (256, 512), True),
    (1, 2, 2, 512, 512, 64, (256, 512), (0, 768), True),
    (1, 4, 2, 96, 96, 128, (0, 144), (48, 96), True),
    # one rank holding the whole sequence as its two zigzag chunks at the
    # long-context model's widths (6 heads of 128 on 2 kv heads)
    (2, 6, 2, 512, 512, 128, (0, 256), (0, 256), True),
    (1, 4, 2, 300, 200, 64, (100,), (150,), True),       # Lq != Lk, ragged
])
def test_rotary_ring_kernels_match_plain_versions(cuda, B, H, G, Lq, Lk, D,
                                                  q_off, kv_off, causal):
    """K4 (fresh and carried state), K5 and K6 (carried sums) with fused
    rotary at the shards' global positions against their plain versions;
    K5's and K6's sums stay in rotated space."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q, dout = (torch.randn(B, H, Lq, D, generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, G, Lk, D, generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    scale = D ** -0.5
    carried = _ring_state(cuda, q.float(), k.float(), v.float(), scale,
                          seed=14)
    # The plain versions on the bf16 values: they round the rotated q and k
    # to bf16, as K4-K6 do.
    bf = [q, k, v, dout]
    fresh = (torch.zeros(B, H, Lq, D, device=cuda),
             torch.full((B, H, Lq), float("-inf"), device=cuda),
             torch.zeros(B, H, Lq, device=cuda))
    before = fa.launch_counts()
    for state in (fresh, carried):
        ref = fa.flash_ring_step_ref(*bf[:3], *state, q_off, kv_off, scale,
                                     causal, ROPE)
        got = fa.flash_ring_step(q, k, v, *(t.clone() for t in state), q_off,
                                 kv_off, scale, causal, ROPE)
        torch.cuda.synchronize()
        assert _rel(got[0], ref[0]) <= REL_TOL
        assert _m_err(got[1], ref[1]) <= LSE_TOL
        assert _rel(got[2], ref[2]) <= REL_TOL
    o, m, l = fa.flash_ring_step_ref(*bf[:3], *carried, q_off, kv_off,
                                     scale, causal, ROPE)
    lse = m + torch.log(l)
    delta = fa._delta(o / l[..., None], bf[3])
    dq0 = torch.randn(B, H, Lq, D, generator=g, device=cuda)
    dk0, dv0 = (torch.randn(B, G, Lk, D, generator=g, device=cuda)
                for _ in range(2))
    dq = fa.flash_ring_bwd_dq(q, k, v, dout, lse, delta, dq0.clone(), q_off,
                              kv_off, scale, causal, ROPE)
    dk, dv = fa.flash_ring_bwd_dkv(q, k, v, dout, lse, delta, dk0.clone(),
                                   dv0.clone(), q_off, kv_off, scale, causal,
                                   ROPE)
    torch.cuda.synchronize()
    ref_dq = fa.flash_ring_bwd_dq_ref(*bf, lse, delta, dq0, q_off, kv_off,
                                      scale, causal, ROPE)
    ref_dk, ref_dv = fa.flash_ring_bwd_dkv_ref(*bf, lse, delta, dk0, dv0,
                                               q_off, kv_off, scale, causal,
                                               ROPE)
    for name, a, b, a0 in (("dq", dq, ref_dq, dq0), ("dk", dk, ref_dk, dk0),
                           ("dv", dv, ref_dv, dv0)):
        assert _rel(a - a0, b - a0) <= REL_TOL, (name, _rel(a - a0, b - a0))
    after = fa.launch_counts()
    assert after["flash_ring_step_rot"] == before["flash_ring_step_rot"] + 2
    for n in ("flash_ring_bwd_dq", "flash_ring_bwd_dkv"):
        assert after[n + "_rot"] == before[n + "_rot"] + 1
    for n in ("flash_ring_step", "flash_ring_bwd_dq", "flash_ring_bwd_dkv"):
        assert after[n] == before[n]
    # each call rotates its own q and k first (the pass, twice a call)
    assert after["rope_rotate"] == before["rope_rotate"] + 2 * 4


def test_ring_step_with_nothing_visible_leaves_the_state(cuda):
    """A k/v shard entirely in the future: no tile runs, the state of K4
    and the carried sums of K5 and K6 stay as they were, bit for bit. Then
    q rows in zigzag chunks of 128 at (0, 384) against keys at 128-255:
    the rows of chunk 0 (K5's first two 64-row warpgroups of a 192-row
    block) see none, and their carried dq stays."""
    q, k, v, dout = (torch.randn(1, 2, 128, 64, device=cuda,
                                 dtype=torch.bfloat16) for _ in range(4))
    o, m, l = _ring_state(cuda, q.float(), k.float(), v.float(), 0.125, 5)
    got = fa.flash_ring_step(q, k, v, o.clone(), m.clone(), l.clone(),
                             (0,), (128,), 0.125, True)
    torch.cuda.synchronize()
    for a, b in zip(got, (o, m, l)):
        assert torch.equal(a, b)
    lse = m + torch.log(l)
    delta = fa._delta(o / l[..., None], dout.float())
    dq0, dk0, dv0 = (torch.randn(1, 2, 128, 64, device=cuda)
                     for _ in range(3))
    dq = fa.flash_ring_bwd_dq(q, k, v, dout, lse, delta, dq0.clone(), (0,),
                              (128,), 0.125, True)
    dk, dv = fa.flash_ring_bwd_dkv(q, k, v, dout, lse, delta, dk0.clone(),
                                   dv0.clone(), (0,), (128,), 0.125, True)
    torch.cuda.synchronize()
    for a, b in ((dq, dq0), (dk, dk0), (dv, dv0)):
        assert torch.equal(a, b)

    q2, dout2 = (torch.randn(1, 2, 256, 64, device=cuda,
                             dtype=torch.bfloat16) for _ in range(2))
    f32 = (q2.float(), k.float(), v.float())
    o, m, l = fa.flash_ring_step_ref(
        *f32, *_ring_state(cuda, *f32, 0.125, 6), (0, 384), (128,), 0.125,
        True)
    lse = m + torch.log(l)
    delta = fa._delta(o / l[..., None], dout2.float())
    dq0 = torch.randn(1, 2, 256, 64, device=cuda)
    dq = fa.flash_ring_bwd_dq(q2, k, v, dout2, lse, delta, dq0.clone(),
                              (0, 384), (128,), 0.125, True)
    ref = fa.flash_ring_bwd_dq_ref(q2.float(), k.float(), v.float(),
                                   dout2.float(), lse, delta, dq0, (0, 384),
                                   (128,), 0.125, True)
    torch.cuda.synchronize()
    assert torch.equal(dq[:, :, :128], dq0[:, :, :128])
    assert _rel(dq[:, :, 128:] - dq0[:, :, 128:],
                ref[:, :, 128:] - dq0[:, :, 128:]) <= REL_TOL


def test_ring_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16)
    o = torch.zeros(1, 2, 64, 64, device=cuda)
    m, l = torch.zeros(1, 2, 64, device=cuda), torch.zeros(1, 2, 64,
                                                           device=cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        fa.flash_ring_step(q, q, q, o.bfloat16(), m, l, (0,), (0,), 0.1,
                           True)
    with pytest.raises(ValueError, match="l must be contiguous float32"):
        fa.flash_ring_step(q, q, q, o, m, l[:, :1], (0,), (0,), 0.1, True)
    with pytest.raises(ValueError, match="two equal chunks"):
        fa.flash_ring_step(q, q, q, o, m, l, (0, 64, 128), (0,), 0.1, True)
    with pytest.raises(ValueError, match="two equal chunks"):
        q63 = torch.zeros(1, 2, 63, 64, device=cuda, dtype=torch.bfloat16)
        fa.flash_ring_bwd_dq(q63, q63, q63, q63, m[..., :63].contiguous(),
                             m[..., :63].contiguous(), o[:, :, :63].clone(),
                             (0, 32), (0,), 0.1, True)
    with pytest.raises(ValueError, match="dk must be"):
        fa.flash_ring_bwd_dkv(q, q, q, q, m, l, o[:, :1], o, (0,), (0,), 0.1,
                              True)


def _bn_inputs(cuda, M, C, x_dtype, dy_dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(M, C, generator=g, device=cuda) * 2.0 + 0.5).to(x_dtype)
    dy = torch.randn(M, C, generator=g, device=cuda).to(dy_dtype)
    mean = x.float().mean(0)
    rstd = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
    return x, dy, mean, rstd


def _rows_rel(out, ref):
    """The worse of the two output rows' ||kernel - plain|| / ||plain||."""
    return max(_rel(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("M,C,x_dtype,dy_dtype", [
    (1, 1, torch.float32, torch.float32),
    (1, 2048, torch.bfloat16, torch.bfloat16),
    (7, 3, torch.bfloat16, torch.bfloat16),
    (7, 72, torch.float32, torch.float32),
    (7, 2048, torch.bfloat16, torch.float32),      # f32 dy, bf16 x
    (1_000_003, 1, torch.bfloat16, torch.bfloat16),
    (1_000_003, 3, torch.float32, torch.float32),
    (1_000_003, 72, torch.bfloat16, torch.float32),
    (4099, 2048, torch.bfloat16, torch.bfloat16),
    (4099, 2056, torch.float32, torch.bfloat16),   # two column tiles
])
def test_bn_kernels_match_plain_versions(cuda, M, C, x_dtype, dy_dtype):
    x, dy, mean, rstd = _bn_inputs(cuda, M, C, x_dtype, dy_dtype)
    before = bn.launch_counts()
    stats = bn.batch_norm_stats(x)
    grads = bn.batch_norm_grad_stats(dy, x, mean, rstd)
    torch.cuda.synchronize()
    after = bn.launch_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        {k: 0 for k in after}, batch_norm_stats=1, batch_norm_grad_stats=1)
    for out in stats + grads:
        assert out.shape == (C,) and out.dtype == torch.float32
    assert _rows_rel(stats, bn.batch_norm_stats_ref(x)) <= BN_TOL
    assert _rows_rel(grads, bn.batch_norm_grad_stats_ref(
        dy, x, mean, rstd)) <= BN_TOL


def test_bn_kernels_are_deterministic(cuda):
    """No float atomics: two runs on the same input agree bit for bit."""
    x, dy, mean, rstd = _bn_inputs(cuda, 300_007, 256, torch.bfloat16,
                                   torch.bfloat16, seed=1)
    for fn, args in ((bn.batch_norm_stats, (x,)),
                     (bn.batch_norm_grad_stats, (dy, x, mean, rstd))):
        a, b = fn(*args), fn(*args)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_bn_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(64, 16, device=cuda)[:, :8]  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        bn.batch_norm_stats(x)
    y = torch.zeros(64, 8, device=cuda)
    m = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bn.batch_norm_grad_stats(x, y, m, m)
    with pytest.raises(TypeError):
        bn.batch_norm_stats(y.half())
    with pytest.raises(ValueError, match="non-empty"):
        bn.batch_norm_stats(y[:0])
    with pytest.raises(ValueError, match="channels-last"):
        bn.FusedBatchNorm(8, device=cuda)(torch.zeros(2, 8, 3, 3,
                                                      device=cuda))


def test_fused_batch_norm_on_the_gpu(cuda):
    """The module's forward and backward through K7 and K8 on a bf16
    channels_last activation, against the plain path on the CPU in f32 on
    the same values: the gap is the bf16 rounding of y and dx."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = (torch.randn(4, 72, 9, 7, generator=g, device=cuda) * 2 + 0.5).to(
        torch.bfloat16).to(memory_format=torch.channels_last)
    gy = torch.randn(x.shape, generator=g, device=cuda).to(torch.bfloat16)
    outs = []
    for dev, xin, gin in (("cuda", x, gy), ("cpu", x.float().cpu(),
                                             gy.float().cpu())):
        mod = bn.FusedBatchNorm(72, device=dev)
        with torch.no_grad():
            mod.weight.copy_(torch.linspace(0.5, 1.5, 72))
        xin = xin.detach().requires_grad_()
        y = mod(xin)
        grads = torch.autograd.grad(y, (xin, mod.weight, mod.bias), gin)
        outs.append([t.float().cpu() for t in (y, *grads, mod.running_mean,
                                               mod.running_var)])
    for name, a, b in zip(("y", "dx", "dgamma", "dbeta", "running_mean",
                           "running_var"), *outs):
        assert _rel(a, b) <= REL_TOL, (name, _rel(a, b))


# (M, C, ghost groups, x dtype, dy dtype) of the passes and the grouped
# statistics: ragged M and C, one and two column tiles, both dtypes, f32 dy
# over bf16 x, the ResNet stem's channels with ghost groups.
BN_PASS_SHAPES = [
    (1, 1, 1, torch.float32, torch.float32),
    (7, 3, 1, torch.bfloat16, torch.bfloat16),
    (7, 72, 7, torch.float32, torch.float32),
    (7, 2048, 1, torch.bfloat16, torch.float32),
    (4096, 64, 8, torch.bfloat16, torch.bfloat16),
    (4099, 2056, 1, torch.float32, torch.bfloat16),
    (6144, 24, 3, torch.bfloat16, torch.float32),
    (1_000_003, 72, 1, torch.bfloat16, torch.float32),
]


def _bn_terms(cuda, x, C, groups, seed):
    """The statistics of x per ghost group, and gamma, beta from a seed."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    xg = x.float().view(groups, -1, C)
    mean = xg.mean(1).squeeze(0)
    rstd = torch.rsqrt(xg.var(1, unbiased=False) + 1e-5).squeeze(0)
    gamma = torch.rand(C, generator=g, device=cuda) + 0.5
    beta = torch.randn(C, generator=g, device=cuda)
    return mean, rstd, gamma, beta


@pytest.mark.parametrize("mode", bn.MODES)
@pytest.mark.parametrize("M,C,groups,x_dtype,dy_dtype", BN_PASS_SHAPES)
def test_bn_passes_equal_plain_versions(cuda, M, C, groups, x_dtype,
                                        dy_dtype, mode):
    """bn_apply and bn_dx, with and without the ReLU, equal their plain
    versions on the same inputs bit for bit (each operation rounded apart,
    the per-channel terms from the same torch expressions)."""
    x, dy, _, _ = _bn_inputs(cuda, M, C, x_dtype, dy_dtype, seed=3)
    mean, rstd, gamma, beta = _bn_terms(cuda, x, C, groups, seed=4)
    a = gamma * rstd
    b = beta - mean * a
    dbeta, dgamma = bn.batch_norm_grad_stats_ref(dy, x, mean, rstd, groups)
    for relu in (False, True):
        before = bn.launch_counts()
        y = bn.bn_apply(x, a, b, groups, relu, mode)
        dx = bn.bn_dx(dy, x, mean, rstd, gamma, beta, dbeta, dgamma,
                      M // groups, groups, relu, mode)
        torch.cuda.synchronize()
        after = bn.launch_counts()
        for name in ("bn_apply", "bn_dx"):
            assert after[name] == before[name] + 1
            assert after[name + "_relu"] == before[name + "_relu"] + relu
        assert y.dtype == dx.dtype == x_dtype and y.shape == x.shape
        assert torch.equal(y, bn.bn_apply_ref(x, a, b, groups, relu, mode))
        assert torch.equal(dx, bn.bn_dx_ref(dy, x, mean, rstd, gamma, beta,
                                            dbeta, dgamma, M // groups,
                                            groups, relu, mode))


@pytest.mark.parametrize("mode", bn.MODES)
@pytest.mark.parametrize("terms", ["gmean", "gvar", "both"])
def test_bn_dx_cotangent_terms_equal_plain_versions(cuda, terms, mode):
    """The mean and var cotangent terms (None in training), one or both."""
    M, C, groups = 4096, 64, 2
    x, dy, _, _ = _bn_inputs(cuda, M, C, torch.bfloat16, torch.bfloat16,
                             seed=5)
    mean, rstd, gamma, beta = _bn_terms(cuda, x, C, groups, seed=6)
    dbeta, dgamma = bn.batch_norm_grad_stats_ref(dy, x, mean, rstd, groups)
    g = torch.Generator(device=cuda).manual_seed(7)
    cot = {k: torch.randn(groups, C, generator=g, device=cuda)
           if terms in (k, "both") else None for k in ("gmean", "gvar")}
    args = (dy, x, mean, rstd, gamma, beta, dbeta, dgamma, M // groups,
            groups, True, mode)
    assert torch.equal(bn.bn_dx(*args, **cot), bn.bn_dx_ref(*args, **cot))


@pytest.mark.parametrize("mode", bn.MODES)
@pytest.mark.parametrize("M,C,groups,x_dtype,dy_dtype", BN_PASS_SHAPES)
def test_bn_stats_with_groups_and_mask_match_plain_versions(
        cuda, M, C, groups, x_dtype, dy_dtype, mode):
    """K7 and K8 per ghost group, K8 with and without the ReLU mask."""
    x, dy, _, _ = _bn_inputs(cuda, M, C, x_dtype, dy_dtype, seed=8)
    mean, rstd, gamma, beta = _bn_terms(cuda, x, C, groups, seed=9)
    stats = bn.batch_norm_stats(x, groups)
    assert _rows_rel(stats, bn.batch_norm_stats_ref(x, groups)) <= BN_TOL
    for mask in ((None, None), (gamma, beta)):
        before = bn.launch_counts()
        grads = bn.batch_norm_grad_stats(dy, x, mean, rstd, groups, *mask,
                                         mode=mode)
        after = bn.launch_counts()
        assert (after["batch_norm_grad_stats_relu"]
                == before["batch_norm_grad_stats_relu"] + (mask[0] is not None))
        ref = bn.batch_norm_grad_stats_ref(dy, x, mean, rstd, groups, *mask,
                                           mode=mode)
        for out in grads:
            assert out.shape == ((C,) if groups == 1 else (groups, C))
        assert _rows_rel(grads, ref) <= BN_TOL


def test_bn_passes_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(64, 16, device=cuda)
    c = torch.ones(16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bn.bn_apply(x[:, :8], c[:8], c[:8])
    with pytest.raises(ValueError, match="does not divide"):
        bn.bn_apply(x, c, c, groups=3)
    with pytest.raises(ValueError, match="mode"):
        bn.bn_apply(x, c, c, mode="fast")
    with pytest.raises(ValueError, match=r"\(16,\)"):
        bn.bn_apply(x, c[:8], c[:8])
    with pytest.raises(ValueError, match="contiguous"):
        bn.bn_dx(x.t(), x.t(), c[:8].repeat(8), c.repeat(4), c.repeat(4),
                 None, c.repeat(4), c.repeat(4), 16)
    with pytest.raises(ValueError, match="mask needs"):
        bn.batch_norm_grad_stats(x, x, c, c, gamma=c)


@pytest.mark.parametrize("mode", bn.MODES)
@pytest.mark.parametrize("M,C,groups,vec_ok", [
    (4096, 64, 8, True), (6144, 24, 3, True), (333, 72, 3, False)])
def test_bn_passes_read_terms_through_their_strides(cuda, M, C, groups,
                                                    vec_ok, mode):
    """The passes read each per-(group, channel) term through its own
    strides: (C,) statistics shared by every ghost group (group stride 0),
    (G, C) sums as the rows of a (G, 2, C) tensor (row stride 2C; K8's own
    outputs are contiguous views of its [2, G, C] output), a cotangent
    expanded from one value (both strides 0), a (G, C) term every other
    column of a wider tensor; one launch each, equal to the plain versions
    given the same tensors, with and without the ReLU."""
    x, dy, _, _ = _bn_inputs(cuda, M, C, torch.bfloat16, torch.bfloat16,
                             seed=11)
    if not vec_ok:  # x at an odd offset: VEC = 1
        x = torch.cat([x.view(-1), x.view(-1)[:1]])[1:].view(M, C)
    mean, rstd, gamma, beta = _bn_terms(cuda, x, C, 1, seed=12)
    dbeta, dgamma = bn.batch_norm_grad_stats(dy, x, mean.expand(groups, C),
                                             rstd.expand(groups, C), groups)
    assert dbeta.is_contiguous() and dgamma.is_contiguous()
    assert dgamma.data_ptr() == dbeta.data_ptr() + 4 * groups * C
    pair = torch.stack([dbeta, dgamma], 1)
    dbeta, dgamma = pair[:, 0], pair[:, 1]
    assert dbeta.stride() == (2 * C, 1)
    gmean = torch.full((), 0.25, device=cuda).expand(groups, C)
    wide = torch.randn(groups, 2 * C, device=cuda)
    gvar = wide[:, ::2]
    a = gamma * rstd
    b = beta - mean * a
    for relu in (False, True):
        before = bn.launch_counts()
        y = bn.bn_apply(x, a, b, groups, relu, mode)
        dx = bn.bn_dx(dy, x, mean, rstd, gamma, beta, dbeta, dgamma,
                      M // groups, groups, relu, mode, gmean, gvar)
        torch.cuda.synchronize()
        after = bn.launch_counts()
        assert after["bn_apply"] == before["bn_apply"] + 1
        assert after["bn_dx"] == before["bn_dx"] + 1
        assert torch.equal(y, bn.bn_apply_ref(x, a, b, groups, relu, mode))
        assert torch.equal(dx, bn.bn_dx_ref(
            dy, x, mean, rstd, gamma, beta, dbeta, dgamma, M // groups,
            groups, relu, mode, gmean, gvar))


def test_bn_pass_terms_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(64, 16, device=cuda)
    c = torch.ones(16, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        bn.bn_apply(x, c.double(), c)
    with pytest.raises(ValueError, match="on cuda"):
        bn.bn_dx(x, x, c, c, c.cpu(), None, c, c, 64)
    with pytest.raises(ValueError, match=r"\(2, 16\)"):
        bn.bn_dx(x, x, c.repeat(3, 1), c, c, None, c, c, 32, groups=2)
    with pytest.raises(RuntimeError, match="CUDA error"):
        bn.bn_dx(x, x, c, c, None, None, c, c, 64)  # no gamma


@pytest.mark.parametrize("M,C,groups,x_dtype,dy_dtype", BN_PASS_SHAPES)
def test_bn_stats_terms_equal_torch_ops_on_the_sums(cuda, M, C, groups,
                                                    x_dtype, dy_dtype):
    """K7 with the forward's terms: one launch, (mean, var, rstd, a, b)
    contiguous views of one [5, G, C] buffer, equal bit for bit to the
    torch ops of batch_norm_stats_terms_ref on K7's own sums (the same
    split), with gamma and beta (C,) or (G, C); the sums within BN_TOL of
    the plain version."""
    x, _, _, _ = _bn_inputs(cuda, M, C, x_dtype, dy_dtype, seed=13)
    _, _, gamma, beta = _bn_terms(cuda, x, C, 1, seed=14)
    sums = bn.batch_norm_stats(x, groups)
    assert _rows_rel(sums, bn.batch_norm_stats_ref(x, groups)) <= BN_TOL
    shape = (C,) if groups == 1 else (groups, C)
    cases = [(gamma, beta)]
    if groups > 1:
        cases.append((gamma.expand(groups, C) * 1.5, beta.expand(groups, C)))
    for ga, be in cases:
        before = bn.launch_counts()
        terms = bn.batch_norm_stats_terms(x, ga, be, 1e-3, groups)
        after = bn.launch_counts()
        assert {k: after[k] - before[k] for k in after} == dict(
            {k: 0 for k in after}, batch_norm_stats=1)
        ref = bn._terms_of_sums(*sums, M // groups, ga, be, 1e-3)
        for name, got, want in zip(("mean", "var", "rstd", "a", "b"), terms,
                                   ref):
            assert got.shape == shape and got.is_contiguous(), name
            assert torch.equal(got, want), name
        assert terms[4].data_ptr() == terms[0].data_ptr() + 16 * groups * C


def _stats_calls(cuda, seed=15):
    """K7, K7 with terms and K8 with the mask at a ghost-grouped shape."""
    M, C, groups = 40_000, 72, 4
    x, dy, _, _ = _bn_inputs(cuda, M, C, torch.bfloat16, torch.bfloat16,
                             seed=seed)
    mean, rstd, gamma, beta = _bn_terms(cuda, x, C, groups, seed=seed + 1)
    return {"k7": lambda: bn.batch_norm_stats(x, groups),
            "k7_terms": lambda: bn.batch_norm_stats_terms(x, gamma, beta,
                                                          1e-5, groups),
            "k8_mask": lambda: bn.batch_norm_grad_stats(
                dy, x, mean, rstd, groups, gamma, beta, "lean")}


def test_bn_stats_repeat_and_replay_bit_for_bit(cuda):
    """Each call leaves its tiles' counters at 0: a second call, a CUDA
    graph's replays (captured on the stream the calls warmed) and a call
    after them give the first call's outputs bit for bit."""
    for name, fn in _stats_calls(cuda).items():
        first = fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            again = fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = fn()
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        after = fn()
        for out in (again, captured, after, fn()):
            assert all(torch.equal(a, b) for a, b in zip(first, out)), name


def test_bn_stats_scratch_is_not_made_in_a_capture(cuda):
    """A capture on a stream whose scratch does not exist yet raises (its
    zeroing would be a memset in every replay) instead of launching."""
    fn = _stats_calls(cuda, seed=17)["k7"]
    fn()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="scratch"):
        with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
            fn()


@pytest.mark.parametrize("relu,groups", [(False, 1), (True, 1), (True, 4)])
def test_lean_batch_norm_on_the_gpu(cuda, relu, groups):
    """lean_batch_norm_train forward and backward through K7, K8 and the
    two passes on a bf16 channels-last activation, against the plain path
    on the CPU on the same values: the statistics differ in their order of
    summation only, so y and dx within a few bf16 roundings. One launch of
    each kernel a layer, the ReLU ones counted apart."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x = (torch.randn(8, 9, 7, 72, generator=g, device=cuda) * 2 + 0.5).to(
        torch.bfloat16)
    gy = torch.randn(x.shape, generator=g, device=cuda).to(torch.bfloat16)
    gamma = torch.linspace(0.5, 1.5, 72, device=cuda)
    beta = torch.linspace(-1, 1, 72, device=cuda)
    outs = []
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (x, gamma, beta)]
        before = bn.launch_counts()
        y, mean, var = bn.lean_batch_norm_train(*leaves, 1e-5, relu, groups)
        grads = torch.autograd.grad(y, leaves, gy.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            after = bn.launch_counts()
            for name in ("batch_norm_stats", "batch_norm_grad_stats",
                         "bn_apply", "bn_dx"):
                assert after[name] == before[name] + 1, name
            for name in ("batch_norm_grad_stats", "bn_apply", "bn_dx"):
                assert (after[name + "_relu"]
                        == before[name + "_relu"] + relu), name
        outs.append([t.float().cpu() for t in (y, mean, var, *grads)])
    for name, a, b in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"),
                          *outs):
        assert _rel(a, b) <= REL_TOL, (name, _rel(a, b))



@pytest.fixture
def nccl_world_one(cuda):
    import horovod_tpu_torch as hvd
    hvd.init()
    yield hvd
    hvd.shutdown()


def test_collectives_at_world_one_on_the_gpu(nccl_world_one):
    """A one-rank NCCL group: every collective with a group, the scales
    and the codecs gives exactly what one rank implies; reduce_scatter of
    an odd count keeps the whole; the digest counts each call."""
    hvd = nccl_world_one
    g = hvd.new_group([0])
    x = torch.linspace(-3, 3, 7, device="cuda")
    seq = hvd.collective_digest()[0]
    for group in (None, hvd.WORLD, g):
        assert torch.equal(hvd.allreduce(x, group=group, prescale_factor=2.0,
                                         postscale_factor=0.25),
                           x * 2.0 / 1 * 0.25)
        assert torch.equal(hvd.reduce_scatter(x, average=False, group=group),
                           x)
        assert torch.equal(hvd.allgather(x, group=group), x)
        assert torch.equal(hvd.broadcast(x, 0, group=group), x)
    for codec, dt in ((hvd.Compression.fp16, torch.float16),
                      (hvd.Compression.bf16, torch.bfloat16)):
        got = hvd.allreduce(x, compression=codec, postscale_factor=3.0)
        assert got.dtype == torch.float32
        assert torch.equal(got, (x.to(dt) / 1 * 3.0).float())
    assert hvd.collective_digest()[0] == seq + 14
    assert hvd.metric_average(1.5) == 1.5
    hvd.assert_synchronized()


def test_overlapped_reduction_equals_the_fused_one_on_the_gpu(
        nccl_world_one, monkeypatch):
    """Every bucket goes out during the backward, in order; the gradients
    equal allreduce_gradients' on a copy of the same local gradients, bit
    for bit."""
    hvd = nccl_world_one
    # a Linear's weight and bias (4096 + 128 bytes) to a bucket
    monkeypatch.setenv("HVD_TPU_FUSION_THRESHOLD", "4224")
    g = torch.Generator(device="cuda").manual_seed(0)
    model = torch.nn.Sequential(*[torch.nn.Linear(32, 32, device="cuda")
                                  for _ in range(4)])
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1),
                                   model.named_parameters())
    assert len(opt.buckets) == 4
    model(torch.randn(8, 32, generator=g, device="cuda")).square().sum(
        ).backward()
    assert opt._order == [0, 1, 2, 3]
    params = list(model.parameters())
    local = [p.grad.clone() for p in params]
    opt.synchronize()
    assert opt.launch_order == [0, 1, 2, 3]
    got = [p.grad.clone() for p in params]
    for p, l in zip(params, local):
        p.grad = l
    hvd.allreduce_gradients(params)
    for a, p in zip(got, params):
        assert torch.equal(a, p.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_remat_on_the_gpu(cuda, dtype):
    """A small lean ResNet with bn_remat: the gradients and running
    statistics of bn_remat=False bit for bit (cuDNN deterministic), K7 once
    a norm, and bn_apply once more for each recomputed norm."""
    from horovod_tpu_torch.models import BottleneckBlock, ResNet
    small = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8,
                 block_cls=BottleneckBlock, norm="lean", dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    plain = ResNet(**small, generator=g)
    remat = ResNet(**small, bn_remat=True)
    with torch.no_grad():
        for block in plain.blocks:
            block.norms[-1].weight.uniform_(0.5, 1.5, generator=g)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(4, 3, 32, 32, generator=g, device=cuda)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        counts = []
        for m in (plain, remat):
            bn.reset_launch_counts()
            m(x).float().square().mean().backward()
            torch.cuda.synchronize()
            counts.append(bn.launch_counts())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    norms = 1 + 4 * len(plain.blocks)
    recomputed = 2 * len(plain.blocks)
    assert counts[0]["batch_norm_stats"] == counts[1]["batch_norm_stats"] \
        == norms
    assert counts[0]["bn_apply"] == norms
    assert counts[1]["bn_apply"] == norms + recomputed
    assert counts[1]["bn_dx"] == counts[0]["bn_dx"] == norms
    for (name, p), q in zip(remat.named_parameters(), plain.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for (name, b), c in zip(remat.named_buffers(), plain.buffers()):
        assert torch.equal(b, c), name


@pytest.mark.parametrize("mode", bn.MODES)
def test_bn_custom_ops_equal_the_wrappers_on_the_gpu(cuda, mode):
    x, dy, mean, rstd = _bn_inputs(cuda, 4096, 72, torch.bfloat16,
                                   torch.bfloat16)
    gamma = torch.linspace(0.5, 1.5, 72, device=cuda)
    beta = torch.linspace(-1, 1, 72, device=cuda)
    y = torch.ops.horovod_tpu_torch.bn_apply(x, gamma, beta, 1, True, mode)
    assert torch.equal(y, bn.bn_apply(x, gamma, beta, 1, True, mode))
    args = (dy, x, mean, rstd, gamma, beta, beta, gamma, 4096, 1, True, mode,
            None, None)
    assert torch.equal(torch.ops.horovod_tpu_torch.bn_dx(*args),
                       bn.bn_dx(*args))


# ------------------------------------------------------------ wire codec


def _same(a, b):
    """Equal tensors, NaN where NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _codec_input(n, seed, special):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g) * 1e-2
    if special:
        x[5] = float("nan")             # block 0 holds a NaN
        x[256 + 7] = float("inf")       # block 1 +inf and -inf
        x[256 + 200] = float("-inf")
        x[512:768] = 0.0                # block 2 zeros
        # block 3 ties: k + 0.5 with max 127, so the scale is 1
        x[768:1024] = (torch.arange(256) % 9 - 4) + 0.5
        x[1000] = 127.0
        x[1024:1280] = torch.randn(256, generator=g) * 1e-40  # denormals
        x[1300] = 3e38                  # block 5 a huge value
    return x.cuda()


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("n,special", [(256, False), (1536, True),
                                       (256 * 1001, False),
                                       (256 * 40000 + 512, True)])
def test_wire_codec_kernels_equal_their_plain_versions(cuda, mode, n,
                                                       special):
    """Encode, decode-add and decode into an empty destination, bit for bit
    (NaN where NaN), on ragged block counts (grids that end mid-block of
    warps) and on blocks holding NaN, infinities, zeros, ties, a huge value
    and denormals."""
    from horovod_tpu_torch.ops import wire_codec as wc
    x = _codec_input(n, n, special)
    acc = torch.randn(n, generator=torch.Generator().manual_seed(1)).cuda()
    before = wc.launch_counts()
    got, ref = wc.wire_encode(x, mode), wc.wire_encode_ref(x, mode)
    for a, b in zip(got, ref):
        assert _same(a, b)
    for add in (True, False):
        k = wc.wire_decode_add(acc.clone(), ref, mode, add)
        p = wc.wire_decode_add_ref(acc.clone(), ref, mode, add)
        assert _same(k, p), add
    after = wc.launch_counts()
    assert after["wire_encode"] == before["wire_encode"] + 1
    assert after["wire_decode_add"] == before["wire_decode_add"] + 2
    if special and mode == "int8":
        s = got[1]
        assert torch.isnan(s[0]) and torch.isnan(s[1]) and s[2] == 0
        assert int(got[0].abs().max()) == 127


def test_wire_codec_refuses_what_it_does_not_take(cuda):
    from horovod_tpu_torch.ops import wire_codec as wc
    x = torch.zeros(512, device=cuda)
    with pytest.raises(ValueError, match="multiple of 256"):
        wc.wire_encode(torch.zeros(300, device=cuda), "int8")
    with pytest.raises(ValueError, match="16-byte"):
        wc.wire_encode(torch.zeros(260, device=cuda)[1:257], "int8")
    with pytest.raises(ValueError, match="contiguous"):
        wc.wire_decode_add(torch.zeros(512, device=cuda)[::2],
                           wc.wire_encode(x[:256], "bf16"), "bf16")
    with pytest.raises(ValueError, match="int8"):
        wc.wire_decode_add(x, (torch.zeros(512, device=cuda),
                               torch.zeros(2, device=cuda)), "int8")


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_ring_schedules_over_four_virtual_ranks(cuda, mode):
    """The three ring schedules over 4 virtual ranks on the card, through
    the kernels and through the plain versions: equal; the allreduce the
    same on every rank and within the reference's limit of the f32 sum."""
    from horovod_tpu_torch.ops import wire_codec as wc
    from horovod_tpu_torch.parallel import ring

    class Plain(ring.RingCodec):
        def encode(self, chunk):
            if self.mode.mode == 0:
                return (chunk,)
            return wc.wire_encode_ref(chunk, self.mode)

        def decode_into(self, dst, payload, add):
            if self.mode.mode == 0:
                return super().decode_into(dst, payload, add)
            return wc.wire_decode_add_ref(dst, payload, self.mode, add)

    n, size = 4, 100_003
    g = torch.Generator(device=cuda).manual_seed(3)
    xs = [torch.randn(size, generator=g, device=cuda) for _ in range(n)]
    c = ring.chunk_length(size, n)
    outs = []
    for codec in (ring.RingCodec, Plain):
        chunks = [ring._padded(x, n, c) for x in xs]
        ring.drive_virtual([ring.allreduce_schedule(chunks[r], r, n,
                                                    codec(mode))
                            for r in range(n)])
        rs = [ring._padded(x, n, c) for x in xs]
        shards = [s.clone() for s in ring.drive_virtual(
            [ring.reduce_scatter_schedule(rs[r], r, n, codec(mode))
             for r in range(n)])]
        gathered = [torch.zeros(n, c, device=cuda) for _ in range(n)]
        ring.drive_virtual([ring.allgather_schedule(shards[r], gathered[r], r,
                                                    n, codec(mode))
                            for r in range(n)])
        outs.append(chunks + shards + gathered)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    total = sum(xs)
    tol = {"none": 1e-5, "bf16": 2e-2, "int8": 4e-2}[mode]
    for chunks in outs[0][:n]:
        got = chunks.view(-1)[:size]
        assert torch.equal(got, outs[0][0].view(-1)[:size])
        assert ((got - total).abs().max() / total.abs().max()) < tol
