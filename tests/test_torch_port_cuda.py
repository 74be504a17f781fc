"""The port's flash kernels against their plain versions on a GPU.

Marked ``cuda``: they need a card and nvcc, and skip without them. They
import no JAX, so they also run where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

chip_smoke.py covers the training shape; these cover the other head
dims, float32 inputs, GQA, MQA and ragged lengths at small sizes.
"""

import sys

import pytest
import torch

import horovod_tpu_torch.ops.flash_attention  # noqa: F401

fa = sys.modules["horovod_tpu_torch.ops.flash_attention"]

pytestmark = pytest.mark.cuda

# The kernels round the products' inputs (P and dS too) to bf16 and
# accumulate in f32, so against the f32 plain version on the same values
# ||kernel - plain||_2 / ||plain||_2 is a few 1e-3; lse stays f32 through.
REL_TOL = 1e-2
LSE_TOL = 1e-3


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
               for n in after)


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
