"""Memory-lean LM losses.

Counterpart of ``horovod_tpu/ops/losses.py``.
``chunked_softmax_cross_entropy`` computes the causal-LM cross entropy
without the full [B, L, vocab] f32 logits: it walks the sequence one chunk
at a time, projects the chunk to the vocabulary, reduces it to its
logsumexp and target logit at once, and recomputes the chunk's projection
in the backward (``torch.utils.checkpoint``, as the JAX package's
``jax.checkpoint``). Live memory is O(B * chunk * vocab) in place of
O(B * L * vocab): at vocab 32000 and 2 x 8192 tokens the f32 logits alone
would be 2.1 GB, and their softmax as much again.

Plain PyTorch: the TPU package has no Pallas body here (XLA fuses it), and
the projection is a ``torch.matmul``.
"""

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_loss(h, weight, t):
    """Sum over a chunk's tokens of logsumexp(logits) - logits[target]; the
    projection in h's dtype, the reduction in f32."""
    logits = torch.matmul(h, weight.to(h.dtype).t()).float()
    tgt = logits.gather(-1, t[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - tgt).sum()


def chunked_softmax_cross_entropy(hidden, weight, targets, chunk=512):
    """Mean token cross entropy over chunked vocabulary projections.

    Args:
      hidden: [B, L, E] final hidden states (any float dtype; the
        projection runs in it and reduces in f32).
      weight: [V, E] lm-head weight (``nn.Linear(E, V).weight``; the JAX
        package's kernel is its transpose).
      targets: [B, L] integer target token ids.
      chunk: sequence chunk length; it must divide L (chunk = L is one
        shot).

    Returns the scalar mean of logsumexp(logits) - logits[target] over the
    B * L tokens: the math of log_softmax and gather.
    """
    B, L, _ = hidden.shape
    if L % chunk != 0:
        raise ValueError("L=%d not divisible by chunk=%d" % (L, chunk))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, L, chunk):
        total = total + checkpoint(_chunk_loss, hidden[:, s:s + chunk],
                                   weight, targets[:, s:s + chunk],
                                   use_reentrant=False)
    return total / (B * L)
