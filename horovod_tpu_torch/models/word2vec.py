"""Skip-gram word2vec with negative sampling, and its two train steps.

Counterpart of ``horovod_tpu/models/word2vec.py`` (the model) and of
``bench.py``'s word2vec step (``w2v_make_step``): the embedding [V, D]
(flax's ``uniform(2.0)``: U[0, 2)), ``nce_weight`` [V, D] (a normal of
standard deviation 1 / sqrt(D) truncated at 2 of them) and ``nce_bias``
[V] (zeros), in f32, drawn from ``generator``. The NCE loss scores each
center word against its context word and K negatives shared by the batch.

Two ways to train it over the ranks (``group``, default the world), plain
SGD at ``lr``:

- ``make_sparse_step``: differentiates the loss with respect to the rows
  it gathered (``bench.py:2148-2169``), gathers every rank's (indices,
  rows) with ``sparse.allreduce_sparse`` and scatter-adds them into the
  tables (``sparse.apply_sparse_``): no [V, D] gradient exists, and the
  traffic is the rows touched;
- ``make_dense_step``: the gradient of each whole table, averaged by
  ``allreduce``, then subtracted.

Both apply the updates in the reference's order: the embedding, then
``nce_weight`` and ``nce_bias`` at the context words, then at the
negatives.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.common.ops import allreduce
from horovod_tpu_torch.ops.agc import LAST, tag_units
from horovod_tpu_torch.sparse import allreduce_sparse, apply_sparse_


def nce_from_rows(emb, pos_w, pos_b, neg_w, neg_b):
    """The NCE loss from gathered rows: ``emb`` [B, D] (center words),
    ``pos_w`` [B, D] and ``pos_b`` [B] (context words), ``neg_w`` [K, D]
    and ``neg_b`` [K] (the shared negatives)."""
    pos_logit = (emb * pos_w).sum(-1) + pos_b
    neg_logit = emb @ neg_w.T + neg_b[None, :]
    pos_loss = -F.logsigmoid(pos_logit)
    neg_loss = -F.logsigmoid(-neg_logit).sum(-1)
    return (pos_loss + neg_loss).mean()


class SkipGram(nn.Module):
    """Skip-gram embedding + NCE output layer."""

    def __init__(self, vocab_size=50000, embedding_dim=200, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.embedding = nn.Embedding(vocab_size, embedding_dim,
                                      device=device)
        self.nce_weight = nn.Parameter(torch.empty(vocab_size, embedding_dim,
                                                   device=device))
        self.nce_bias = nn.Parameter(torch.zeros(vocab_size, device=device))
        self.reset_parameters(generator)
        tag_units(self)

    def agc_units(self):
        # flax's [V, D] leaf as it is: the unit is the last dim
        return {"nce_weight": LAST}

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.embedding.weight.uniform_(0.0, 2.0, generator=generator)
        std = self.nce_weight.shape[1] ** -0.5
        nn.init.trunc_normal_(self.nce_weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        self.nce_bias.zero_()

    def forward(self, center_ids):
        """A batch of center-word ids -> their embeddings [B, D]."""
        return self.embedding(center_ids)

    def nce_loss(self, center_ids, context_ids, negative_ids):
        """center_ids [B], context_ids [B] (positives), negative_ids [K]."""
        return nce_from_rows(self.embedding(center_ids),
                             self.nce_weight[context_ids],
                             self.nce_bias[context_ids],
                             self.nce_weight[negative_ids],
                             self.nce_bias[negative_ids])

    @torch.no_grad()
    def nearest(self, word_ids, k=8):
        """The ``k`` cosine-nearest words of each of ``word_ids``, itself
        left out."""
        w = self.embedding.weight
        norm = w / (torch.linalg.norm(w, dim=1, keepdim=True) + 1e-8)
        sim = norm[word_ids] @ norm.T
        return torch.topk(sim, k + 1).indices[:, 1:]


def _tables(model):
    return model.embedding.weight, model.nce_weight, model.nce_bias


def make_sparse_step(model, lr, group=None, name="w2v"):
    """``step(center, context, negative) -> loss averaged over the ranks``
    on the sparse gradient plane (module docstring)."""

    def step(center, context, negative):
        emb, w, b = _tables(model)
        ids = (center, context, context, negative, negative)
        tables = (emb, w, b, w, b)
        rows = [t.detach()[i].requires_grad_() for t, i in zip(tables, ids)]
        loss = nce_from_rows(*rows)
        grads = torch.autograd.grad(loss, rows)
        with torch.no_grad():
            for j, (t, i, g) in enumerate(zip(tables, ids, grads)):
                all_i, all_g = allreduce_sparse(i, g, average=True,
                                                group=group,
                                                name="%s.%d" % (name, j))
                apply_sparse_(t, all_i, all_g, scale=-lr)
        return allreduce(loss.detach(), average=True, group=group,
                         name=name + ".loss")

    return step


def make_dense_step(model, lr, group=None, name="w2v_dense"):
    """``step(center, context, negative) -> loss averaged over the ranks``
    with dense [V, D] gradients, averaged by ``allreduce``."""

    def step(center, context, negative):
        tables = _tables(model)
        loss = model.nce_loss(center, context, negative)
        grads = torch.autograd.grad(loss, tables)
        with torch.no_grad():
            for j, (t, g) in enumerate(zip(tables, grads)):
                t.sub_(allreduce(g, average=True, group=group,
                                 name="%s.%d" % (name, j)) * lr)
        return allreduce(loss.detach(), average=True, group=group,
                         name=name + ".loss")

    return step
