"""Ranks of the port's sparse-gradient and checkpoint checks (gloo, CPU).

Run through torch.multiprocessing by tests/test_torch_port_sparse.py and
tests/test_torch_port_checkpoint.py:

- ``run_sparse`` (4 ranks): ``allreduce_sparse`` (averaged and summed) on
  equal row counts with indices repeated within and across ranks, then
  ``apply_sparse`` and ``densify`` of the result; a ragged case (rank r
  sends r + 1 rows); and 3 SkipGram steps on the sparse plane and on the
  dense one from the same tables (tests/test_jax_api.py's sizes);
- ``run_checkpoint`` (2 ranks): tests/checkpoint_worker.py's protocol on
  the port (rank 1 passes a path that does not exist; a bf16 leaf restored
  into an f32 template; a namedtuple whose fields are not in alphabetical
  order; a root write failure and a missing checkpoint raising the named
  error on both ranks, timed), and a model's and an SGD optimizer's
  state dicts;
- ``run_ckpt_save`` (2 ranks) and ``run_ckpt_reshard`` (4 ranks): the
  sharded update's full state (``sharded_state_full``) saved at 2 ranks,
  restored there, then restored at 4 ranks, sharded there and stepped.

Every rank writes what it got to ``<out_dir>/rank<r>.pt``. Imports torch,
numpy and the port only.
"""

import collections
import os
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
import torch_port_bn_worker
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.models.word2vec import (SkipGram, make_dense_step,
                                               make_sparse_step)
from horovod_tpu_torch.parallel import make_train_step
from torch_port_zero_worker import (Params, _params, shard_batch,
                                    zero1_loss, zero1_problem)

SPARSE_WORLD = 4
# allreduce_sparse's equal-count case: ROWS indices a rank out of V_SPARSE
# (repeats within and across ranks), values [ROWS, D_SPARSE]
V_SPARSE, ROWS, D_SPARSE = 10, 6, 3
# tests/test_jax_api.py::test_w2v_sparse_step_matches_dense_mesh's sizes
W2V = dict(V=64, D=16, B=32, K=8, lr=0.5, steps=3)

# Field order deliberately not alphabetical (zz before aa).
Counters = collections.namedtuple("Counters", ["zz_mini", "aa_grad"])
LR = 1e-2


def sparse_inputs():
    """Each rank's (indices, values) of the equal-count case, and the
    param the result is applied to."""
    rng = np.random.RandomState(11)
    idx = rng.randint(0, V_SPARSE, (SPARSE_WORLD, ROWS)).astype(np.int64)
    vals = rng.randn(SPARSE_WORLD, ROWS, D_SPARSE).astype(np.float32)
    param = rng.randn(V_SPARSE, D_SPARSE).astype(np.float32)
    return idx, vals, param


def w2v_inputs():
    """center, context, negatives and the three tables (bench.py's draws
    as tests/test_jax_api.py makes them)."""
    V, D, B, K = (W2V[k] for k in "VDBK")
    rng = np.random.RandomState(3)
    center = rng.randint(0, V, B).astype(np.int32)
    context = rng.randint(0, V, B).astype(np.int32)
    neg = rng.randint(0, V, K).astype(np.int32)
    r = np.random.RandomState(1)
    tables = (r.randn(V, D).astype(np.float32) * 0.1,
              r.randn(V, D).astype(np.float32) * 0.1,
              np.zeros((V,), np.float32))
    return center, context, neg, tables


def _w2v(rank, size, sparse):
    center, context, neg, tables = w2v_inputs()
    V, D, B = W2V["V"], W2V["D"], W2V["B"]
    model = SkipGram(V, D, device="cpu")
    with torch.no_grad():
        model.embedding.weight.copy_(torch.from_numpy(tables[0]))
        model.nce_weight.copy_(torch.from_numpy(tables[1]))
        model.nce_bias.copy_(torch.from_numpy(tables[2]))
    make = make_sparse_step if sparse else make_dense_step
    step = make(model, W2V["lr"])
    rows = B // size
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731
    c = t(center[rank * rows:(rank + 1) * rows])
    x = t(context[rank * rows:(rank + 1) * rows])
    losses = [float(step(c, x, t(neg))) for _ in range(W2V["steps"])]
    return dict(losses=losses, emb=model.embedding.weight.detach().clone(),
                nce_w=model.nce_weight.detach().clone(),
                nce_b=model.nce_bias.detach().clone())


def run_sparse(rank, size, store_path, out_dir):
    store = torch.distributed.FileStore(store_path, size)
    hvd.init(device="cpu", store=store, rank=rank, size=size)
    try:
        idx, vals, param = sparse_inputs()
        i, v = torch.from_numpy(idx[rank]), torch.from_numpy(vals[rank])
        out = {}
        for average in (True, False):
            ai, av = hvd.allreduce_sparse(i, v, average=average)
            out["avg" if average else "sum"] = dict(
                indices=ai, values=av,
                applied=hvd.apply_sparse(torch.from_numpy(param), ai, av,
                                         scale=-0.5),
                dense=hvd.densify(ai, av, V_SPARSE))
        p = torch.from_numpy(param.copy())
        hvd.apply_sparse_(p, out["avg"]["indices"], out["avg"]["values"],
                          scale=-0.5)
        out["applied_inplace"] = p
        # ragged: rank r sends r + 1 rows, all at index r
        ri, rv = hvd.allreduce_sparse(
            torch.full((rank + 1,), rank, dtype=torch.long),
            torch.full((rank + 1, 2), float(rank + 1)), name="ragged")
        out["ragged"] = dict(indices=ri, values=rv)
        out["w2v_sparse"] = _w2v(rank, size, sparse=True)
        out["w2v_dense"] = _w2v(rank, size, sparse=False)
        torch.save(out, "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()


def _zeros_like(tree):
    """The tree with every tensor zeroed; other leaves as they are."""
    if isinstance(tree, dict):
        return type(tree)((k, _zeros_like(v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zeros_like(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    return torch.zeros_like(tree) if torch.is_tensor(tree) else tree


def _model_and_sgd(rank):
    torch.manual_seed(rank)  # the ranks differ before the restore
    model = torch.nn.Linear(4, 3)
    sgd = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.randn(2, 4)).sum().backward()
    sgd.step()
    return model, sgd


def run_checkpoint(rank, size, store_path, out_dir):
    store = torch.distributed.FileStore(store_path, size)
    hvd.init(device="cpu", store=store, rank=rank, size=size)
    try:
        out = {}
        tree = {"w": torch.full((2, 2), 10.0 + rank),
                "step": torch.tensor(5 * (rank + 1), dtype=torch.int32),
                # saved bf16, restored into an f32 template
                "mu": torch.full((3,), 0.5, dtype=torch.bfloat16),
                "counters": Counters(zz_mini=torch.tensor(111),
                                     aa_grad=torch.tensor(222))}
        path = os.path.join(out_dir, "ckpt") if rank == 0 \
            else "/nonexistent/ckpt"
        out["saved_to"] = checkpoint.save(path, tree, step=1)
        out["rank1_path_exists"] = os.path.exists("/nonexistent/ckpt")
        template = {"w": torch.zeros(2, 2),
                    "step": torch.tensor(0, dtype=torch.int32),
                    "mu": torch.zeros(3),
                    "counters": Counters(zz_mini=torch.tensor(0),
                                         aa_grad=torch.tensor(0))}
        out["restored"] = checkpoint.restore(path, template, step=1)
        out["counters_type"] = type(out["restored"]["counters"]).__name__
        out["counters_fields"] = out["restored"]["counters"]._fields
        out["restored"]["counters"] = tuple(out["restored"]["counters"])

        # a model's and an optimizer's state dicts
        model, sgd = _model_and_sgd(rank)
        checkpoint.save(path, {"model": model.state_dict(),
                               "opt": sgd.state_dict()}, step=2)
        other, other_sgd = _model_and_sgd(rank + 7)
        got = checkpoint.restore(path, {"model": other.state_dict(),
                                        "opt": other_sgd.state_dict()},
                                 step=2)
        other.load_state_dict(got["model"])
        other_sgd.load_state_dict(got["opt"])
        out["model"] = other.state_dict()
        out["opt"] = other_sgd.state_dict()
        out["model_root"] = model.state_dict()
        out["opt_root"] = sgd.state_dict()

        # the named errors on every rank, promptly
        t0 = time.monotonic()
        errors = {}
        for key, call, cls in (
                ("save", lambda: checkpoint.save(
                    "/proc/nonexistent/unwritable", tree),
                 checkpoint.CheckpointSaveError),
                ("restore", lambda: checkpoint.restore(path, template,
                                                       step=99),
                 checkpoint.CheckpointRestoreError)):
            try:
                call()
                errors[key] = None
            except cls as e:
                errors[key] = (type(e).__name__, str(e),
                               isinstance(e, checkpoint.CheckpointError))
        out["errors"] = errors
        out["error_seconds"] = time.monotonic() - t0
        # a template of another structure: the root's read fails
        try:
            checkpoint.restore(path, {"w": torch.zeros(2, 2)}, step=1)
            out["mismatch"] = None
        except checkpoint.CheckpointRestoreError as e:
            out["mismatch"] = str(e)
        torch.save(out, "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()


def _zero1_step(rank, size, params):
    model = Params(params)
    step = make_train_step(model, zero1_loss,
                           torch.optim.Adam(model.parameters(), lr=LR),
                           device="cpu", zero1=True, compression="none")
    return model, step


def run_ckpt_save(rank, size, store_path, out_dir):
    """2 ranks: 3 zero1 steps, the full state and the parameters saved and
    restored; the next step's parameters."""
    store = torch.distributed.FileStore(store_path, size)
    hvd.init(device="cpu", store=store, rank=rank, size=size)
    try:
        params, x, y = zero1_problem()
        model, step = _zero1_step(rank, size, params)
        batch = shard_batch(x, y, rank, size)
        for _ in range(3):
            step(batch)
        full = hvd.sharded_state_full(step.optimizer.state_dict())
        tree = {"full": full, "params": _params(model)}
        path = os.path.join(out_dir, "ckpt") if rank == 0 \
            else "/nonexistent/ckpt"
        checkpoint.save(path, tree, step=3)
        back = checkpoint.restore(path, _zeros_like(tree), step=3)
        loss = float(step(batch))
        torch.save(dict(tree=tree, back=back, loss=loss,
                        params_next=_params(model)),
                   "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()


def run_ckpt_reshard(rank, size, store_path, out_dir):
    """4 ranks: restore the 2-rank checkpoint (only rank 0 reads it) into a
    template of this world's own full state, load it into a sharded
    optimizer, and take the next step."""
    store = torch.distributed.FileStore(store_path, size)
    hvd.init(device="cpu", store=store, rank=rank, size=size)
    try:
        params, x, y = zero1_problem()
        model, step = _zero1_step(rank, size, params)
        batch = shard_batch(x, y, rank, size)
        step(batch)  # builds the state: the template's structure
        template = {"full": hvd.sharded_state_full(
            step.optimizer.state_dict()), "params": _params(model)}
        path = os.path.join(out_dir, "ckpt") if rank == 0 \
            else "/nonexistent/ckpt"
        got = checkpoint.restore(path, template, step=3)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(got["params"][k])
        step.optimizer.load_state_dict(got["full"])
        sd = step.optimizer.state_dict()
        loss = float(step(batch))
        torch.save(dict(got=got, sd=sd, loss=loss,
                        params_next=_params(model)),
                   "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()


def spawn(fn, out_dir, size, timeout=240):
    return torch_port_bn_worker.spawn(fn, out_dir, size=size,
                                      timeout=timeout)
