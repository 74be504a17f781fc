"""Ranks of the port's sharded-update checks (gloo, CPU).

Run through torch.multiprocessing by tests/test_torch_port_zero.py: 4
ranks (``run_zero``) take the ZeRO-1 step of tests/test_zero1.py's problem
(``make_train_step(zero1=True)``, wire modes none and int8, and the
replicated step beside it), the FSDP step of tests/test_fsdp.py's problem
(``make_fsdp_train_step``), materialize the sharded optimizer state in its
full form, try the guards and, last, the world-scope guard under
``init(model_parallel=2)``; then 2 ranks (``run_reshard``) load that full
state, shard it for their world and take one more step, in wire mode none
and under int8. Every rank
writes what it got to ``<out_dir>/rank<r>.pt``. Imports torch, numpy and
the port only.
"""

import os
import shutil

import numpy as np
import torch
import torch.nn as nn

import horovod_tpu_torch as hvd
import torch_port_bn_worker
from horovod_tpu_torch.parallel import make_fsdp_train_step, make_train_step

WORLD = 4
LR = 1e-2
ZERO1_STEPS = 3
INT8_STEPS = 5
FSDP_MIN_SIZE = 64
BATCH = 32


def zero1_problem():
    """tests/test_zero1.py::_problem's draws: params, x, y."""
    rng = np.random.RandomState(0)
    params = {"w": (rng.randn(13, 7) * 0.3).astype(np.float32),
              "b": rng.randn(7).astype(np.float32),
              "scalarish": rng.randn(3).astype(np.float32)}
    x = rng.randn(BATCH, 13).astype(np.float32)
    y = rng.randn(BATCH, 7).astype(np.float32)
    return params, x, y


def fsdp_problem():
    """tests/test_fsdp.py::_problem's draws: params, x, y."""
    rng = np.random.RandomState(0)
    params = {"w1": (rng.randn(16, 64) * 0.1).astype(np.float32),
              "w2": (rng.randn(64, 16) * 0.1).astype(np.float32),
              "b": rng.randn(16).astype(np.float32)}
    x = rng.randn(BATCH, 16).astype(np.float32)
    y = rng.randn(BATCH, 16).astype(np.float32)
    return params, x, y


class Params(nn.Module):
    """A module of the numpy params, one ``nn.Parameter`` each."""

    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, nn.Parameter(torch.from_numpy(v.copy())))


def zero1_loss(model, batch):
    pred = batch["x"] @ model.w + model.b + torch.sum(model.scalarish ** 2)
    return torch.mean((pred - batch["y"]) ** 2)


def fsdp_loss(model, batch):
    h = torch.tanh(batch["x"] @ model.w1)
    return torch.mean((h @ model.w2 + model.b - batch["y"]) ** 2)


def shard_batch(x, y, r, n):
    rows = BATCH // n
    return {"x": torch.from_numpy(x[r * rows:(r + 1) * rows]),
            "y": torch.from_numpy(y[r * rows:(r + 1) * rows])}


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _zero1(r, out, out_dir):
    params, x, y = zero1_problem()
    batch = shard_batch(x, y, r, WORLD)
    for label, zero1, compression, steps in (
            ("plain", False, None, INT8_STEPS),
            ("none", True, "none", ZERO1_STEPS + 1),
            ("int8", True, "int8", INT8_STEPS)):
        model = Params(params)
        step = make_train_step(model, zero1_loss,
                               torch.optim.Adam(model.parameters(), lr=LR),
                               device="cpu", zero1=zero1,
                               compression=compression)
        opt = step.optimizer
        losses, res = [], {}
        for i in range(steps):
            losses.append(float(step(batch)))
            if i + 1 == ZERO1_STEPS:
                res["params"] = _params(model)
                if label == "none":
                    _state(opt, model, res, out_dir, r)
        res["losses"] = losses
        res["params_last"] = _params(model)
        if zero1:
            res["layout"] = opt.layout
            res["moments"] = [tuple(t.shape) for st in
                              opt.inner.state.values() for t in
                              (st["exp_avg"], st["exp_avg_sq"])]
            res["opt_state_bytes"] = opt.opt_state_bytes
        out["zero1/" + label] = res


def _state(opt, model, res, out_dir, r):
    """The full form of the state after ZERO1_STEPS steps (rank 0 saves it
    with the parameters for run_reshard), and the guards."""
    sd = opt.state_dict()
    full = hvd.sharded_state_full(sd)
    res["full_is_idempotent"] = hvd.sharded_state_full(full) is full
    res["shard_passes_through"] = hvd.sharded_state_shard(sd) is sd
    res["back"] = hvd.sharded_state_shard(full)
    res["sd"] = sd
    res["full"] = full
    foreign = dict(sd, world=7, rank=3)
    for key, fn in (("shard_foreign", hvd.sharded_state_shard),
                    ("full_foreign", hvd.sharded_state_full)):
        try:
            fn(foreign)
            res[key] = None
        except (ValueError, RuntimeError) as e:
            res[key] = (type(e).__name__, str(e))
    try:
        opt.load_state_dict(foreign)
        res["load_foreign"] = None
    except RuntimeError as e:
        res["load_foreign"] = str(e)
    if r == 0:
        torch.save({"full": full, "params": _params(model)},
                   os.path.join(out_dir, "full.pt"))


def _fsdp(r, out):
    params, x, y = fsdp_problem()
    batch = shard_batch(x, y, r, WORLD)
    model = Params(params)
    step = make_fsdp_train_step(model, fsdp_loss, torch.optim.Adam,
                                dict(lr=LR), min_size=FSDP_MIN_SIZE,
                                device="cpu")
    losses = [float(step(batch)) for _ in range(ZERO1_STEPS)]
    full = step.full_parameters()
    full["b"] = model.b.detach().clone()
    out["fsdp"] = dict(
        losses=losses, params=full, sharded=step.sharded,
        names=[n for n, _ in model.named_parameters()],
        state={n: tuple(step.optimizer.state[p]["exp_avg"].shape)
               for n, p in model.named_parameters()},
        opt_state_bytes=step.opt_state_bytes())


def _scope(r, out, store_path, size):
    """The world-scope guard: an explicit non-world group, then, after
    init(model_parallel=2), a new sharded optimizer and the next step of
    one built before the mesh."""
    model = Params(zero1_problem()[0])
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    res = {}
    try:
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 sharded_update=True,
                                 group=hvd.new_group(range(size)))
        res["group"] = None
    except ValueError as e:
        res["group"] = str(e)
    early = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), sharded_update=True)
    hvd.shutdown()
    store = torch.distributed.FileStore(store_path + ".mesh", size)
    hvd.init(device="cpu", store=store, rank=r, size=size, model_parallel=2)
    for key, make in (
            ("mesh_new", lambda: hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                sharded_update=True)),
            ("mesh_step", early.step)):
        try:
            make()
            res[key] = None
        except ValueError as e:
            res[key] = str(e)
    out["scope"] = res


def run_zero(rank, size, store_path, out_dir):
    store = torch.distributed.FileStore(store_path, size)
    hvd.init(device="cpu", store=store, rank=rank, size=size)
    try:
        out = {}
        _zero1(rank, out, out_dir)
        _fsdp(rank, out)
        _scope(rank, out, store_path, size)
        torch.save(out, "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()
        os.environ.pop("HVD_TPU_MODEL_PARALLEL", None)


def run_reshard(rank, size, store_path, out_dir):
    """The 4-rank full state at 2 ranks: load it into a sharded optimizer
    over the parameters saved with it, and take the next step; again under
    the int8 wire, whose shards are the ring's chunks."""
    store = torch.distributed.FileStore(store_path, size)
    hvd.init(device="cpu", store=store, rank=rank, size=size)
    try:
        saved = torch.load(os.path.join(out_dir, "full.pt"))
        params, x, y = zero1_problem()
        model = Params({k: v.numpy() for k, v in saved["params"].items()})
        step = make_train_step(model, zero1_loss,
                               torch.optim.Adam(model.parameters(), lr=LR),
                               device="cpu", zero1=True, compression="none")
        step.optimizer.load_state_dict(saved["full"])
        sd = step.optimizer.state_dict()
        loss = float(step(shard_batch(x, y, rank, size)))
        # the same full state (saved in mode none) under the int8 wire
        model8 = Params({k: v.numpy() for k, v in saved["params"].items()})
        step8 = make_train_step(model8, zero1_loss,
                                torch.optim.Adam(model8.parameters(), lr=LR),
                                device="cpu", zero1=True, compression="int8")
        step8.optimizer.load_state_dict(saved["full"])
        sd8 = step8.optimizer.state_dict()
        loss8 = float(step8(shard_batch(x, y, rank, size)))
        torch.save(dict(sd=sd, loss=loss, params=_params(model), sd8=sd8,
                        loss8=loss8, params8=_params(model8)),
                   "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()


def spawn_zero(out_dir, reshard_dir, timeout=240):
    """The 4-rank run, then the 2-rank run on its full state: (what each
    of the 4 saved, what each of the 2 saved)."""
    four = torch_port_bn_worker.spawn(run_zero, out_dir, size=WORLD,
                                      timeout=timeout)
    shutil.copy(os.path.join(out_dir, "full.pt"), reshard_dir)
    two = torch_port_bn_worker.spawn(run_reshard, reshard_dir, size=2,
                                     timeout=timeout)
    return four, two
