"""Elastic state: committable, restorable, rank-0-syncable training state.

Counterpart of ``horovod_tpu/elastic/state.py`` (the reference Horovod's
``horovod/common/elastic.py`` ``State`` / ``ObjectState`` and its
``TorchState``). The semantics are the reference's (docs/ELASTIC.md):

* ``commit()`` — snapshot every registered attribute, then check for a
  pending membership change. A commit is the rollback point: after a peer
  failure the job resumes from the LAST COMMIT.
* ``restore()`` — load the last committed snapshot back into the
  attributes (called by ``@run`` on ``HorovodInternalError``).
* ``sync()`` — broadcast every attribute from rank 0 (called after every
  (re)initialization, so rejoining or fresh workers adopt the survivors'
  state).

Tensors stay tensors: a snapshot is ``t.detach().clone()`` on the
tensor's own device (bfloat16 included, which numpy has not), and
``restore()`` and ``sync()`` copy into the live tensors IN PLACE wherever
the shape, dtype and device match, so a model's parameters stay the
objects that the optimizer and ``DistributedOptimizer``'s hooks hold.
``TorchState(model, optimizer, **kwargs)`` commits a module's
``state_dict()`` and an optimizer's. ``sync()`` first sends rank 0's
structure, so a rank that holds no optimizer state yet (a replacement
worker, a fresh process after a durable restore elsewhere) takes rank 0's.

This module imports no torch at import time: the launcher reads its
constants.
"""

import copy
import json
import os
import time

SCOPE_ELASTIC = "elastic"
KEY_STATE = "state"
# Graceful-drain protocol (docs/FLEET.md): the driver/launcher publishes
# a drain request here; workers notice it at their next commit, force a
# durable snapshot of exactly that commit, and the victims exit with
# EXIT_DRAINED so supervisors can tell a planned hand-back from a crash.
KEY_DRAIN = "drain"
EXIT_DRAINED = 83


def _tree_flatten(obj, path=""):
    """Flattens nested dict/list/tuple containers to [(path, leaf)] with a
    deterministic order (dict keys sorted) so every rank names leaves
    identically during sync broadcasts (the reference's order and paths)."""
    if isinstance(obj, dict):
        out = []
        for k in sorted(obj, key=str):
            out.extend(_tree_flatten(obj[k], "%s.%s" % (path, k)))
        return out
    if isinstance(obj, (list, tuple)):
        out = []
        for i, v in enumerate(obj):
            out.extend(_tree_flatten(v, "%s.%d" % (path, i)))
        return out
    return [(path, obj)]


def _tree_map_leaves(obj, leaves_iter):
    """Rebuilds `obj`'s structure taking leaves from `leaves_iter` in the
    same deterministic order _tree_flatten produces."""
    if isinstance(obj, dict):
        items = {k: _tree_map_leaves(obj[k], leaves_iter)
                 for k in sorted(obj, key=str)}
        return {k: items[k] for k in obj}  # preserve original key order
    if isinstance(obj, (list, tuple)):
        vals = [_tree_map_leaves(v, leaves_iter) for v in obj]
        if isinstance(obj, tuple):
            return type(obj)(*vals) if hasattr(obj, "_fields") \
                else tuple(vals)
        return vals
    return next(leaves_iter)


def _is_tensor(x):
    return type(x).__module__.startswith("torch") and \
        hasattr(x, "data_ptr") and hasattr(x, "detach")


def _copy_leaf(leaf):
    """One owned copy of a leaf: a tensor on its own device, a numpy
    array, or a deep copy of anything else."""
    if _is_tensor(leaf):
        return leaf.detach().clone()
    return copy.deepcopy(leaf)


def snapshot(value):
    """An owned copy of a tree, leaf by leaf (``_copy_leaf``)."""
    return _tree_map_leaves(value, iter(
        [_copy_leaf(leaf) for _, leaf in _tree_flatten(value)]))


def copy_into(current, saved):
    """``saved`` written into ``current``: a tensor leaf that matches the
    saved one's shape and dtype is overwritten in place (on its own
    device) and kept; any other leaf becomes a copy of the saved one (a
    tensor on the current tensor's device where there is one). Returns
    the result, of ``saved``'s structure."""
    if _is_tensor(saved):
        if _is_tensor(current) and current is not saved and \
                current.shape == saved.shape and \
                current.dtype == saved.dtype:
            import torch
            with torch.no_grad():
                current.copy_(saved)
            return current
        out = saved.detach().clone()
        if _is_tensor(current):
            out = out.to(current.device)
        return out
    if isinstance(saved, dict):
        cur = current if isinstance(current, dict) else {}
        return {k: copy_into(cur.get(k), v) for k, v in saved.items()}
    if isinstance(saved, (list, tuple)):
        cur = list(current) if isinstance(current, (list, tuple)) and \
            len(current) == len(saved) else [None] * len(saved)
        vals = [copy_into(c, v) for c, v in zip(cur, saved)]
        if isinstance(saved, tuple):
            return type(saved)(*vals) if hasattr(saved, "_fields") \
                else tuple(vals)
        return vals
    return copy.deepcopy(saved)


class DrainRequested(Exception):
    """Raised from ``commit()`` when a graceful-drain request covers
    this process (or a peer): the snapshot for the current step has
    already been saved, the agreement allreduce has confirmed every
    rank raises at the SAME step, and the ``@run`` wrapper now forces
    a durable write of exactly this commit before the victims exit
    with ``EXIT_DRAINED`` (survivors re-initialize without rollback).

    ``victims`` is ``"all"`` or a list of worker-id strings; ``epoch``
    is the drain request's sequence number; ``grace`` the seconds the
    supervisor allows before it escalates to a hard kill."""

    def __init__(self, victims, epoch, grace):
        super().__init__("drain requested (epoch %s, victims %s)"
                         % (epoch, victims))
        self.victims = victims
        self.epoch = epoch
        self.grace = grace


class HostsUpdatedInterrupt(Exception):
    """Raised from ``commit()``/``check_host_updates()`` when the driver
    published a newer generation (a host joined or was removed
    gracefully). The ``@run`` wrapper catches it and re-initializes
    WITHOUT rolling back (current state is still globally consistent)."""

    def __init__(self, generation):
        super().__init__("membership changed: generation %d" % generation)
        self.generation = generation


def _poll_published_generation():
    """The driver-published generation number, or None outside elastic
    mode / on any rendezvous hiccup (a missed poll must never take down
    a healthy training loop)."""
    addr = os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    if os.environ.get("HVD_TPU_ELASTIC") != "1" or not addr:
        return None
    from horovod_tpu_torch.run import rendezvous
    try:
        raw = rendezvous.get(addr, SCOPE_ELASTIC, KEY_STATE)
        if raw is None:
            return None
        return int(json.loads(raw.decode())["generation"])
    except Exception:
        return None


def _describe(leaf):
    """What a rank must hold to receive ``leaf`` in ``sync()``, as a
    string (a leaf of the structure that rank 0 sends): ``tensor``,
    ``ndarray`` with dtype and shape, a number's type, or ``object``."""
    if _is_tensor(leaf):
        return "tensor|%s|%s" % (str(leaf.dtype).split(".")[-1],
                                 ",".join(map(str, leaf.shape)))
    if type(leaf).__module__ == "numpy" and hasattr(leaf, "dtype"):
        return "ndarray|%s|%s" % (leaf.dtype.str,
                                  ",".join(map(str, leaf.shape)))
    if isinstance(leaf, (bool, int, float)):
        return type(leaf).__name__
    return "object"


def _placeholder(desc, device):
    """A leaf of the kind ``desc`` names, to receive a broadcast."""
    import numpy as np
    import torch
    kind, _, rest = desc.partition("|")
    if kind in ("tensor", "ndarray"):
        dtype, _, dims = rest.partition("|")
        shape = tuple(int(d) for d in dims.split(",") if d)
        if kind == "tensor":
            return torch.empty(shape, dtype=getattr(torch, dtype),
                               device=device)
        return np.empty(shape, dtype=np.dtype(dtype))
    return {"bool": False, "int": 0, "float": 0.0}.get(kind)


def _broadcast_leaf(leaf, root_rank, name):
    """``leaf`` as it is on ``root_rank``: tensors over the process
    group's device (and back to their own), numpy arrays and numbers as
    tensors; None passes."""
    import numpy as np
    import torch
    from horovod_tpu_torch.common import basics, ops
    dev = basics.device()
    if _is_tensor(leaf):
        out = ops.broadcast(leaf.detach().to(dev), root_rank, name=name)
        return out.to(leaf.device)
    if isinstance(leaf, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(leaf)).to(dev)
        return ops.broadcast(t, root_rank, name=name).cpu().numpy()
    if isinstance(leaf, bool):
        t = torch.tensor([int(leaf)], dtype=torch.int64, device=dev)
        return bool(ops.broadcast(t, root_rank, name=name).item())
    if isinstance(leaf, int):
        t = torch.tensor([leaf], dtype=torch.int64, device=dev)
        return int(ops.broadcast(t, root_rank, name=name).item())
    if isinstance(leaf, float):
        t = torch.tensor([leaf], dtype=torch.float64, device=dev)
        return float(ops.broadcast(t, root_rank, name=name).item())
    return leaf


class State:
    """Base: non-underscore attributes set on the object are elastic
    state (underscore names are reserved for the machinery)."""

    def __init__(self, **kwargs):
        self._committed = None
        self._durable = None
        self._last_check = 0.0
        self._check_interval = float(
            os.environ.get("HVD_TPU_ELASTIC_CHECK_INTERVAL", "0.5"))
        for k, v in kwargs.items():
            if k.startswith("_"):
                raise ValueError(
                    "elastic state attribute %r: underscore names are "
                    "reserved" % k)
            setattr(self, k, v)

    def _public(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def _values(self):
        """{attribute: the tree committed for it}."""
        return self._public()

    def _assign(self, name, value):
        """Writes a restored or synced tree back into attribute ``name``,
        in place where the tensors match (``copy_into``)."""
        setattr(self, name, copy_into(getattr(self, name, None), value))

    # -- commit / restore --------------------------------------------------
    def save(self):
        """Snapshots the current attribute values: one owned copy per
        leaf, tensors on their own devices, the containers rebuilt
        fresh (``snapshot``)."""
        self._committed = {k: snapshot(v) for k, v in self._values().items()}

    def commit(self):
        """save() + check_host_updates() — the reference's commit contract:
        the snapshot lands first, so a membership interrupt raised here
        still resumes from the state just committed. With durability
        enabled (``enable_durable``), every Nth commit also hands the
        snapshot to the background durable writer — by reference, since
        save() replaces the committed dict wholesale."""
        self.save()
        if self._durable is not None:
            self._durable.maybe_enqueue(self._committed,
                                        self._durable_step())
        self.check_drain()
        self.check_host_updates()

    # -- durability (elastic/durable.py) -----------------------------------
    def enable_durable(self, directory=None, every_n_commits=None,
                       interval_s=None, **kwargs):
        """Makes commits durable: every Nth ``commit()`` (or one per
        ``interval_s`` wall-clock window) is written asynchronously to
        `directory` as per-rank CRC-checksummed shards plus a rank-0
        manifest, surviving whole-job loss. `directory` defaults to
        ``HVD_TPU_CKPT_DIR`` (what the launcher's ``--ckpt-dir``
        plumbs). Returns the DurableCheckpointer."""
        from . import durable
        directory = directory or os.environ.get("HVD_TPU_CKPT_DIR")
        if not directory:
            raise ValueError(
                "enable_durable needs a directory (argument or "
                "HVD_TPU_CKPT_DIR / the launcher's --ckpt-dir)")
        self._durable = durable.DurableCheckpointer(
            directory, every_n_commits=every_n_commits,
            interval_s=interval_s, **kwargs)
        return self._durable

    @property
    def durable(self):
        """The active DurableCheckpointer, or None."""
        return self._durable

    def _durable_step(self):
        """The step number a durable snapshot is filed under: the
        state's own integer ``step`` attribute when present (the
        documented convention), else a monotonic commit counter."""
        step = getattr(self, "step", None)
        try:
            return int(step)
        except (TypeError, ValueError):
            return self._durable._commit_index

    def restore(self):
        """Loads the last committed snapshot back into the attributes,
        in place where the tensors match."""
        if self._committed is None:
            return
        for k, v in self._committed.items():
            self._assign(k, v)

    # -- graceful-drain polling (docs/FLEET.md) ----------------------------
    def check_drain(self):
        """Raises :class:`DrainRequested` when a drain request has been
        agreed across ranks (an indicator allreduce at every commit of a
        drain-enabled job, so every rank raises at the same step)."""
        from .run import poll_drain_agreement
        agreed = poll_drain_agreement()
        if agreed is not None:
            raise DrainRequested(*agreed)

    # -- membership-change polling ----------------------------------------
    def check_host_updates(self):
        """Raises HostsUpdatedInterrupt when the driver published a newer
        generation than the one this process initialized under.
        Rate-limited (HVD_TPU_ELASTIC_CHECK_INTERVAL seconds) so the
        per-step cost is one monotonic-clock read."""
        now = time.monotonic()
        if now - self._last_check < self._check_interval:
            return
        self._last_check = now
        published = _poll_published_generation()
        if published is None:
            return
        current = int(os.environ.get("HVD_TPU_GENERATION", "0") or 0)
        if published > current:
            raise HostsUpdatedInterrupt(published)

    # -- cross-rank sync ---------------------------------------------------
    def sync(self, root_rank=0):
        """Broadcasts every registered attribute from `root_rank` over the
        port's ``broadcast``. No-op at size 1. Rank 0's structure goes
        first (leaf kinds, dtypes and shapes); a rank whose own structure
        differs (no optimizer state yet) receives into placeholders of
        rank 0's and takes rank 0's structure."""
        import torch.distributed as dist
        from horovod_tpu_torch.common import basics
        from horovod_tpu_torch.common.ops import raise_peer_loss

        if not basics.is_initialized() or basics.size() <= 1:
            return
        values = self._values()
        skeleton = {k: _tree_map_leaves(v, iter(
            [_describe(leaf) for _, leaf in _tree_flatten(v)]))
            for k, v in values.items()}
        sent = [skeleton, {k: [leaf for _, leaf in _tree_flatten(v)
                               if _describe(leaf) == "object"]
                           for k, v in values.items()}]
        raise_peer_loss(dist.broadcast_object_list)(
            sent, src=root_rank, group=basics.process_group())
        root_skeleton, root_objects = sent
        dev = basics.device()
        for k in sorted(root_skeleton):
            tree = values.get(k)
            if root_skeleton[k] != skeleton.get(k):
                tree = _tree_map_leaves(root_skeleton[k], iter(
                    [_placeholder(d, dev) for _, d in
                     _tree_flatten(root_skeleton[k])]))
            objects = iter(root_objects[k])
            synced = []
            for path, leaf in _tree_flatten(tree):
                if _describe(leaf) == "object":
                    synced.append(next(objects))
                else:
                    synced.append(_broadcast_leaf(
                        leaf, root_rank, "elastic_sync.%s%s" % (k, path)))
            self._assign(k, _tree_map_leaves(tree, iter(synced)))


class ElasticState(State):
    """The concrete state users hand to ``@hvd.elastic.run``: any tree
    of tensors, numpy arrays and python scalars passed as keyword
    arguments becomes a committable attribute, e.g.::

        state = hvd.elastic.ElasticState(params=params, step=0)

        @hvd.elastic.run
        def train(state):
            while state.step < total_steps:
                ...
                state.step += 1
                if state.step % 10 == 0:
                    state.commit()
    """


def _torch_optimizer(optimizer):
    """The ``torch.optim.Optimizer`` behind a ``DistributedOptimizer``
    (or the optimizer itself)."""
    return getattr(optimizer, "optimizer", optimizer)


def load_optimizer_state(optimizer, saved):
    """Writes an optimizer ``state_dict()`` tree into ``optimizer``: each
    state tensor of a parameter copied in place where it matches, else
    placed as ``torch.optim`` places a loaded one (``step`` kept on the
    CPU unless the group is capturable or fused, the rest on the
    parameter's device in its dtype); state absent from ``saved`` is
    dropped; the groups' hyperparameters (all but ``params``) set."""
    import torch
    opt = _torch_optimizer(optimizer)
    # the state_dict's index of a parameter: its place in the groups
    params = [(p, g) for g in opt.param_groups for p in g["params"]]
    for g, sg in zip(opt.param_groups, saved["param_groups"]):
        for key, value in sg.items():
            if key != "params":
                g[key] = copy.deepcopy(value)
    with torch.no_grad():
        for i, (p, group) in enumerate(params):
            st = saved["state"].get(i, saved["state"].get(str(i)))
            if st is None:
                opt.state.pop(p, None)
                continue
            live = opt.state.setdefault(p, {})
            for key in [k for k in live if k not in st]:
                del live[key]
            for key, value in st.items():
                if not _is_tensor(value):
                    live[key] = copy.deepcopy(value)
                    continue
                cur = live.get(key)
                if _is_tensor(cur) and cur.shape == value.shape and \
                        cur.dtype == value.dtype and cur is not value:
                    cur.copy_(value)
                elif key == "step" and not (group.get("capturable") or
                                            group.get("fused")):
                    live[key] = value.detach().clone().cpu()
                else:
                    live[key] = value.detach().to(
                        device=p.device, dtype=p.dtype if
                        value.is_floating_point() else value.dtype,
                        copy=True)


class TorchState(State):
    """Elastic state of a PyTorch model and its optimizer, as the
    reference Horovod's ``hvd.elastic.TorchState(model, optimizer,
    **kwargs)``: ``model`` commits its ``state_dict()``, ``optimizer``
    (a ``torch.optim`` optimizer or a replicated ``DistributedOptimizer``)
    its ``state_dict()``, and every other keyword argument is committed
    as ``ElasticState`` commits it. The sharded update's state is
    rank-local: commit its full form (``sharded_state_full``) in an
    ``ElasticState`` instead, and load it at generation entry. ``restore()`` and ``sync()`` copy the model's tensors in
    place, so the parameters stay the objects the optimizer and
    ``DistributedOptimizer``'s hooks hold."""

    def __init__(self, model=None, optimizer=None, **kwargs):
        from horovod_tpu_torch.optimizer import ShardedDistributedOptimizer
        if isinstance(optimizer, ShardedDistributedOptimizer):
            raise ValueError(
                "TorchState commits a replicated optimizer; the sharded "
                "update's state is rank-local: commit "
                "sharded_state_full(opt.state_dict()) in an ElasticState "
                "and load it with opt.load_state_dict() at generation "
                "entry")
        super().__init__(**kwargs)
        self._model = model
        self._optimizer = optimizer

    def _public(self):
        out = super()._public()
        if self._model is not None:
            out["model"] = self._model
        if self._optimizer is not None:
            out["optimizer"] = self._optimizer
        return out

    def _values(self):
        out = super()._public()
        if self._model is not None:
            out["model"] = dict(self._model.state_dict())
        if self._optimizer is not None:
            out["optimizer"] = _torch_optimizer(self._optimizer).state_dict()
        return out

    def _assign(self, name, value):
        if name == "model" and self._model is not None:
            # copies into the parameters and buffers in place
            self._model.load_state_dict(value)
        elif name == "optimizer" and self._optimizer is not None:
            load_optimizer_state(self._optimizer, value)
        else:
            super()._assign(name, value)

    @property
    def model(self):
        return self._model

    @property
    def optimizer(self):
        return self._optimizer
