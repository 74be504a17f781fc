"""Consistent checkpoint and restore for data-parallel training.

Counterpart of ``horovod_tpu/jax/checkpoint.py``: the reference Horovod's
pattern, "the root rank saves, every rank restores from what the root
read", over ``torch.save``:

* ``save`` — the root rank (default 0) writes the tree; the others touch
  no file. The root's success or failure is broadcast before any rank
  may go on, so an error on the root raises ``CheckpointSaveError`` on
  every rank instead of leaving the others waiting for a root that
  already raised. That broadcast is also the completion barrier.
* ``restore`` — the same root reads the file, conforms it to the
  template's dtypes and devices, and every rank receives the values over
  the process group (``broadcast_parameters``), so the ranks need no
  shared filesystem. A read error on the root raises
  ``CheckpointRestoreError`` on every rank, by the same flag.

A tree is a tensor, a Python scalar, or a dict, list, tuple or namedtuple
of trees (a ``model.state_dict()``, an ``optimizer.state_dict()``, or the
full form of the sharded optimizer's state). The file holds the leaves
and their paths from the root of the tree, so ``torch.load`` reads it
with ``weights_only=True``; ``restore`` rebuilds the template's structure
(a namedtuple's field order included) and raises where the paths or a
tensor's shape differ. Tensor leaves take the template's dtype and
device; other leaves (an optimizer's hyperparameters) take the saved
value.

Both functions hold collectives: every rank must call them.
"""

import os

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.ops import (broadcast, raise_peer_loss,
                                          tree_flatten, tree_unflatten)
from horovod_tpu_torch.optimizer import broadcast_parameters

FORMAT = "horovod_tpu_torch.checkpoint/1"
FILE = "checkpoint.pt"


class CheckpointError(RuntimeError):
    """Base of the cross-rank checkpoint failures (raised on every rank,
    never a hang)."""


class CheckpointSaveError(CheckpointError):
    """The root rank's write failed; every rank raises this (the root with
    the original exception as ``__cause__``)."""


class CheckpointRestoreError(CheckpointError):
    """The root rank's read failed; every rank raises this (the root with
    the original exception as ``__cause__``)."""


def _target(path, step):
    return os.path.join(str(path), str(step)) if step is not None \
        else str(path)


def _sync_root_ok(ok, root_rank, name):
    """Broadcasts the root's success flag; returns it on every rank. It is
    both the error channel and the completion barrier: a rank returning
    from it knows the root got past its filesystem work."""
    flag = torch.tensor([1.0 if ok else 0.0], device=basics.device())
    out = broadcast(flag, root_rank, name)
    return bool(out.item() >= 0.5)


def _raise(cls, what, target, root_rank, err):
    if basics.size() > 1:
        raise cls("checkpoint %s %r failed on root rank %d%s" % (
            what, target, root_rank, ": %s" % err if err is not None else
            " (see the root rank's log for the underlying error)")) from err
    raise cls("checkpoint %s %r failed: %s" % (what, target, err)) from err


def save(path, tree, step=None, root_rank=0):
    """Saves ``tree`` at ``path`` (``path/<step>`` with ``step``) from
    ``root_rank``; pass the same root to ``restore``. Returns the directory
    written, on every rank. Raises ``CheckpointSaveError`` on every rank
    when the root's write fails."""
    target = _target(path, step)
    err = None
    if basics.rank() == root_rank:
        try:
            flat = tree_flatten(tree)
            payload = {"format": FORMAT,
                       "paths": [list(p) for p, _ in flat],
                       "leaves": [v.detach().to("cpu", copy=True)
                                  if torch.is_tensor(v) else v
                                  for _, v in flat]}
            os.makedirs(target, exist_ok=True)
            tmp = os.path.join(target, FILE + ".tmp")
            torch.save(payload, tmp)
            os.replace(tmp, os.path.join(target, FILE))
        except Exception as e:  # surfaced on every rank below
            err = e
    ok = err is None
    if basics.size() > 1:
        ok = _sync_root_ok(ok, root_rank, "ckpt_save_ok.%s"
                           % (step if step is not None else "x"))
    if not ok:
        _raise(CheckpointSaveError, "save to", target, root_rank, err)
    return target


def _read(target, template):
    """The root's side of ``restore``: the saved leaves conformed to the
    template's, {path: leaf}."""
    payload = torch.load(os.path.join(target, FILE), map_location="cpu",
                         weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError("%s is not a checkpoint of this format" % target)
    saved = {tuple(p): v for p, v in zip(payload["paths"],
                                         payload["leaves"])}
    want = tree_flatten(template)
    missing = [p for p, _ in want if p not in saved]
    extra = set(saved) - {p for p, _ in want}
    if missing or extra:
        raise ValueError("the checkpoint's tree differs from the template: "
                         "missing %s, unexpected %s"
                         % (["/".join(p) for p in missing[:5]],
                            ["/".join(p) for p in sorted(extra)[:5]]))
    out = {}
    for p, t in want:
        v = saved[p]
        if torch.is_tensor(t):
            v = torch.as_tensor(v)
            if v.shape != t.shape:
                raise ValueError("%s: saved shape %s, template %s" % (
                    "/".join(p), tuple(v.shape), tuple(t.shape)))
            v = v.to(t.device, t.dtype)
        out[p] = v
    return out


def restore(path, template, step=None, root_rank=0):
    """Restores the tree written by ``save`` into the structure, dtypes and
    devices of ``template`` (for example a fresh ``model.state_dict()``).
    Only ``root_rank`` reads the file; the others receive the values over
    the process group, so their ``path`` need not exist. Raises
    ``CheckpointRestoreError`` on every rank when the root's read
    fails."""
    target = _target(path, step)
    err = None
    leaves = dict(tree_flatten(template))
    if basics.rank() == root_rank:
        try:
            leaves = _read(target, template)
        except Exception as e:  # surfaced on every rank below
            err = e
    ok = err is None
    if basics.size() > 1:
        ok = _sync_root_ok(ok, root_rank, "ckpt_restore_ok.%s"
                           % (step if step is not None else "x"))
    if not ok:
        _raise(CheckpointRestoreError, "restore from", target, root_rank,
               err)
    if basics.size() > 1:
        leaves = _broadcast_leaves(leaves, root_rank)
    return tree_unflatten(template, leaves)


def _broadcast_leaves(leaves, root_rank):
    """The root's {path: leaf} on every rank: tensors through
    ``broadcast_parameters`` on the process group's device, the other
    leaves as one broadcast object list."""
    paths = list(leaves)
    tensors = [p for p in paths if torch.is_tensor(leaves[p])]
    dev = basics.device()
    bufs = [leaves[p].detach().to(dev, copy=True) for p in tensors]
    broadcast_parameters(bufs, root_rank=root_rank,
                         name_prefix="ckpt_restore")
    out = dict(leaves)
    for p, b in zip(tensors, bufs):
        out[p] = b.to(leaves[p].device)
    others = [p for p in paths if not torch.is_tensor(leaves[p])]
    if others:
        objs = [leaves[p] for p in others]
        raise_peer_loss(dist.broadcast_object_list)(
            objs, src=root_rank, group=basics.process_group())
        out.update(zip(others, objs))
    return out
