"""Divergence checks: a fingerprint of every rank's collective calls.

Counterpart of ``horovod_tpu/native/divergence.cc`` (the call tracker)
and of ``collective_digest``, ``assert_synchronized`` and
``metric_average`` in ``horovod_tpu/jax/__init__.py``. Every collective
of the port's API (``common/ops.py`` and the optimizer's gradient
reductions) records (op, dtype, ndim, name) here: a sequence count and a
rolling FNV-1a over the calls. Two ranks that made the same calls in the
same order hold the same (seq, digest); ``assert_synchronized`` compares
them across the ranks.
"""

import threading

import torch

from horovod_tpu_torch.common import basics

FNV_OFFSET = 14695981039346656037
FNV_PRIME = 1099511628211
_MASK = (1 << 64) - 1

# native/message.h: Request::RequestType and DataType
OP_CODES = {"allreduce": 0, "allgather": 1, "broadcast": 2,
            "reduce_scatter": 3}
DTYPE_CODES = {torch.uint8: 0, torch.int8: 1, torch.int16: 3,
               torch.int32: 4, torch.int64: 5, torch.float16: 6,
               torch.float32: 7, torch.float64: 8, torch.bool: 9,
               torch.bfloat16: 10}


def fold_byte(h, b):
    return ((h ^ b) * FNV_PRIME) & _MASK


def fold_call(digest, op, dtype, ndim, name):
    """``FoldCall``: the digest after one call of op code ``op`` on a
    tensor of dtype code ``dtype`` and rank ``ndim`` named ``name``; a
    0xFF terminator ends each call, so "ab" + "c" differs from "a" +
    "bc"."""
    h = digest
    for b in (op, dtype, ndim & 0xFF):
        h = fold_byte(h, b)
    for b in name.encode("utf-8"):
        h = fold_byte(h, b)
    return fold_byte(h, 0xFF)


class CallTracker:
    """(seq, digest) of the calls recorded since the last reset."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.seq, self.digest, self._names = 0, FNV_OFFSET, 0

    def record(self, op, tensor, name):
        with self._lock:
            self.seq += 1
            self.digest = fold_call(self.digest, OP_CODES[op],
                                    DTYPE_CODES.get(tensor.dtype, 0xFF),
                                    tensor.dim(), name)

    def auto_name(self, prefix):
        """``prefix.N``, N counting every auto-named call since init on
        this rank (the reference's ``_auto_name``)."""
        with self._lock:
            self._names += 1
            return "%s.%d" % (prefix, self._names)

    def snapshot(self):
        with self._lock:
            return self.seq, self.digest


_tracker = CallTracker()
record = _tracker.record
auto_name = _tracker.auto_name


def reset():
    """Restarts the count, the digest and the names (at every ``init()``:
    a rank that joins fresh starts where the others restart)."""
    _tracker.reset()


def collective_digest():
    """This rank's collective call fingerprint, ``(seq, digest)``: the
    calls recorded since ``init()`` and the rolling FNV-1a over their
    (op, dtype, ndim, name)."""
    return _tracker.snapshot()


class DivergenceError(RuntimeError):
    """Raised by ``assert_synchronized`` when the ranks' collective call
    sequences differ."""


def _signed(u):
    return u - (1 << 64) if u >= 1 << 63 else u


def assert_synchronized(name=None):
    """Checks that every rank has made the same collective calls so far.

    Takes this rank's ``collective_digest()``, allgathers every rank's
    (rank, seq, digest) (24 bytes a rank) and raises ``DivergenceError``
    naming each rank's row when they differ. It is itself a collective:
    every rank calls it at the same points."""
    from horovod_tpu_torch.common import ops
    seq, digest = collective_digest()
    mine = torch.tensor([[basics.rank(), seq, _signed(digest)]],
                        dtype=torch.int64, device=basics.device())
    rows = ops.allgather(mine, name or _tracker.auto_name("hvd_assert_sync"))
    rows = sorted((r, s, d & _MASK) for r, s, d in rows.cpu().tolist())
    if len({(s, d) for _, s, d in rows}) <= 1:
        return
    detail = "; ".join("rank %d: seq=%d digest=%016x" % row for row in rows)
    raise DivergenceError(
        "collective call sequences diverged across ranks (%s). Some rank "
        "made extra, missing or reordered collectives since init, "
        "typically a rank-conditional collective or an unordered "
        "iteration over names." % detail)


def metric_average(value, name=None):
    """The mean of a scalar metric over the ranks, averaged in float64,
    as a Python float."""
    from horovod_tpu_torch.common import ops
    t = torch.tensor(float(value), dtype=torch.float64,
                     device=basics.device())
    return float(ops.allreduce(t, average=True,
                               name=name or _tracker.auto_name("metric")))
