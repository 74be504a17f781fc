"""Pure-Python span emitter sharing the native shard schema.

A copy of ``horovod_tpu/trace/emit.py``. Serve replicas never call
``init()``, but their request spans still belong in the same merged
trace as the training plane. This emitter writes the JSONL shard format
of the reference's native recorder (``native/trace.cc``: a header line,
then span lines with the n/p/g/c/pe/b/s/e/f keys), so the shard merger
reads serve shards with no special casing. No clock lines are written: a
serve process has no control plane to piggyback NTP samples on, so its
spans merge uncorrected (offset 0), which is fine for intra-process
latency analysis, what per-request spans are for.

Gated on HVD_TPU_TRACE_DIR; with the variable unset, ``shard_for()``
returns a no-op emitter so call sites stay unconditional.
"""

import json
import os
import threading
import time

TRACE_REQUEST = 8

_lock = threading.Lock()
_shards = {}


class _NullEmitter(object):
    enabled = False

    def span(self, name, start_ns, end_ns, phase=TRACE_REQUEST, nbytes=0,
             group=0, cycle=0):
        pass


class ShardEmitter(object):
    """Appends span lines to one shard file; thread-safe, line-buffered."""

    enabled = True

    def __init__(self, path, rank, size):
        self._lock = threading.Lock()
        fresh = not os.path.exists(path)
        self._f = open(path, "a")
        if fresh:
            self._f.write(json.dumps({
                "hvd_trace_shard": 1, "rank": rank, "size": size,
                "generation": 0, "pid": os.getpid(), "ring": 0,
            }) + "\n")
            self._f.flush()

    def span(self, name, start_ns, end_ns, phase=TRACE_REQUEST, nbytes=0,
             group=0, cycle=0):
        line = json.dumps({"n": name, "p": phase, "g": group, "c": cycle,
                           "pe": -1, "b": nbytes, "s": start_ns,
                           "e": end_ns, "f": 0}) + "\n"
        with self._lock:
            self._f.write(line)
            self._f.flush()


def now_ns():
    """Monotonic nanoseconds, the clock family of the native recorder."""
    return time.monotonic_ns()


def shard_for(tag, rank=0, size=0):
    """The process-wide emitter for a shard named ``trace_<tag>.jsonl``.

    Returns a no-op object when HVD_TPU_TRACE_DIR is unset. ``tag``
    should be filesystem-safe and unique per process (e.g. ``"serve_r2"``
    for replica 2) so co-located processes never interleave writes in one
    file.
    """
    trace_dir = os.environ.get("HVD_TPU_TRACE_DIR", "")
    if not trace_dir:
        return _NullEmitter()
    with _lock:
        em = _shards.get(tag)
        if em is None:
            try:
                os.makedirs(trace_dir, exist_ok=True)
                path = os.path.join(trace_dir, "trace_%s.jsonl" % tag)
                em = ShardEmitter(path, rank, size)
            except OSError:
                em = _NullEmitter()
            _shards[tag] = em
        return em
