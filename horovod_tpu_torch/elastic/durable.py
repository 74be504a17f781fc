"""Durable elastic checkpoints: async sharded snapshots with
torn-write-proof restore (docs/ELASTIC.md "Durability").

Counterpart of ``horovod_tpu/elastic/durable.py``, with its on-disk format
(``ckpt-<step>-g<generation>/`` directories of CRC32C-named shards and a
rank-0 ``MANIFEST.json``), so the port reads the reference's checkpoints.

* **Async**: every Nth ``commit()`` hands its snapshot (tensors on their
  own devices) to a background writer thread and returns: the training
  loop never waits on storage. The snapshots stay on the device until
  written: the committed one, and at most three queued (two sticky, one
  pending). The writer stages one tensor at a time into pinned host
  memory on a side stream (after the commit's event) and pickles the
  shard straight into its file (protocol 5, each tensor's bytes in-band
  as they are, never gathered into one bytes object), chaining the CRC32C
  over what it writes. The copies, the CRC and the writes run without the
  GIL; what they still cost the trainer's steps is measured by
  chip_smoke.py's ``launch`` phase (PERF.md), which also reports the peak
  device memory.
* **Sharded**: each rank writes only the leaves assigned to it
  (``leaf_index % world_size == rank``); rank 0 publishes the manifest
  once all shards of the step exist.
* **Atomic + torn-write-proof**: every file goes to ``*.tmp`` -> ``fsync``
  -> ``rename``; the manifest is written last; restore validates every
  shard's size and CRC32C and falls back to the newest *valid* manifest.
* **Fail-soft**: storage failures retry with capped backoff, then
  degrade to a warning; a durable write can never kill training.

CRC32C is ``native/checksum.cc`` (a copy of the reference's, slicing-by-8),
built with ``g++`` at first use into ``elastic/_build/`` and loaded with
ctypes. A build failure raises ``CrcBuildError``: there is no quiet
fall-back to the pure-Python ``_py_crc32c`` (about 1 MB/s, the plain
version the tests hold the library against).

A tensor leaf is written as its host bytes with its dtype and shape
(bfloat16 as its 16-bit pattern): ``("horovod_tpu_torch.tensor", dtype,
shape, uint8 array)``; it is read back as a CPU tensor and lands on the
device of the state's tensor (``State._assign``). Rank 0's shard also holds
the committed trees' structure (``"@structure"``), so a state whose
structure grew since (an optimizer that has not stepped yet in a fresh
process) restores it. Reference checkpoints (numpy leaves, no
``"@structure"``) restore into a state of the same structure.

Restore is rank-0-read + broadcast (through ``State.sync()``), so the
restoring job's world size is free to differ from the saved one.

Storage fault injection (seeded, deterministic)::

    HVD_TPU_CKPT_FAULT_SPEC := clause (';' clause)*
    clause := 'seed=N' | rule
    rule   := field (',' field)*
    field  := 'op=shard|manifest|any'   which file kind to hit
            | 'rank=N'                  only this rank's writer
            | 'write=N'                 fire at the Nth matching write
            | 'prob=P'                  fire with probability P (seeded)
            | 'count=K'                 max fires (default 1 for write=,
                                        unlimited for prob=)
            | 'action=torn|bitflip|enospc|slowfsync'
            | 'delay_ms=D'              slowfsync duration (default 1000)

Action semantics:

* ``torn``     the file is truncated to half its bytes but still
               renamed into place; restore detects the size/CRC mismatch.
* ``bitflip``  one payload byte is flipped after the CRC was computed;
               restore detects the CRC mismatch.
* ``enospc``   the write raises ``OSError(ENOSPC)`` — exercises the
               retry/degrade path.
* ``slowfsync`` fsync sleeps ``delay_ms`` — exercises writer/training
               overlap (commit latency must not inflate).

This module imports no torch at import time.
"""

import ctypes
import errno
import fcntl
import hashlib
import json
import os
import pickle
import random
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

from .state import _is_tensor, _tree_flatten, _tree_map_leaves

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_FORMAT = 1

# ckpt-<step, zero-padded so lexical order == numeric order>-g<generation>
_CKPT_DIR_RE = re.compile(r"^ckpt-(\d{12})-g(\d+)$")
# shard-<rank>-of-<world>.<crc32c hex8>.<bytes>.bin
_SHARD_RE = re.compile(r"^shard-(\d{5})-of-(\d{5})\.([0-9a-f]{8})\.(\d+)"
                       r"\.bin$")


def _log(msg):
    sys.stderr.write("[durable] %s\n" % msg)
    sys.stderr.flush()


# ---------------------------------------------------------------------------
# CRC32C: the native library (built at first use); the Python loop is its
# plain version

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# -Bsymbolic: the library's own calls stay its own in a process that also
# loaded the reference's core (RTLD_GLOBAL), whose symbols share the names
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wl,-Bsymbolic")

_PY_TABLE = None


def _py_crc32c(data, crc=0):
    """Pure-Python CRC32C (Castagnoli, reflected 0x82F63B78), bit-exact
    with native/checksum.cc (same ~crc pre/post conditioning, so
    incremental chaining interoperates). About 1 MB/s: the plain version
    the tests hold the native library against, never the writer's."""
    global _PY_TABLE
    if _PY_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
            table.append(c)
        _PY_TABLE = table
    crc ^= 0xFFFFFFFF
    for b in bytes(data):
        crc = _PY_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class CrcBuildError(RuntimeError):
    """g++ is missing or refused ``native/checksum.cc``."""


def native_library_path():
    """The crc32c library's path; its name carries a hash of the sources
    and flags, so an edited source is rebuilt."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in ("checksum.h", "checksum.cc"):
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / ("libcrc32c.%s.so" % h.hexdigest()[:16])


_native = None


def _library():
    global _native
    if _native is None:
        path = native_library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)  # one build at a time
                if not path.exists():
                    cxx = os.environ.get("CXX") or shutil.which("g++") or \
                        shutil.which("c++")
                    if not cxx:
                        raise CrcBuildError(
                            "no C++ compiler (g++, c++ or $CXX) to build "
                            "the durable checkpoints' crc32c")
                    tmp = path.with_suffix(".tmp%d" % os.getpid())
                    proc = subprocess.run(
                        [cxx, *CXX_FLAGS, "-o", str(tmp),
                         str(NATIVE_DIR / "checksum.cc")],
                        capture_output=True, text=True)
                    if proc.returncode != 0:
                        tmp.unlink(missing_ok=True)
                        raise CrcBuildError(
                            "%s failed on native/checksum.cc (rc %d):\n%s"
                            % (cxx, proc.returncode, proc.stderr))
                    os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        fn = lib.hvd_torch_crc32c
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
        fn.restype = ctypes.c_uint32
        _native = fn
    return _native


def crc32c(data, crc=0):
    """CRC32C over `data` (bytes, a buffer, a numpy array or a contiguous
    CPU tensor), chained from `crc` (start at 0), by the native library
    (built at first use; ``CrcBuildError`` if it cannot be)."""
    fn = _library()
    if _is_tensor(data):
        if data.device.type != "cpu" or not data.is_contiguous():
            raise ValueError("crc32c takes a contiguous CPU tensor")
        return fn(data.data_ptr(), data.numel() * data.element_size(), crc)
    if isinstance(data, bytes):
        return fn(ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p),
                  len(data), crc)
    import numpy as np
    view = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    return fn(view.ctypes.data, view.nbytes, crc)


# ---------------------------------------------------------------------------
# Storage fault injection

_ACTIONS = ("torn", "bitflip", "enospc", "slowfsync")


class _FaultRule:
    __slots__ = ("op", "rank", "write", "prob", "count", "action",
                 "delay_ms", "seen")

    def __init__(self):
        self.op = None        # 'shard' | 'manifest' | None = any
        self.rank = -1        # -1 = any
        self.write = -1       # fire at Nth matching write (0-based)
        self.prob = 0.0
        self.count = None     # remaining fires; None = default
        self.action = None
        self.delay_ms = 1000
        self.seen = 0


class CkptFaultInjector:
    """Deterministic storage fault injector, configured from
    ``HVD_TPU_CKPT_FAULT_SPEC`` (grammar in the module docstring).
    Mirrors ``native/fault``'s seeded-PRNG design: a given (spec, rank)
    replays the same fault sequence every run."""

    def __init__(self, spec=None, rank=0):
        self._rules = []
        self._rng = random.Random(0)
        self._rank = rank
        self.fires = 0
        if spec:
            self._parse(spec)

    @property
    def active(self):
        return bool(self._rules)

    def _parse(self, spec):
        seed = 0
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                seed = int(clause[5:])
                continue
            rule = _FaultRule()
            for field in clause.split(","):
                field = field.strip()
                if not field:
                    continue
                key, _, val = field.partition("=")
                if key == "op":
                    rule.op = None if val == "any" else val
                    if rule.op not in (None, "shard", "manifest"):
                        raise ValueError("bad op=%s" % val)
                elif key == "rank":
                    rule.rank = int(val)
                elif key == "write":
                    rule.write = int(val)
                elif key == "prob":
                    rule.prob = float(val)
                elif key == "count":
                    rule.count = int(val)
                elif key == "action":
                    if val not in _ACTIONS:
                        raise ValueError("bad action=%s" % val)
                    rule.action = val
                elif key == "delay_ms":
                    rule.delay_ms = int(val)
                else:
                    raise ValueError(
                        "unknown ckpt fault field %r" % field)
            if rule.action is None:
                raise ValueError("ckpt fault rule without action=: %r"
                                 % clause)
            if rule.count is None:
                rule.count = 1 if rule.write >= 0 else -1
            self._rules.append(rule)
        self._rng = random.Random(seed * 1000003 + self._rank)

    def on_write(self, op):
        """Returns (action, delay_ms) for this write, or (None, 0).
        `op` is 'shard' or 'manifest'. Counted per rule over matching
        writes, like the transport injector's frame counters."""
        for rule in self._rules:
            if rule.op is not None and rule.op != op:
                continue
            if rule.rank >= 0 and rule.rank != self._rank:
                continue
            idx = rule.seen
            rule.seen += 1
            if rule.count == 0:
                continue
            if rule.write >= 0:
                if idx != rule.write:
                    continue
            elif rule.prob > 0.0:
                if self._rng.random() >= rule.prob:
                    continue
            else:
                continue
            if rule.count > 0:
                rule.count -= 1
            self.fires += 1
            return rule.action, rule.delay_ms
        return None, 0


# ---------------------------------------------------------------------------
# On-disk format helpers

def _ckpt_dirname(step, generation):
    return "ckpt-%012d-g%d" % (step, generation)


def _shard_name(rank, world_size, crc, nbytes):
    return "shard-%05d-of-%05d.%08x.%d.bin" % (rank, world_size, crc,
                                               nbytes)


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass  # some filesystems refuse directory fsync; rename is done


def _atomic_write(path, data, injector=None, op="shard"):
    """data -> path.tmp -> fsync -> rename; returns the final path.
    ``data`` is bytes, or a function that writes the content to the open
    file and returns the final path (a shard is named by its CRC and size,
    known once it is written). Fault-injection hooks sit exactly where a
    real storage failure would: ENOSPC at write time, a flipped byte or
    torn content after the content (and its CRC) was written, slow fsync
    before the fsync."""
    action, delay_ms = (None, 0)
    if injector is not None and injector.active:
        action, delay_ms = injector.on_write(op)
    if action == "enospc":
        raise OSError(errno.ENOSPC, "injected ENOSPC (%s)" % op)
    tmp = path + ".tmp"
    with open(tmp, "w+b") as f:
        if callable(data):
            path = data(f)
        else:
            f.write(data)
        f.flush()
        size = f.seek(0, os.SEEK_END)
        if action == "bitflip":
            f.seek(size // 2)
            byte = f.read(1)[0]
            f.seek(size // 2)
            f.write(bytes([byte ^ 0x40]))
        elif action == "torn":
            f.truncate(max(1, size // 2))
        f.flush()
        if action == "slowfsync":
            time.sleep(delay_ms / 1000.0)
        os.fsync(f.fileno())
    os.rename(tmp, path)
    _fsync_dir(os.path.dirname(path))
    return path


def _leaf_items(committed):
    """Flattens a committed attribute dict into an ordered list of
    (path, leaf) — the deterministic order every rank derives shard
    assignment from."""
    return _tree_flatten(committed)


TENSOR_TAG = "horovod_tpu_torch.tensor"
STRUCTURE_KEY = "@structure"


def _tagged(leaf):
    """A leaf as a shard holds it: a tensor as (TENSOR_TAG, dtype, shape,
    the tensor), which ``_ShardPickler`` writes with the tensor's bytes as
    a uint8 numpy array; anything else as it is."""
    if not _is_tensor(leaf):
        return leaf
    return (TENSOR_TAG, str(leaf.dtype).split(".")[-1], tuple(leaf.shape),
            leaf)


def _cpu_bytes(t):
    """A CPU tensor's bytes as a uint8 numpy array (its own memory where
    it is contiguous)."""
    import torch
    return t.detach().reshape(-1).contiguous().view(torch.uint8).numpy()


def decode_leaf(value):
    """Inverse of ``_tagged`` as pickled: a tagged tuple becomes a CPU tensor of
    its dtype and shape; anything else passes."""
    if isinstance(value, tuple) and len(value) == 4 and \
            value[0] == TENSOR_TAG:
        import torch
        _, dtype, shape, raw = value
        return torch.from_numpy(raw).view(getattr(torch, dtype)).reshape(
            shape)
    return value


def _structure(committed):
    """The committed trees with every leaf replaced by None."""
    return _tree_map_leaves(committed, iter(
        [None] * len(_tree_flatten(committed))))


def list_checkpoints(directory):
    """[(step, generation, dirpath)] sorted newest-first, for every
    ckpt-* directory (valid or not)."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        m = _CKPT_DIR_RE.match(name)
        if m:
            out.append((int(m.group(1)), int(m.group(2)),
                        os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def read_manifest(ckpt_dir):
    """The manifest of one checkpoint directory when it parses and names
    its shards, else None (never raises). The shards are not looked at:
    ``validate_manifest`` checks them, or ``load_leaves(verify=True)`` on
    its one read."""
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    try:
        with open(path, "rb") as f:
            raw = f.read()
        manifest = json.loads(raw.decode("utf-8"))
    except (OSError, ValueError, UnicodeDecodeError):
        return None
    if not isinstance(manifest, dict) or \
            manifest.get("format") != MANIFEST_FORMAT:
        return None
    shards = manifest.get("shards")
    if not isinstance(shards, list) or not shards:
        return None
    return manifest


def validate_manifest(ckpt_dir, deep=True):
    """Loads and validates one checkpoint directory: manifest parses,
    every shard exists with the manifested byte size — and, when `deep`
    (the restore path), the manifested CRC32C over the actual bytes.
    `deep=False` (a stat per shard, no data read) is for bookkeeping
    like retention, where re-reading every byte of every kept
    checkpoint on each publish would tax the very storage the writer is
    protecting against. Returns the manifest dict or None (never
    raises)."""
    manifest = read_manifest(ckpt_dir)
    if manifest is None:
        return None
    for shard in manifest["shards"]:
        try:
            spath = os.path.join(ckpt_dir, shard["file"])
            if not deep:
                if os.stat(spath).st_size != int(shard["bytes"]):
                    return None
                continue
            with open(spath, "rb") as f:
                data = f.read()
            if len(data) != int(shard["bytes"]):
                return None
            if crc32c(data) != int(shard["crc32c"]):
                return None
        except (OSError, KeyError, TypeError, ValueError):
            return None
    return manifest


def latest_valid_manifest(directory, deep=True):
    """Scans newest-first and returns (manifest, ckpt_dir) for the
    newest checkpoint whose manifest AND every shard validate; (None,
    None) when nothing valid exists. A torn manifest, a missing shard,
    or a flipped bit simply moves the scan to the next-older
    candidate. `deep=False` validates names/sizes only (report-style
    callers; the restore path verifies CRCs on its single read via
    load_leaves(verify=True))."""
    for step, gen, path in list_checkpoints(directory):
        manifest = validate_manifest(path, deep=deep)
        if manifest is not None:
            return manifest, path
    return None, None


def load_leaves(manifest, ckpt_dir, verify=False):
    """Reads every shard of a checkpoint and returns the full
    {path: leaf} dict (rank-0 side of the restore), tensors decoded as CPU
    tensors, and the structure at ``STRUCTURE_KEY`` when the port wrote
    the checkpoint. With `verify`,
    checks each shard's manifested byte size and CRC32C on the SAME
    read (raising ValueError on mismatch) — so restore pays one pass
    over the bytes, not a deep-validate pass plus a load pass."""
    leaves = {}
    for shard in manifest["shards"]:
        with open(os.path.join(ckpt_dir, shard["file"]), "rb") as f:
            data = f.read()
        if verify:
            if len(data) != int(shard["bytes"]):
                raise ValueError("shard %s: %d bytes, manifest says %s"
                                 % (shard["file"], len(data),
                                    shard["bytes"]))
            if crc32c(data) != int(shard["crc32c"]):
                raise ValueError("shard %s: CRC mismatch"
                                 % shard["file"])
        leaves.update({k: decode_leaf(v)
                       for k, v in pickle.loads(data).items()})
    return leaves


def prune_stale_tmp(directory):
    """Startup hygiene: removes ``*.tmp`` shards/manifests left by a
    crashed writer. Only safe when no writer is live (i.e. at job
    start, before the first durable commit). Returns the count."""
    removed = 0
    for step, gen, path in list_checkpoints(directory):
        try:
            names = os.listdir(path)
        except OSError:
            continue
        for name in names:
            if name.endswith(".tmp"):
                try:
                    os.remove(os.path.join(path, name))
                    removed += 1
                except OSError:
                    pass
    return removed


def prune_unrestorable(directory):
    """Startup hygiene, part two: removes checkpoint directories that do
    not validate (shallow: manifest + shard names/sizes) — unpublished
    leftovers (a crashed run renamed some shards but never the
    manifest) and torn ones. The point is not disk space: a RELAUNCHED
    run that trains back to the same (step, generation) would otherwise
    find a crashed predecessor's name-valid shard already in its
    directory and could splice it into a fresh manifest — a
    mixed-trajectory checkpoint whose every CRC validates. (Shallow is
    enough for the splice hazard: a content-corrupt shard that kept its
    size is caught by restore's verified read, and the publisher
    refuses ambiguous duplicate shards — deep-reading every byte of
    every checkpoint here would double every resume's I/O.) Same
    no-live-writer precondition as prune_stale_tmp; returns the removed
    directory names."""
    removed = []
    for step, gen, path in list_checkpoints(directory):
        if validate_manifest(path, deep=False) is None:
            try:
                shutil.rmtree(path)
                removed.append(os.path.basename(path))
            except OSError:
                pass
    return removed


def apply_retention(directory, keep=None):
    """Keeps the newest `keep` VALID checkpoints (HVD_TPU_CKPT_KEEP,
    default 3) and deletes everything older — including abandoned
    invalid directories older than the oldest kept checkpoint (a
    half-written step newer than the kept set is left alone: its
    writer may still be publishing). Returns removed dir names."""
    if keep is None:
        keep = int(os.environ.get("HVD_TPU_CKPT_KEEP", "3"))
    keep = max(1, keep)
    entries = list_checkpoints(directory)
    valid_seen = 0
    boundary = None  # (step, gen) of the oldest kept valid checkpoint
    removed = []
    for step, gen, path in entries:
        if valid_seen < keep:
            # Shallow check: names/sizes only. Deep-CRC'ing the newest
            # K checkpoints on EVERY publish would re-read ~K full
            # state copies per write against the store being protected.
            if validate_manifest(path, deep=False) is not None:
                valid_seen += 1
                boundary = (step, gen)
            continue
        # Beyond the kept set: every older dir goes, valid or not.
        if boundary is not None and (step, gen) < boundary:
            try:
                shutil.rmtree(path)
                removed.append(os.path.basename(path))
            except OSError:
                pass
    return removed


# ---------------------------------------------------------------------------
# Counters of this process's durable writes and restores (the reference
# feeds them to its native metrics registry, which the port has not yet:
# ROADMAP A8d)

METRICS = {"writes": 0, "failures": 0, "bytes": 0, "restores": 0,
           "restore_failures": 0, "last_step": -1, "write_seconds": [],
           "crc_seconds": [], "crc_bytes": 0, "shards": []}


def _ckpt_metrics(writes=0, failures=0, nbytes=0, restores=0,
                  restore_failures=0, last_step=-1, write_seconds=-1.0):
    METRICS["writes"] += writes
    METRICS["failures"] += failures
    METRICS["bytes"] += nbytes
    METRICS["restores"] += restores
    METRICS["restore_failures"] += restore_failures
    METRICS["last_step"] = max(METRICS["last_step"], last_step)
    if write_seconds >= 0:
        METRICS["write_seconds"].append(write_seconds)


# ---------------------------------------------------------------------------
# The async sharded writer

def _device_event(committed):
    """A CUDA event recorded on the current stream just after the
    snapshot's copies when the snapshot holds CUDA tensors (the writer's
    side stream waits on it before it reads them), else None."""
    if "torch" not in sys.modules:
        return None
    for _, leaf in _tree_flatten(committed):
        if _is_tensor(leaf) and leaf.is_cuda:
            import torch
            event = torch.cuda.Event()
            event.record()
            return event
    return None


_SIDE_STREAMS = {}


class _Stager:
    """A tensor's bytes on the host, as a uint8 numpy array, one tensor at
    a time: a CPU tensor's own memory; a CUDA tensor's copied, on a side
    stream of its device after the commit's ``event``, into the front of
    ``pinned``'s buffer (one pinned buffer a writer, grown to the largest
    tensor and reused: a pinned allocation stalls the process's other
    CUDA calls). The pickler has written a tensor's bytes before it asks
    for the next. Counts its seconds."""

    def __init__(self, event, pinned):
        self.event = event
        self.pinned = pinned  # {"buffer": a pinned uint8 tensor or None}
        self.seconds = 0.0
        self._waited = set()

    def __call__(self, t):
        t0 = time.perf_counter()
        if not t.is_cuda:
            out = _cpu_bytes(t)
        else:
            import torch
            stream = _SIDE_STREAMS.get(t.device)
            if stream is None:
                stream = _SIDE_STREAMS[t.device] = torch.cuda.Stream(
                    t.device)
            n = t.numel() * t.element_size()
            buf = self.pinned.get("buffer")
            if buf is None or buf.numel() < n:
                buf = self.pinned["buffer"] = None  # free the old first
                buf = self.pinned["buffer"] = torch.empty(
                    n, dtype=torch.uint8, pin_memory=True)
            host = buf[:n]
            with torch.cuda.stream(stream):
                if t.device not in self._waited and self.event is not None:
                    stream.wait_event(self.event)
                    self._waited.add(t.device)
                host.copy_(t.detach().reshape(-1).contiguous().view(
                    torch.uint8), non_blocking=True)
            stream.synchronize()
            out = host.numpy()
        self.seconds += time.perf_counter() - t0
        return out


class _ShardPickler(pickle.Pickler):
    """Pickles a shard straight into its file (protocol 5): each tensor's
    bytes come from ``stage`` when the pickler reaches the tensor, and go
    to the file in-band as they are, never gathered into one bytes object
    (``pickle.loads`` reads the file as any pickle)."""

    def __init__(self, f, stage):
        super().__init__(f, protocol=5)
        self._stage = stage

    def reducer_override(self, obj):
        if _is_tensor(obj):
            return self._stage(obj).__reduce_ex__(5)
        return NotImplemented


class _CrcWriter:
    """A file's ``write`` that chains the CRC32C of what it writes and
    counts the bytes and the seconds of the CRC and of the writes."""

    def __init__(self, f):
        self.f = f
        self.crc = self.nbytes = 0
        self.crc_seconds = self.io_seconds = 0.0

    def write(self, data):
        t0 = time.perf_counter()
        self.crc = crc32c(data, self.crc)
        t1 = time.perf_counter()
        self.f.write(data)
        self.io_seconds += time.perf_counter() - t1
        self.crc_seconds += t1 - t0
        n = memoryview(data).nbytes
        self.nbytes += n
        return n


class DurableCheckpointer:
    """Background durable-snapshot writer for one rank.

    ``maybe_enqueue`` is called from ``State.commit()`` with the
    snapshot ``State.save()`` just made (its own copy of every tensor, on
    the tensor's device; ``save()`` replaces the committed dict
    wholesale, so the reference handed here is immutable from the
    trainer's perspective — zero extra copies on the commit path). The
    writer thread copies this rank's leaves to the host, serializes its
    shard, fsyncs, renames; rank 0 additionally waits for the other
    shards and publishes the manifest.
    """

    def __init__(self, directory, every_n_commits=None, interval_s=None,
                 fault_spec=None, rank=None, world_size=None,
                 publish_timeout=None):
        self.directory = os.path.abspath(directory)
        if every_n_commits is None:
            every_n_commits = int(os.environ.get(
                "HVD_TPU_CKPT_EVERY_N_COMMITS", "1"))
        if interval_s is None:
            raw = os.environ.get("HVD_TPU_CKPT_INTERVAL_S")
            interval_s = float(raw) if raw else None
        self.every_n_commits = max(1, int(every_n_commits))
        self.interval_s = interval_s
        self._publish_timeout = publish_timeout if publish_timeout \
            is not None else float(os.environ.get(
                "HVD_TPU_CKPT_PUBLISH_TIMEOUT", "120"))
        self._retries = int(os.environ.get("HVD_TPU_CKPT_RETRIES", "3"))
        self._commit_index = 0
        self._sticky_every = max(1, int(os.environ.get(
            "HVD_TPU_CKPT_STICKY_EVERY", "8")))
        self._last_bucket = None
        self._last_step_bucket = None
        self._rank_override = rank
        self._size_override = world_size
        self.last_durable_step = -1

        if fault_spec is None:
            fault_spec = os.environ.get("HVD_TPU_CKPT_FAULT_SPEC", "")
        self._injector = CkptFaultInjector(fault_spec, self._rank())

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # Three-slot queue (bounded at 3 buffered snapshots, never more):
        # the sticky slots hold STICKY snapshots — rank-deterministic
        # 1-in-sticky_every commits that every rank writes and that
        # newer non-sticky snapshots may not displace. Without them,
        # each rank's latest-wins skipping follows its own writer
        # timing, and two ranks under storage slower than the commit
        # cadence can stably anti-align (rank 0 landing only even
        # steps, rank 1 only odd) so that NO manifest ever publishes
        # mid-run. `_sticky_head` is the OLDEST sticky not yet WRITTEN:
        # it stays in its slot while the writer writes it
        # (`_head_taken`), and is never displaced. `_sticky_next` is
        # latest-wins among the stickies that arrive before the head is
        # written. Keeping the head until it is written (the reference
        # frees the slot when the writer takes the job) makes the set of
        # written stickies independent of when the writer thread wakes:
        # in the reference, a writer that took the first sticky before
        # the next arrived wrote one sticky more, and with the newest
        # snapshot four checkpoints then outnumbered the retention of
        # three and dropped the first (its sticky-snapshot test failed
        # on that race). `_pending` holds the newest non-sticky snapshot,
        # so the most recent commit still always becomes durable once
        # the writer drains (clean-exit flush included); a sticky newer
        # than it supersedes it.
        self._sticky_head = None
        self._head_taken = False
        self._sticky_next = None
        self._pending = None   # newest (snapshot, step, gen, rank, size)
        self._inflight = False
        self._stop = False
        self._thread = None
        self._pinned = {"buffer": None}  # the writer's staging buffer

    # -- topology ---------------------------------------------------------
    def _rank(self):
        if self._rank_override is not None:
            return self._rank_override
        if "torch" in sys.modules:
            from horovod_tpu_torch.common import basics
            if basics.is_initialized():
                return basics.rank()
        return int(os.environ.get("HVD_TPU_RANK", "0") or 0)

    def _size(self):
        if self._size_override is not None:
            return self._size_override
        if "torch" in sys.modules:
            from horovod_tpu_torch.common import basics
            if basics.is_initialized():
                return basics.size()
        return int(os.environ.get("HVD_TPU_SIZE", "1") or 1)

    @staticmethod
    def _generation():
        return int(os.environ.get("HVD_TPU_GENERATION", "0") or 0)

    # -- trigger ----------------------------------------------------------
    def _due(self, now, step):
        """(due, sticky) for THIS commit. Both decisions must be
        RANK-UNIFORM — every rank has to write the same durable steps
        (else rank 0's manifests wait on shards nobody writes), and the
        same sticky steps (or the convergence anchor fails in exactly
        the slow-storage regime it exists for). So neither may derive
        from the process-local commit counter: an elastic replacement
        joining mid-run starts its counter at 0 while survivors are
        further along, offsetting the cadences for the rest of the run.
        Counter mode therefore keys on the state's `step` value
        (broadcast by sync(), identical everywhere including mid-job
        joiners); interval mode on absolute wall-clock bucket numbers
        (shared epoch; a boundary disagreement costs one abandoned
        manifest attempt, never a hang or a bad checkpoint). States
        without an integer ``step`` attribute fall back to the commit
        counter and get rank-uniformity only for workers that started
        together — documented in docs/ELASTIC.md."""
        first = self._commit_index == 0
        self._commit_index += 1
        if self.interval_s is not None:
            bucket = int(now / self.interval_s)
            sticky = first or bucket % self._sticky_every == 0
            if self._last_bucket is None:
                self._last_bucket = bucket
                return first, sticky
            if bucket > self._last_bucket:
                self._last_bucket = bucket
                return True, sticky
            return False, False
        # Step-bucket rule, not `step % stride == 0`: a commit cadence
        # whose step values never land on a stride multiple (commits at
        # steps 3, 8, 13, ... with stride 10) would otherwise silently
        # disable durability. A bucket CHANGE fires on the first commit
        # in each stride-sized window of steps — rank-uniform because
        # every rank commits the same step sequence. (A mid-job joiner's
        # very first commit may fire alone mid-bucket; its lone shard
        # becomes a manifest-less dir swept at the next startup prune.)
        bucket = step // self.every_n_commits
        due = bucket != self._last_step_bucket
        sticky = due and (self._last_step_bucket is None or
                          bucket % self._sticky_every == 0)
        if due:
            self._last_step_bucket = bucket
        return due, sticky

    # -- enqueue (trainer thread; never blocks on storage) ----------------
    def maybe_enqueue(self, committed, step):
        """Called under commit(). Hands the snapshot to the writer when
        this commit is due; replaces any not-yet-started pending
        snapshot (storage slower than the commit cadence skips
        intermediate snapshots instead of queueing them). Every
        sticky_every-th due commit goes to the sticky slot instead —
        commit-counter-deterministic, so every rank writes those exact
        steps and rank 0's manifests converge even when rank-local
        skipping anti-aligns (see the slot comments in __init__)."""
        if committed is None:
            return False
        step = int(step)
        due, sticky = self._due(time.time(), step)
        if not due:
            return False
        job = (committed, step, self._generation(), self._rank(),
               self._size(), sticky, _device_event(committed))
        with self._cv:
            if sticky:
                self._put_sticky_locked(job)
            else:
                self._pending = job
            self._start_locked()
        return True

    def _put_sticky_locked(self, job):
        if self._sticky_head is None:
            self._sticky_head = job
        else:
            # The head is pinned until written; newer stickies are
            # latest-wins among themselves.
            self._sticky_next = job
        if self._pending is not None and self._pending[1] <= job[1]:
            self._pending = None  # superseded by the newer sticky

    def _start_locked(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._writer_loop, name="hvd-durable-ckpt",
                daemon=True)
            self._thread.start()
        self._cv.notify()

    def force_enqueue(self, committed, step):
        """Unconditional enqueue into the STICKY slot, bypassing the
        ``_due`` cadence — the graceful-drain path (docs/FLEET.md):
        every rank force-writes the drained step's shard regardless of
        its local skip/cadence state, so the manifest for exactly the
        drained commit completes (not an older sticky anchor). Sticky
        placement means the publisher waits its full timeout and a
        racing non-sticky snapshot cannot displace it."""
        if committed is None:
            return False
        step = int(step)
        job = (committed, step, self._generation(), self._rank(),
               self._size(), True, _device_event(committed))
        with self._cv:
            # The drain is the job's final commit: land it in the
            # latest-wins sticky slot (behind any pinned unwritten
            # anchor, which the writer drains first anyway).
            self._put_sticky_locked(job)
            self._start_locked()
        # Keep the cadence bookkeeping coherent: the drained step's
        # window counts as written, so a post-drain survivor does not
        # immediately double-write it.
        self._last_step_bucket = step // self.every_n_commits
        return True

    def _take_pending_locked(self):
        """Next job for the writer: the sticky head (it stays in its slot
        until written), then the newest snapshot."""
        if self._sticky_head is not None and not self._head_taken:
            self._head_taken = True
            return self._sticky_head
        job = self._pending
        self._pending = None
        return job

    def _written_locked(self, job):
        if job is self._sticky_head:
            self._sticky_head = self._sticky_next
            self._sticky_next = None
            self._head_taken = False

    def _has_pending_locked(self):
        return self._pending is not None or (
            self._sticky_head is not None and not self._head_taken)

    def flush(self, timeout=None):
        """Blocks until the writer has drained (pending + in-flight).
        Called at clean training exit so the final commit is durable;
        also the test hook. Returns True when drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._has_pending_locked() or self._inflight:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cv.wait(remaining if remaining is not None else 1.0)
        return True

    def stop(self):
        with self._cv:
            self._stop = True
            self._cv.notify()

    # -- writer thread -----------------------------------------------------
    def _writer_loop(self):
        while True:
            with self._cv:
                while not self._has_pending_locked() and not self._stop:
                    self._cv.wait(1.0)
                if self._stop and not self._has_pending_locked():
                    return
                job = self._take_pending_locked()
                self._inflight = True
            try:
                self._write_with_retries(*job)
            finally:
                with self._cv:
                    self._written_locked(job)
                    self._inflight = False
                    self._cv.notify_all()

    def _write_with_retries(self, committed, step, generation, rank,
                            world_size, sticky=False, event=None):
        backoff = 0.1
        for attempt in range(self._retries + 1):
            try:
                t0 = time.monotonic()
                nbytes, durable = self._write_snapshot(
                    committed, step, generation, rank, world_size,
                    sticky=sticky, event=event)
                dt = time.monotonic() - t0
                if not durable:
                    # Abandoned publish: the failure was already logged
                    # and counted inside _publish_manifest; claiming the
                    # write would advance the recovery point past what a
                    # restore can actually find.
                    return False
                # Monotonic max, mirroring the native gauge's CAS: the
                # two-slot queue can legally write a displaced older
                # snapshot AFTER a newer sticky one.
                self.last_durable_step = max(self.last_durable_step,
                                             step)
                _ckpt_metrics(writes=1, nbytes=nbytes, last_step=step,
                              write_seconds=dt)
                return True
            except OSError as e:
                if attempt >= self._retries:
                    _log("durable write for step %d FAILED after %d "
                         "attempts (%s); training continues, last "
                         "durable step remains %d"
                         % (step, attempt + 1, e, self.last_durable_step))
                    _ckpt_metrics(failures=1)
                    return False
                time.sleep(backoff)
                backoff = min(backoff * 2, 5.0)
            except Exception as e:
                # Non-storage failure (e.g. an unpicklable state leaf):
                # deterministic, so retrying cannot help — degrade
                # immediately. Catching it HERE keeps the writer thread
                # alive for later (possibly fixed) snapshots; letting it
                # escape would kill the thread and silently disable
                # durability for the rest of the run.
                _log("durable write for step %d FAILED (%s: %s); "
                     "training continues, last durable step remains %d"
                     % (step, type(e).__name__, e,
                        self.last_durable_step))
                _ckpt_metrics(failures=1)
                return False

    def _write_snapshot(self, committed, step, generation, rank,
                        world_size, sticky=False, event=None):
        """One rank's durable write: serialize this rank's leaves,
        atomic-write the shard; on rank 0, wait for the sibling shards
        and publish the manifest. Returns (bytes_written, durable):
        durable is False when rank 0 had to abandon the manifest — the
        step is NOT recoverable and must not advance last_durable_step
        or the write counters (the operator would be told a recovery
        point that does not exist)."""
        ckpt_dir = os.path.join(self.directory,
                                _ckpt_dirname(step, generation))
        os.makedirs(ckpt_dir, exist_ok=True)

        t0 = time.perf_counter()
        mine = {path: _tagged(leaf) for i, (path, leaf)
                in enumerate(_leaf_items(committed))
                if i % world_size == rank}
        if rank == 0:
            mine[STRUCTURE_KEY] = _structure(committed)
        stage = _Stager(event, self._pinned)
        out = None
        dump = [0.0]

        def write(f):
            nonlocal out
            out = _CrcWriter(f)
            t = time.perf_counter()
            _ShardPickler(out, stage).dump(mine)
            dump[0] = time.perf_counter() - t
            return os.path.join(ckpt_dir, _shard_name(
                rank, world_size, out.crc, out.nbytes))

        _atomic_write(os.path.join(ckpt_dir, "shard-%05d-of-%05d"
                                   % (rank, world_size)), write,
                      injector=self._injector, op="shard")
        seconds = time.perf_counter() - t0
        METRICS["crc_seconds"].append(out.crc_seconds)
        METRICS["crc_bytes"] += out.nbytes
        METRICS["shards"].append({
            "step": step, "bytes": out.nbytes, "seconds": seconds,
            "stage_seconds": stage.seconds, "crc_seconds": out.crc_seconds,
            "write_seconds": out.io_seconds,
            "pickle_seconds": dump[0] - stage.seconds - out.crc_seconds -
            out.io_seconds,
            "fsync_seconds": seconds - dump[0]})  # flush, fsync, rename

        durable = True
        if rank == 0:
            # Only the publishing rank can know whether the step became
            # restorable; non-zero ranks report shard-level durability
            # (rank 0's gauge is the authoritative recovery point).
            durable = self._publish_manifest(ckpt_dir, step, generation,
                                             world_size,
                                             sorted(committed),
                                             sticky=sticky)
        return out.nbytes, durable

    def _publish_manifest(self, ckpt_dir, step, generation, world_size,
                          attrs, sticky=False):
        """Rank 0: wait until all `world_size` shards of this step have
        been renamed into place (their names carry size+CRC, so no
        cross-rank channel is needed), then atomically publish the
        manifest. A missing shard past the timeout — or past the moment
        a NEWER snapshot is already pending (latest-wins applies to
        publishing too: when storage outpacing makes ranks skip
        different steps, waiting the full timeout per divergent step
        would serialize the writer on dead waits) — abandons the
        attempt with a warning; the next durable commit retries from
        scratch. STICKY steps are exempt from the newer-pending early
        abandon: every rank is guaranteed to write them, so waiting is
        productive and their publish is what bounds how long the job
        can run with zero durable progress."""
        deadline = time.monotonic() + self._publish_timeout
        while True:
            shards = {}
            duplicates = []
            try:
                names = os.listdir(ckpt_dir)
            except OSError:
                names = []
            for name in names:
                m = _SHARD_RE.match(name)
                if m and int(m.group(2)) == world_size:
                    r = int(m.group(1))
                    if r in shards:
                        duplicates.append(name)
                        continue
                    shards[r] = {
                        "file": name,
                        "crc32c": int(m.group(3), 16),
                        "bytes": int(m.group(4)),
                    }
            if duplicates:
                # Two same-rank shards with different content can only
                # mean leftovers from another run's trajectory landed in
                # this directory; guessing would publish a manifest
                # mixing trajectories with every CRC valid. Refuse.
                _log("abandoning manifest for %s: ambiguous duplicate "
                     "shard(s) %s" % (os.path.basename(ckpt_dir),
                                      duplicates))
                _ckpt_metrics(failures=1)
                return False
            if len(shards) >= world_size:
                break
            newer_pending = False
            if not sticky:
                with self._lock:
                    newer_pending = self._has_pending_locked()
            if newer_pending or time.monotonic() > deadline:
                missing = sorted(set(range(world_size)) - set(shards))
                _log("abandoning manifest for %s: shard(s) %s missing "
                     "%s" % (os.path.basename(ckpt_dir), missing,
                             "and a newer snapshot is pending"
                             if newer_pending else
                             "after %.0fs" % self._publish_timeout))
                _ckpt_metrics(failures=1)
                return False
            time.sleep(0.05)

        manifest = {
            "format": MANIFEST_FORMAT,
            "step": step,
            "generation": generation,
            "world_size": world_size,
            "attrs": attrs,
            "created_unix": time.time(),
            "shards": [shards[r] for r in sorted(shards)][:world_size],
        }
        data = json.dumps(manifest, indent=1).encode("utf-8")
        _atomic_write(os.path.join(ckpt_dir, MANIFEST_NAME), data,
                      injector=self._injector, op="manifest")
        apply_retention(self.directory)
        return True

    # -- restore (rank 0 reads; caller broadcasts via State.sync) ---------
    def restore_into(self, state):
        """Rank-0 side of auto-resume: loads the newest valid manifest's
        leaves into `state`'s attributes and returns the restored step, or
        None when no valid checkpoint exists / the structure does not
        match. The saved attributes must be the state's; their trees are
        the saved structure (a port checkpoint) or, for a reference
        checkpoint, the state's CURRENT structure, which must match leaf
        for leaf. Tensors land in place, on the devices of the state's
        tensors (``State._assign``). The caller must follow with
        ``state.sync()`` so every other rank — any world size — receives
        the values over the broadcast plane."""
        prune_stale_tmp(self.directory)
        removed = prune_unrestorable(self.directory)
        if removed:
            _log("pruned %d unrestorable checkpoint dir(s) left by a "
                 "previous run: %s" % (len(removed), removed[:5]))
        # Newest-first with CRC verification folded into the single
        # shard read (not a deep-validate pass PLUS a load pass): a
        # content-corrupt checkpoint surfaces as a ValueError here and
        # the scan silently falls back to the next-older candidate.
        for step, gen, ckpt_dir in list_checkpoints(self.directory):
            manifest = validate_manifest(ckpt_dir, deep=False)
            if manifest is None:
                continue
            try:
                leaves = load_leaves(manifest, ckpt_dir, verify=True)
            except Exception as e:
                _log("checkpoint %s failed verification (%s); falling "
                     "back to an older one"
                     % (os.path.basename(ckpt_dir), e))
                _ckpt_metrics(restore_failures=1)
                continue
            try:
                current = state._values()
                structure = leaves.pop(STRUCTURE_KEY, None)
                if structure is not None and \
                        sorted(structure) == sorted(current):
                    current = structure
                flat = _tree_flatten(current)
                missing = [p for p, _ in flat if p not in leaves]
                if missing or len(flat) != len(leaves):
                    # Fall back like any other validation failure: a
                    # foreign/renamed-attribute checkpoint as the newest
                    # entry must not shadow an older one that matches
                    # this state exactly.
                    _log("checkpoint %s does not match the state's "
                         "structure (%d saved leaves vs %d "
                         "registered%s); falling back to an older one"
                         % (os.path.basename(ckpt_dir), len(leaves),
                            len(flat),
                            ", missing %s" % missing[:3]
                            if missing else ""))
                    _ckpt_metrics(restore_failures=1)
                    continue
                rebuilt = _tree_map_leaves(
                    current, iter([leaves[p] for p, _ in flat]))
                for k, v in rebuilt.items():
                    state._assign(k, v)
                _ckpt_metrics(restores=1,
                              last_step=int(manifest["step"]))
                self.last_durable_step = int(manifest["step"])
                _log("restored step %d from %s (saved world size %d)"
                     % (manifest["step"], os.path.basename(ckpt_dir),
                        manifest["world_size"]))
                return int(manifest["step"])
            except Exception as e:
                # setattr/rebuild blew up half way — the state may hold
                # a partial mix of old and restored attributes, so
                # falling back to restore an OLDER checkpoint on top
                # could compound the damage. Start fresh, loudly.
                _log("restore from %s failed (%s); starting fresh"
                     % (ckpt_dir, e))
                _ckpt_metrics(restore_failures=1)
                return None
        return None


def last_durable_step(directory):
    """(step, ckpt_dir) of the newest valid checkpoint under
    `directory`, or (None, None) — the launcher failure summary's
    "what would a restart recover" report. Shallow validation: this is
    a log-line input, not a restore (which re-verifies CRCs on its own
    read anyway), so it must not re-read every checkpoint byte inside
    a teardown path."""
    manifest, path = latest_valid_manifest(directory, deep=False)
    if manifest is None:
        return None, None
    return int(manifest["step"]), path


def describe_last_durable(directory):
    """One operator-facing sentence: what a relaunch pointed at this
    checkpoint directory recovers. Shared by the static launcher's
    failure summary and the elastic driver's teardown report so the
    wording (and the definition of "durable") cannot drift between
    them."""
    step, path = last_durable_step(directory)
    if step is None:
        return ("no valid durable checkpoint under %s; a relaunch "
                "starts from scratch" % directory)
    return ("last durable checkpoint: step %d (%s); a relaunch with "
            "the same checkpoint directory resumes there"
            % (step, path))
