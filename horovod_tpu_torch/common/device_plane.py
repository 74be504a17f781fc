"""The executor of the negotiation core's device op: CUDA tensors under
the core's negotiation (ROADMAP A8c2).

The core negotiates a CUDA tensor as it does a host one: rank 0's
coordinator orders, validates and fuses what every rank has made ready,
and the response cache answers repeated names. Only the execution
differs. A response whose entries carry a CUDA ordinal (the request's
device, ``async_ops.device_id``) takes the device op
(``native/collective_operations.h``), which hands the whole response to
this module and returns "in progress", so the core's cycle never waits on
the card. The executor:

* takes the responses in the coordinator's order, the same on every rank
  (``horovod_tpu_device_next`` blocks outside the GIL), so the
  collectives it issues cannot cross between ranks whatever order the
  ranks enqueued in;
* on its own CUDA stream, waits on each entry's ready event (recorded on
  the caller's stream at enqueue), packs a fused response into a fusion
  buffer (one a device and dtype, grown to the largest fused response,
  at most ``HVD_TPU_FUSION_THRESHOLD``, and reused), applies
  each entry's prescale, runs one collective, applies the postscale and
  unpacks: allreduce, allgather (uneven first dimensions padded to the
  largest and compacted), broadcast, and reduce-scatter over
  ``shard_partition``. Under a wire mode (bf16, int8) a float32 allreduce
  or reduce-scatter runs ``parallel.ring``'s ring with the codec kernels
  on each hop;
* records a done event on its stream; a finalizer thread completes the
  entries (``horovod_tpu_device_done``) once the event has fired, so
  ``poll()`` is never True while a result is still being written. A
  failure becomes an error on every handle of the response.

The collectives run on a ``torch.distributed`` group of the executor's
own (NCCL when ``init()``'s group is NCCL, gloo otherwise), formed when
the core starts beside a running group (or when ``init()`` runs beside a
running core), and one such group a process group of ``new_group``:
never the group of the synchronous API and ``DistributedOptimizer``,
whose collectives, issued from another thread, could otherwise be ordered
differently on different ranks. The scale factors are applied as the
core's ``ScaleBuffer`` applies them to host tensors: the product in
double, cast back.
"""

import atexit
import contextlib
import ctypes
import queue
import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import core as _core

# Response types of native/message.h
ALLREDUCE, ALLGATHER, BROADCAST, REDUCESCATTER = 0, 1, 2, 4
# How long the executor waits in the core for a response before it looks
# at its stop flag again (ms)
_POLL_MS = 50
# How long the executor waits for the enqueuing thread to record a
# handle's tensors (the core may hand the response off before the enqueue
# call has returned to Python)
_RECORD_TIMEOUT_S = 60.0

_HVD_TO_TORCH = {
    _core.HVD_UINT8: torch.uint8, _core.HVD_INT8: torch.int8,
    _core.HVD_INT16: torch.int16, _core.HVD_INT32: torch.int32,
    _core.HVD_INT64: torch.int64, _core.HVD_FLOAT16: torch.float16,
    _core.HVD_FLOAT32: torch.float32, _core.HVD_FLOAT64: torch.float64,
    _core.HVD_BOOL: torch.bool, _core.HVD_BFLOAT16: torch.bfloat16}


class DevicePlaneError(RuntimeError):
    """A CUDA tensor was enqueued where no executor runs (the device plane
    needs ``init()``'s process group beside the core), or met an executor
    that is not NCCL's."""


class _Record:
    """The caller's tensors of one handle: ``src`` and ``dst`` (None for
    an allgather) and the ready event (None off the GPU)."""

    __slots__ = ("src", "dst", "ready")

    def __init__(self, src, dst, ready):
        self.src, self.dst, self.ready = src, dst, ready


_records = {}
_results = {}
_records_cv = threading.Condition()


def track(handle, src, dst, ready):
    """Records the tensors of a device handle, just after its enqueue."""
    with _records_cv:
        _records[handle] = _Record(src, dst, ready)
        _records_cv.notify_all()


def take_result(handle):
    """(done event or None, allgather result or None) of a completed
    device handle, and forgets the handle."""
    with _records_cv:
        _records.pop(handle, None)
        return _results.pop(handle, (None, None))


def _record(handle):
    with _records_cv:
        if not _records_cv.wait_for(lambda: handle in _records,
                                    _RECORD_TIMEOUT_S):
            raise RuntimeError("the tensors of handle %d were never "
                               "recorded" % handle)
        return _records[handle]


def _collective(new, old):
    """torch.distributed's ``new`` name of a collective where it has one
    (``all_gather_single``), else the ``old`` one."""
    return getattr(dist, new, None) or getattr(dist, old)


def _scale(t, factor):
    """``t *= factor`` in place, as the core's ScaleBuffer: the product in
    double, cast back to t's dtype (an integer truncates)."""
    if factor == 1.0 or t.dtype == torch.bool:
        return
    if t.dtype == torch.float64:
        t.mul_(factor)
    else:
        t.copy_(t.to(torch.float64).mul_(factor))


def _refuse_host_route(tensor, backend):
    """Raises where a CUDA tensor meets an executor that is not NCCL's:
    gloo would carry it through host memory."""
    if tensor.is_cuda and backend != "nccl":
        raise DevicePlaneError(
            "a tensor on %s met the device plane's %s executor, which "
            "would carry it through host memory: CUDA tensors go over "
            "NCCL, beside an init() on the GPU" % (tensor.device, backend))


def _wire_mode(compression, dtype):
    """The ring's wire mode for a negotiated compression id, or None where
    the plain collective runs (mode none, or a dtype other than float32:
    the core's effective mode)."""
    if compression == 0 or dtype != torch.float32:
        return None
    from horovod_tpu_torch.compression import resolve
    return resolve(int(compression))


class DevicePlane:
    """The executor: its groups, its stream, its fusion buffers and its
    two threads (the executor and the finalizer)."""

    def __init__(self, core, torch_world, backend, size):
        self.lib = core.lib
        self.torch_world = torch_world
        self.backend = backend
        # group id of the core -> (torch group, member world ranks)
        self.world = dist.new_group(ranks=list(range(size)),
                                    backend=backend)
        self.groups = {0: (self.world, list(range(size)))}
        # ProcessGroup -> the executor's torch group of its members
        self.subgroups = {}
        self.streams = {}
        self.buffers = {}
        self.responses = 0
        self._stop = threading.Event()
        self._done = queue.Queue()
        self._threads = []
        self.start()

    # -- lifecycle --------------------------------------------------------
    def start(self):
        """Starts the executor and finalizer threads if they are not
        running (after a restart of the core they have ended)."""
        if self._threads and all(t.is_alive() for t in self._threads):
            return
        self.stop()
        self._stop.clear()
        self._done = queue.Queue()
        self._threads = [
            threading.Thread(target=self._run_loop, daemon=True,
                             name="hvd-device-executor"),
            threading.Thread(target=self._finalize_loop, daemon=True,
                             name="hvd-device-finalizer")]
        for t in self._threads:
            t.start()

    def stop(self):
        """Stops both threads: the executor after the response it runs,
        the finalizer once the responses before it have completed."""
        self._stop.set()
        if self._threads:
            self._threads[0].join(timeout=10)
            self._done.put(None)
            self._threads[1].join(timeout=10)
        self._threads = []

    def add_group(self, pg):
        """The executor's torch group over a ``ProcessGroup``'s members
        (collective: every rank, in creation order), under the group's
        core id."""
        if pg not in self.subgroups:
            self.subgroups[pg] = dist.new_group(ranks=list(pg.ranks),
                                                backend=self.backend)
        self.groups[pg.core_id] = (self.subgroups[pg], list(pg.ranks))

    # -- the executor -----------------------------------------------------
    def _run_loop(self):
        while not self._stop.is_set():
            wid = self.lib.horovod_tpu_device_next(_POLL_MS)
            if wid < 0:
                return  # the core has stopped
            if wid == 0:
                continue
            try:
                self._execute(wid)
            except Exception as e:  # every handle of the response fails
                self.lib.horovod_tpu_device_done(
                    wid, 1, ("device collective failed: %s: %s"
                             % (type(e).__name__, e)).encode("utf-8"))

    def _finalize_loop(self):
        while True:
            item = self._done.get()
            if item is None:
                return
            wid, done = item
            try:
                done.synchronize()
            except Exception as e:
                self.lib.horovod_tpu_device_done(
                    wid, 1, ("device collective failed on the card: %s"
                             % e).encode("utf-8"))
            else:
                self.lib.horovod_tpu_device_done(wid, 0, b"")

    def _stream(self, device):
        if device not in self.streams:
            self.streams[device] = torch.cuda.Stream(device)
        return self.streams[device]

    def _buffer(self, device, dtype, numel):
        """The fusion buffer of (device, dtype), grown to ``numel``."""
        buf = self.buffers.get((device, dtype))
        if buf is None or buf.numel() < numel:
            buf = torch.empty(numel, dtype=dtype, device=device)
            self.buffers[(device, dtype)] = buf
        return buf[:numel]

    def _execute(self, wid):
        lib = self.lib
        info = (ctypes.c_int64 * 8)()
        if not lib.horovod_tpu_device_work_info(wid, info):
            raise RuntimeError("response %d is unknown to the core" % wid)
        rtype, hvd_dtype, n, root, comp, gid, nsizes, _ = list(info)
        entries = []
        for i in range(n):
            ids, scales = (ctypes.c_int64 * 2)(), (ctypes.c_double * 2)()
            lib.horovod_tpu_device_work_entry(wid, i, ids, scales)
            entries.append((int(ids[0]), _record(int(ids[0])),
                            scales[0], scales[1]))
        sizes = (ctypes.c_int64 * max(nsizes, 1))()
        lib.horovod_tpu_device_work_sizes(wid, sizes)
        if gid not in self.groups:
            raise RuntimeError("process group %d has no executor group on "
                               "this rank" % gid)
        group, members = self.groups[gid]
        src0 = entries[0][1].src
        _refuse_host_route(src0, self.backend)
        if src0.dtype != _HVD_TO_TORCH[hvd_dtype]:
            raise RuntimeError("response of %s for a %s tensor" % (
                _HVD_TO_TORCH[hvd_dtype], src0.dtype))
        cuda = src0.is_cuda
        stream = self._stream(src0.device) if cuda else None
        with (torch.cuda.device(src0.device) if cuda
              else contextlib.nullcontext()), \
                (torch.cuda.stream(stream) if cuda
                 else contextlib.nullcontext()):
            for _, rec, _, _ in entries:
                if rec.ready is not None:
                    stream.wait_event(rec.ready)
            if rtype == ALLREDUCE:
                self._allreduce(entries, comp, group)
            elif rtype == ALLGATHER:
                self._allgather(entries[0], list(sizes)[:nsizes], members,
                                group)
            elif rtype == BROADCAST:
                self._broadcast(entries[0], root, group)
            elif rtype == REDUCESCATTER:
                self._reduce_scatter(entries[0], comp, members, group)
            else:
                raise RuntimeError("response type %d on the device" % rtype)
            self.responses += 1
            if cuda:
                for _, rec, _, _ in entries:
                    rec.src.record_stream(stream)
                    if rec.dst is not None:
                        rec.dst.record_stream(stream)
                done = torch.cuda.Event()
                done.record(stream)
        with _records_cv:
            for handle, _, _, _ in entries:
                prior = _results.get(handle, (None, None))
                _results[handle] = (done if cuda else None, prior[1])
        if cuda:
            self._done.put((wid, done))
        else:
            lib.horovod_tpu_device_done(wid, 0, b"")

    def _reduce(self, work, comp, group):
        """Sums ``work`` in place over ``group``: the ring under a wire
        mode, else one collective (a bool as a logical or)."""
        mode = _wire_mode(comp, work.dtype)
        if mode is not None:
            from horovod_tpu_torch.parallel.ring import ring_allreduce
            work.copy_(ring_allreduce(work, group=group, compression=mode))
        elif work.dtype == torch.bool:
            wide = work.to(torch.uint8)
            dist.all_reduce(wide, op=dist.ReduceOp.MAX, group=group)
            work.copy_(wide)
        else:
            dist.all_reduce(work, group=group)

    def _allreduce(self, entries, comp, group):
        counts = [rec.src.numel() for _, rec, _, _ in entries]
        if len(entries) == 1:
            _, rec, _, _ = entries[0]
            work = rec.dst.view(-1)
            if rec.dst.data_ptr() != rec.src.data_ptr():
                work.copy_(rec.src.view(-1))
        else:
            src0 = entries[0][1].src
            work = self._buffer(src0.device, src0.dtype, sum(counts))
            for part, (_, rec, _, _) in zip(work.split(counts), entries):
                part.copy_(rec.src.view(-1))
        parts = work.split(counts)
        for part, (_, _, pre, _) in zip(parts, entries):
            _scale(part, pre)
        self._reduce(work, comp, group)
        for part, (_, rec, _, post) in zip(parts, entries):
            _scale(part, post)
            if len(entries) > 1:
                rec.dst.view(-1).copy_(part)

    def _broadcast(self, entry, root, group):
        _, rec, _, _ = entry
        if rec.dst.data_ptr() != rec.src.data_ptr():
            rec.dst.copy_(rec.src)
        dist.broadcast(rec.dst, src=root, group=group)

    def _allgather(self, entry, sizes, members, group):
        handle, rec, _, _ = entry
        src = rec.src
        k, top = len(members), max(sizes)
        rest = tuple(src.shape[1:])
        if src.shape[0] == top:
            padded = src
        else:
            padded = src.new_zeros((top,) + rest)
            padded[:src.shape[0]].copy_(src)
        out = src.new_empty((k * top,) + rest)
        if self.backend == "nccl":
            _collective("all_gather_single", "all_gather_into_tensor")(
                out, padded, group=group)
        else:
            dist.all_gather(list(out.chunk(k)), padded, group=group)
        if any(s != top for s in sizes):
            out = torch.cat([out[i * top:i * top + s]
                             for i, s in enumerate(sizes)])
        with _records_cv:
            _results[handle] = (None, out)

    def _reduce_scatter(self, entry, comp, members, group):
        from horovod_tpu_torch.common.async_ops import shard_partition
        from horovod_tpu_torch.compression import BLOCK
        _, rec, pre, post = entry
        flat = rec.src.reshape(-1)
        k = len(members)
        idx = members.index(_core.get_core().rank())
        counts, offsets = shard_partition(flat.numel(), k)
        mode = _wire_mode(comp, flat.dtype)
        # one row a rank, its chunk at the row's head: the codec's rows
        # are whole int8 blocks
        c = max(counts) if mode is None else \
            -(-max(max(counts), 1) // BLOCK) * BLOCK
        padded = flat.new_zeros(k * c)
        rows = padded.view(k, c)
        for i in range(k):
            rows[i, :counts[i]].copy_(flat[offsets[i]:offsets[i] + counts[i]])
        _scale(padded, pre)
        if mode is not None:
            from horovod_tpu_torch.parallel.ring import ring_reduce_scatter
            chunk = ring_reduce_scatter(padded, group=group,
                                        compression=mode)
        elif self.backend == "nccl":
            chunk = padded.new_empty(c)
            _collective("reduce_scatter_single", "reduce_scatter_tensor")(
                chunk, padded, group=group)
        else:
            self._reduce(padded, 0, group)
            chunk = rows[idx]
        out = rec.dst.view(-1)
        out.copy_(chunk[:counts[idx]])
        _scale(out, post)


_plane = None
_lock = threading.Lock()


def current():
    """The running executor, or None."""
    return _plane


def require(tensor):
    """The running executor for ``tensor``; ``DevicePlaneError`` without
    one, or where a CUDA tensor would meet a gloo executor."""
    plane = _plane
    if plane is None:
        raise DevicePlaneError(
            "a CUDA tensor goes through the negotiation core's device "
            "plane, which runs beside init()'s process group: call "
            "horovod_tpu_torch.init() before the asynchronous collectives "
            "of CUDA tensors")
    _refuse_host_route(tensor, plane.backend)
    return plane


def attach():
    """Starts the executor beside a running core and ``init()`` group
    (collective: every rank, when the core starts or when ``init()``
    runs beside a running core) and registers the process groups of
    ``new_group`` with the core, in creation order."""
    global _plane
    from horovod_tpu_torch import groups
    from horovod_tpu_torch.common import basics
    core = _core.get_core()
    with _lock:
        world = basics.process_group()
        if _plane is not None and _plane.torch_world is not world:
            _plane.stop()
            _plane = None
        if _plane is None:
            backend = dist.get_backend(world)
            _plane = DevicePlane(core, world, backend, basics.size())
        else:
            _plane.start()
        for pg in groups.created():
            groups.register_with_core(pg)
            _plane.add_group(pg)
    return _plane


def detach():
    """Stops the executor (``shutdown()`` of the process group)."""
    global _plane
    with _lock:
        if _plane is not None:
            _plane.stop()
            _plane = None


def _at_exit():
    # the core first: its shutdown runs what every rank negotiated while
    # the executor is still there to run it
    _core.shutdown()
    detach()


atexit.register(_at_exit)
