"""The asynchronous collectives, moved by the port's negotiation core
(ROADMAP A8c1 on host tensors, A8c2 on CUDA tensors).

Counterpart of ``horovod_tpu/common/ops.py``'s ``allreduce_async``,
``reduce_scatter_async``, ``allgather_async``, ``broadcast_async``,
``poll`` and ``synchronize``, with the same names, arguments (``group=``
included), handles and errors. Each ``*_async`` enqueues one named
collective into the core (``common/core.py``, started at first use) and
returns an int handle; the core's background thread negotiates it with
the other ranks (the coordinator orders what every rank has made ready,
so ranks may enqueue in different orders), fuses small tensors into one
buffer up to ``HVD_TPU_FUSION_THRESHOLD``, answers repeated names from
its response cache and runs a cycle every ``HVD_TPU_CYCLE_TIME`` ms.
``synchronize`` waits and returns the result; a failed collective
(mismatched shapes, dtypes, roots or devices across ranks, a duplicate
name) raises ``HorovodInternalError`` with the core's message.

They take CPU tensors, read and written in place through ``data_ptr()``
(bfloat16 included), and numpy arrays as the reference does, moved by
the core's TCP data plane; and CUDA tensors on this rank's GPU, which the
core negotiates the same way and its device op hands to the executor of
``common/device_plane.py``: NCCL on the card (gloo beside a CPU group),
no copy through the host. A result has the input's kind and device. A
tensor on any other device raises :class:`DeviceTensorError` before the
core starts. ``group=`` takes a ``ProcessGroup`` of ``new_group`` (a
non-member raises ``ValueError`` before it enqueues), ``WORLD``/None, or
a group id of the core's table. The synchronous collectives
(``common/ops.py``) run on ``torch.distributed``. This module imports
torch only to handle a tensor.
"""

import ctypes
import os
import sys
import weakref

import numpy as np

from horovod_tpu_torch.common import core as _core

# handle -> (input, output or None, participant count): keeps the buffers
# alive while the background thread works on them
_handle_map = {}

# Status codes of native/common.h StatusType
_STATUS_OK = 0

_NUMPY_TO_HVD = {
    np.dtype(np.uint8): _core.HVD_UINT8, np.dtype(np.int8): _core.HVD_INT8,
    np.dtype(np.uint16): _core.HVD_UINT16,
    np.dtype(np.int16): _core.HVD_INT16,
    np.dtype(np.int32): _core.HVD_INT32,
    np.dtype(np.int64): _core.HVD_INT64,
    np.dtype(np.float16): _core.HVD_FLOAT16,
    np.dtype(np.float32): _core.HVD_FLOAT32,
    np.dtype(np.float64): _core.HVD_FLOAT64,
    np.dtype(np.bool_): _core.HVD_BOOL}
_TORCH_TO_HVD = {
    "uint8": _core.HVD_UINT8, "int8": _core.HVD_INT8,
    "uint16": _core.HVD_UINT16, "int16": _core.HVD_INT16,
    "int32": _core.HVD_INT32, "int64": _core.HVD_INT64,
    "float16": _core.HVD_FLOAT16, "float32": _core.HVD_FLOAT32,
    "float64": _core.HVD_FLOAT64, "bool": _core.HVD_BOOL,
    "bfloat16": _core.HVD_BFLOAT16}


class DeviceTensorError(ValueError):
    """A tensor the asynchronous API cannot take: one on a device other
    than the CPU and this rank's GPU (``meta``, another GPU), or an
    ``out=`` on another device than its input. Raised before the core
    starts."""


def _herr():
    from horovod_tpu_torch.common.ops import HorovodInternalError
    return HorovodInternalError


def _is_tensor(value):
    """True for a torch tensor (a subclass too), without importing
    torch."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(value, torch.Tensor)


def _rank_gpu():
    """This rank's CUDA ordinal: ``init()``'s device (None where ``init()``
    runs on the CPU), else the current one."""
    import torch
    from horovod_tpu_torch.common import basics
    if basics.is_initialized():
        dev = basics.device()
        return dev.index if dev.type == "cuda" else None
    return torch.cuda.current_device()


def device_id(value, what):
    """The device id of ``value``'s request: ``HOST_DEVICE_ID`` (-1) for
    host memory (a CPU tensor, a numpy array), its CUDA ordinal for a
    tensor on this rank's GPU. Any other device raises
    :class:`DeviceTensorError`. The one place that maps a tensor to the
    core's device: a response whose entries are on a device takes the
    core's device op and the executor of ``common/device_plane.py``."""
    if not _is_tensor(value):
        return _core.HOST_DEVICE_ID
    kind = value.device.type
    if kind == "cpu":
        return _core.HOST_DEVICE_ID
    if kind == "cuda":
        gpu = _rank_gpu()
        if gpu is None:
            raise DeviceTensorError(
                "%s got a tensor on %s, but init() runs on the CPU: its "
                "collectives go over gloo through host memory, which a "
                "CUDA tensor never takes; call init() on the GPU"
                % (what, value.device))
        if value.device.index == gpu:
            return gpu
    raise DeviceTensorError(
        "%s got a tensor on %s: the asynchronous API takes CPU tensors, "
        "numpy arrays and CUDA tensors on this rank's GPU"
        % (what, value.device))


class _Buf:
    """A contiguous buffer: a CPU tensor or numpy array in host memory
    (``device`` -1), or a tensor on this rank's GPU (``device`` its
    ordinal, ``ready`` an event recorded on the caller's current stream).
    ``obj`` is what the caller gets back."""

    __slots__ = ("obj", "ptr", "shape", "dtype", "hvd_dtype", "nbytes",
                 "torch", "device", "ready")

    def __init__(self, value, what):
        self.device = device_id(value, what)
        self.ready = None
        if _is_tensor(value):
            value = value.contiguous()
            dtype = str(value.dtype).replace("torch.", "")
            if dtype not in _TORCH_TO_HVD:
                raise ValueError("Unsupported dtype for the negotiation "
                                 "core: %s" % value.dtype)
            self.torch = True
            self.hvd_dtype = _TORCH_TO_HVD[dtype]
            self.ptr = value.data_ptr()
            self.nbytes = value.numel() * value.element_size()
            if value.is_cuda:
                import torch
                self.ready = torch.cuda.Event()
                self.ready.record(torch.cuda.current_stream(value.device))
        else:
            value = np.ascontiguousarray(value)
            if value.dtype not in _NUMPY_TO_HVD:
                raise ValueError("Unsupported dtype for the negotiation "
                                 "core: %s" % value.dtype)
            self.torch = False
            self.hvd_dtype = _NUMPY_TO_HVD[value.dtype]
            self.ptr = value.ctypes.data
            self.nbytes = value.nbytes
        self.obj = value
        self.shape = tuple(value.shape)
        self.dtype = value.dtype

    def empty(self, shape=None):
        """A new buffer of this kind, dtype and device (this shape by
        default)."""
        shape = self.shape if shape is None else tuple(shape)
        if self.torch:
            import torch
            return _Buf(torch.empty(shape, dtype=self.dtype,
                                    device=self.obj.device), "")
        return _Buf(np.empty(shape, dtype=self.dtype), "")

    def shape_array(self):
        # a 0-d tensor travels as (1,), as ascontiguousarray makes it in
        # the reference
        dims = self.shape or (1,)
        return len(dims), (ctypes.c_int64 * len(dims))(*dims)


def _same_device(dst, src, what):
    if dst.device != src.device:
        raise DeviceTensorError(
            "%s out= is on %s but its input on %s: both must be on the "
            "same device" % (what, _where(dst), _where(src)))


def _where(buf):
    return "the host" if buf.device == _core.HOST_DEVICE_ID else \
        "cuda:%d" % buf.device


def _out_buf(out, like, what):
    if out is None:
        return like.empty()
    buf = _Buf(out, what)
    _same_device(buf, like, what)
    if buf.nbytes != like.nbytes or buf.hvd_dtype != like.hvd_dtype or \
            buf.obj is not out:
        raise ValueError("%s out must be a contiguous %s buffer of %d "
                         "bytes" % (what, like.dtype, like.nbytes))
    return buf


def _start(src, group):
    """The started core, and the group's id in it; a CUDA tensor also
    needs the device plane's executor, on NCCL."""
    core = _core.init()
    gid = 0
    if group is not None:  # groups.py imports torch
        from horovod_tpu_torch.groups import core_group_id
        gid = core_group_id(group)
    if src.device != _core.HOST_DEVICE_ID:
        from horovod_tpu_torch.common import device_plane
        device_plane.require(src.obj)
    return core, gid


def _enqueued(handle, src, dst, size):
    """Keeps the buffers of ``handle`` alive (and, on a device, hands
    them to the executor)."""
    _handle_map[handle] = (src, dst, size)
    if src.device != _core.HOST_DEVICE_ID:
        from horovod_tpu_torch.common import device_plane
        device_plane.track(handle, src.obj, None if dst is None else dst.obj,
                           src.ready)
    return handle


def _mode(compression):
    """The wire mode's id of ``compression=`` (the port's
    ``compression.resolve``; None defers to ``HVD_TPU_COMPRESSION``)."""
    if compression is None and not os.environ.get("HVD_TPU_COMPRESSION"):
        return 0
    from horovod_tpu_torch import compression as wire
    return int(wire.resolve(compression).mode)


def shard_partition(count, n):
    """(counts, offsets) of the reduce-scatter partition: ``count``
    elements in ``n`` near-equal chunks, chunk i rank i's (the core's
    ``PartitionChunks``)."""
    base, rem = divmod(int(count), int(n))
    counts = [base + (1 if i < rem else 0) for i in range(n)]
    offsets = [0] * n
    for i in range(1, n):
        offsets[i] = offsets[i - 1] + counts[i - 1]
    return counts, offsets


def allreduce_async(tensor, name, prescale_factor=1.0, postscale_factor=1.0,
                    out=None, compression=None, group=None):
    """Starts an allreduce (sum, times ``prescale_factor`` before and
    ``postscale_factor`` after) of a CPU tensor, a numpy array or a CUDA
    tensor on this rank's GPU over ``group`` (None: the world); returns a
    handle. ``out`` (may alias the input; on the input's device) takes
    the result in place. ``compression`` ('none', 'bf16', 'int8' or a
    wire mode; None: ``HVD_TPU_COMPRESSION``) encodes each ring hop;
    every rank passes the same."""
    src = _Buf(tensor, "allreduce_async")
    dst = _out_buf(out, src, "allreduce_async")
    core, gid = _start(src, group)
    ndim, dims = src.shape_array()
    handle = core.lib.horovod_tpu_enqueue_allreduce_grp(
        name.encode("utf-8"), src.ptr, dst.ptr, ndim, dims, src.hvd_dtype,
        float(prescale_factor), float(postscale_factor), _mode(compression),
        gid, src.device)
    return _enqueued(handle, src, dst, None)


def reduce_scatter_async(tensor, name, prescale_factor=1.0,
                         postscale_factor=1.0, compression=None, out=None,
                         group=None):
    """Starts a reduce-scatter (sum) of the FLAT tensor over ``group``;
    returns a handle. Its elements split into the group's size near-equal
    chunks (:func:`shard_partition`), and this rank's result is its
    group rank's chunk of the cross-rank sum, 1-D. ``out``, when given,
    holds exactly that many elements on the input's device."""
    src = _Buf(tensor, "reduce_scatter_async")
    if out is not None:
        dst = _Buf(out, "reduce_scatter_async")
        _same_device(dst, src, "reduce_scatter_async")
    core, gid = _start(src, group)
    # an unknown group id is the enqueue's error, raised at synchronize
    counts, _ = shard_partition(int(np.prod(src.shape, dtype=np.int64)),
                                max(core.lib.horovod_tpu_group_size(gid), 1))
    mine = counts[max(core.lib.horovod_tpu_group_rank(gid), 0)]
    if out is None:
        dst = src.empty((mine,))
    elif dst.obj is not out or dst.hvd_dtype != src.hvd_dtype or \
            int(np.prod(dst.shape, dtype=np.int64)) != mine:
        # the core copies this rank's chunk to out's first byte: a
        # narrower or strided buffer would be overwritten past its end
        raise ValueError("reduce_scatter out must be a contiguous %s "
                         "buffer of this rank's %d elements (got %s of "
                         "shape %s)" % (src.dtype, mine, dst.dtype,
                                        dst.shape))
    ndim, dims = src.shape_array()
    handle = core.lib.horovod_tpu_enqueue_reduce_scatter_grp(
        name.encode("utf-8"), src.ptr, dst.ptr, ndim, dims, src.hvd_dtype,
        float(prescale_factor), float(postscale_factor), _mode(compression),
        gid, src.device)
    return _enqueued(handle, src, dst, None)


def allgather_async(tensor, name, group=None):
    """Starts an allgather along dim 0 over ``group`` (ranks may differ in
    it); returns a handle."""
    src = _Buf(tensor, "allgather_async")
    if not src.shape:
        src = _Buf(src.obj.reshape(1), "allgather_async")
    core, gid = _start(src, group)
    ndim, dims = src.shape_array()
    handle = core.lib.horovod_tpu_enqueue_allgather_grp(
        name.encode("utf-8"), src.ptr, ndim, dims, src.hvd_dtype, gid,
        src.device)
    return _enqueued(handle, src, None, core.lib.horovod_tpu_group_size(gid))


def broadcast_async(tensor, root_rank, name, out=None, group=None):
    """Starts a broadcast from world rank ``root_rank`` over ``group``;
    returns a handle. ``out`` as in :func:`allreduce_async`."""
    src = _Buf(tensor, "broadcast_async")
    dst = _out_buf(out, src, "broadcast_async")
    core, gid = _start(src, group)
    ndim, dims = src.shape_array()
    handle = core.lib.horovod_tpu_enqueue_broadcast_grp(
        name.encode("utf-8"), src.ptr, dst.ptr, ndim, dims, src.hvd_dtype,
        int(root_rank), gid, src.device)
    return _enqueued(handle, src, dst, None)


def poll(handle):
    """True when the collective behind ``handle`` has completed."""
    return bool(_core.get_core().lib.horovod_tpu_poll(handle))


def synchronize(handle):
    """Waits for ``handle``; returns its result (of the input's kind, on
    its device).

    A CUDA result is complete on the device when this returns, and the
    caller's current stream waits on the executor's done event besides;
    an allgather's is a new CUDA tensor. A host allgather's result is a
    view of the core's gather buffer, released when the result is
    garbage-collected; with ``HVD_TPU_ALLGATHER_COPY=1`` it is a copy and
    the buffer is released at once."""
    if handle not in _handle_map:
        raise ValueError("unknown handle %d" % handle)
    lib = _core.get_core().lib
    released = False
    src = _handle_map[handle][0]
    try:
        if lib.horovod_tpu_wait(handle) != _STATUS_OK:
            msg = lib.horovod_tpu_error_string(handle)
            raise _herr()(msg.decode("utf-8") if msg
                          else "collective failed")
        src, dst, size = _handle_map[handle]
        if src.device != _core.HOST_DEVICE_ID:
            return _device_result(handle, src, dst)
        if dst is not None:
            return dst.obj
        nbytes = lib.horovod_tpu_allgather_bytes(handle)
        if nbytes < 0:
            raise _herr()("allgather produced no result")
        first = 0
        for r in range(size):
            d = lib.horovod_tpu_allgather_rank_dim(handle, r)
            if d < 0:
                raise _herr()("allgather sizes missing")
            first += d
        shape = (first,) + src.shape[1:]
        if nbytes != int(np.prod(shape, dtype=np.int64)) * _itemsize(src):
            raise _herr()("allgather size mismatch: %d bytes for %s"
                          % (nbytes, shape))
        if nbytes == 0:
            return src.empty(shape).obj
        ptr = lib.horovod_tpu_allgather_data(handle)
        if not ptr:
            raise _herr()("allgather buffer missing")
        raw = (ctypes.c_char * nbytes).from_address(ptr)
        if os.environ.get("HVD_TPU_ALLGATHER_COPY", "0") == "1":
            return _view(raw, src, shape, copy=True)
        result = _view(raw, src, shape)
        weakref.finalize(raw, lib.horovod_tpu_release, handle)
        released = True  # the view's finalizer releases the buffer
        return result
    finally:
        if src.device != _core.HOST_DEVICE_ID:
            from horovod_tpu_torch.common import device_plane
            device_plane.take_result(handle)
        if not released:
            lib.horovod_tpu_release(handle)
        del _handle_map[handle]


def _device_result(handle, src, dst):
    """The result of a completed device handle: the caller's current
    stream waits on the executor's done event."""
    from horovod_tpu_torch.common import device_plane
    done, gathered = device_plane.take_result(handle)
    result = dst.obj if dst is not None else gathered
    if result is None:
        raise _herr()("allgather produced no result")
    if done is not None:
        import torch
        stream = torch.cuda.current_stream(result.device)
        stream.wait_event(done)
        if dst is None:
            result.record_stream(stream)
    return result


def _itemsize(buf):
    if buf.torch:
        import torch
        return torch.empty((), dtype=buf.dtype).element_size()
    return buf.dtype.itemsize


def _view(raw, src, shape, copy=False):
    """The core's gather buffer as the input's kind, without a copy (or
    with one)."""
    if src.torch:
        import torch
        t = torch.frombuffer(raw, dtype=src.dtype).reshape(shape)
        return t.clone() if copy else t
    a = np.frombuffer(raw, dtype=src.dtype).reshape(shape)
    return a.copy() if copy else a
