"""The asynchronous collectives on host tensors, moved by the port's
negotiation core (ROADMAP A8c1).

Counterpart of ``horovod_tpu/common/ops.py``'s ``allreduce_async``,
``reduce_scatter_async``, ``allgather_async``, ``broadcast_async``,
``poll`` and ``synchronize``, with the same names, arguments, handles and
errors. Each ``*_async`` enqueues one named collective into the core
(``common/core.py``, started at first use) and returns an int handle;
the core's background thread negotiates it with the other ranks (the
coordinator orders what every rank has made ready, so ranks may enqueue
in different orders), fuses small tensors into one buffer up to
``HVD_TPU_FUSION_THRESHOLD``, answers repeated names from its response
cache and runs a cycle every ``HVD_TPU_CYCLE_TIME`` ms, over its TCP data
plane. ``synchronize`` waits and returns the result; a failed collective
(mismatched shapes, dtypes or roots across ranks, a duplicate name)
raises ``HorovodInternalError`` with the core's message.

They take CPU tensors, read and written in place through ``data_ptr()``
(bfloat16 included), or numpy arrays as the reference does; a result has
the input's kind. A tensor on the GPU (or any device but the CPU) raises
:class:`CudaTensorError`: CUDA tensors under the core's negotiation are
ROADMAP A8c2. The synchronous collectives (``common/ops.py``) run on
``torch.distributed``. This module imports torch only to handle a
tensor.
"""

import ctypes
import os
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


class CudaTensorError(NotImplementedError):
    """A tensor that is not on the CPU was given to the asynchronous API:
    the negotiation core moves host tensors in this slice, and CUDA
    tensors under its negotiation are ROADMAP A8c2."""


def _herr():
    from horovod_tpu_torch.common.ops import HorovodInternalError
    return HorovodInternalError


class _Buf:
    """A contiguous host buffer: a CPU tensor (``data_ptr()``) or a numpy
    array. ``obj`` is what the caller gets back."""

    __slots__ = ("obj", "ptr", "shape", "dtype", "hvd_dtype", "nbytes",
                 "torch")

    def __init__(self, value, what):
        if type(value).__module__.split(".")[0] == "torch":
            if value.device.type != "cpu":
                raise CudaTensorError(
                    "%s got a tensor on %s: the negotiation core's "
                    "asynchronous API moves CPU tensors in this slice "
                    "(CUDA tensors under its negotiation are ROADMAP A8c2; "
                    "the synchronous collectives of horovod_tpu_torch take "
                    "them)" % (what, value.device))
            value = value.contiguous()
            dtype = str(value.dtype).replace("torch.", "")
            if dtype not in _TORCH_TO_HVD:
                raise ValueError("Unsupported dtype for the negotiation "
                                 "core: %s" % value.dtype)
            self.torch = True
            self.hvd_dtype = _TORCH_TO_HVD[dtype]
            self.ptr = value.data_ptr()
            self.nbytes = value.numel() * value.element_size()
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
        """A new buffer of this kind and dtype (this shape by default)."""
        shape = self.shape if shape is None else tuple(shape)
        if self.torch:
            import torch
            return _Buf(torch.empty(shape, dtype=self.dtype), "")
        return _Buf(np.empty(shape, dtype=self.dtype), "")

    def shape_array(self):
        # a 0-d tensor travels as (1,), as ascontiguousarray makes it in
        # the reference
        dims = self.shape or (1,)
        return len(dims), (ctypes.c_int64 * len(dims))(*dims)


def _out_buf(out, like, what):
    if out is None:
        return like.empty()
    buf = _Buf(out, what)
    if buf.nbytes != like.nbytes or buf.hvd_dtype != like.hvd_dtype or \
            buf.obj is not out:
        raise ValueError("%s out must be a contiguous %s buffer of %d "
                         "bytes" % (what, like.dtype, like.nbytes))
    return buf


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
                    out=None, compression=None):
    """Starts an allreduce (sum, times ``prescale_factor`` before and
    ``postscale_factor`` after) of a CPU tensor or numpy array; returns a
    handle. ``out`` (may alias the input) takes the result in place.
    ``compression`` ('none', 'bf16', 'int8' or a wire mode; None:
    ``HVD_TPU_COMPRESSION``) encodes each ring hop; every rank passes the
    same."""
    src = _Buf(tensor, "allreduce_async")
    dst = _out_buf(out, src, "allreduce_async")
    lib = _core.init().lib
    ndim, dims = src.shape_array()
    handle = lib.horovod_tpu_enqueue_allreduce(
        name.encode("utf-8"), src.ptr, dst.ptr, ndim, dims, src.hvd_dtype,
        float(prescale_factor), float(postscale_factor), _mode(compression))
    _handle_map[handle] = (src, dst, None)
    return handle


def reduce_scatter_async(tensor, name, prescale_factor=1.0,
                         postscale_factor=1.0, compression=None, out=None):
    """Starts a reduce-scatter (sum) of the FLAT tensor; returns a handle.
    Its elements split into ``size()`` near-equal chunks
    (:func:`shard_partition`), and this rank's result is chunk ``rank()``
    of the cross-rank sum, 1-D. ``out``, when given, holds exactly that
    many elements."""
    src = _Buf(tensor, "reduce_scatter_async")
    core = _core.init()
    counts, _ = shard_partition(int(np.prod(src.shape, dtype=np.int64)),
                                core.size())
    mine = counts[core.rank()]
    if out is None:
        dst = src.empty((mine,))
    else:
        dst = _Buf(out, "reduce_scatter_async")
        if dst.obj is not out or dst.hvd_dtype != src.hvd_dtype or \
                int(np.prod(dst.shape, dtype=np.int64)) != mine:
            # the core copies this rank's chunk to out's first byte: a
            # narrower or strided buffer would be overwritten past its end
            raise ValueError("reduce_scatter out must be a contiguous %s "
                             "buffer of this rank's %d elements (got %s of "
                             "shape %s)" % (src.dtype, mine, dst.dtype,
                                            dst.shape))
    ndim, dims = src.shape_array()
    handle = core.lib.horovod_tpu_enqueue_reduce_scatter(
        name.encode("utf-8"), src.ptr, dst.ptr, ndim, dims, src.hvd_dtype,
        float(prescale_factor), float(postscale_factor), _mode(compression))
    _handle_map[handle] = (src, dst, None)
    return handle


def allgather_async(tensor, name):
    """Starts an allgather along dim 0 (ranks may differ in it); returns
    a handle."""
    src = _Buf(tensor, "allgather_async")
    if not src.shape:
        src = _Buf(src.obj.reshape(1), "allgather_async")
    core = _core.init()
    ndim, dims = src.shape_array()
    handle = core.lib.horovod_tpu_enqueue_allgather(
        name.encode("utf-8"), src.ptr, ndim, dims, src.hvd_dtype)
    _handle_map[handle] = (src, None, core.size())
    return handle


def broadcast_async(tensor, root_rank, name, out=None):
    """Starts a broadcast from ``root_rank``; returns a handle. ``out`` as
    in :func:`allreduce_async`."""
    src = _Buf(tensor, "broadcast_async")
    dst = _out_buf(out, src, "broadcast_async")
    lib = _core.init().lib
    ndim, dims = src.shape_array()
    handle = lib.horovod_tpu_enqueue_broadcast(
        name.encode("utf-8"), src.ptr, dst.ptr, ndim, dims, src.hvd_dtype,
        int(root_rank))
    _handle_map[handle] = (src, dst, None)
    return handle


def poll(handle):
    """True when the collective behind ``handle`` has completed."""
    return bool(_core.get_core().lib.horovod_tpu_poll(handle))


def synchronize(handle):
    """Waits for ``handle``; returns its result (of the input's kind).

    An allgather's result is a view of the core's gather buffer, released
    when the result is garbage-collected; with
    ``HVD_TPU_ALLGATHER_COPY=1`` it is a copy and the buffer is released
    at once."""
    if handle not in _handle_map:
        raise ValueError("unknown handle %d" % handle)
    lib = _core.get_core().lib
    released = False
    try:
        if lib.horovod_tpu_wait(handle) != _STATUS_OK:
            msg = lib.horovod_tpu_error_string(handle)
            raise _herr()(msg.decode("utf-8") if msg
                          else "collective failed")
        src, dst, size = _handle_map[handle]
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
        if not released:
            lib.horovod_tpu_release(handle)
        del _handle_map[handle]


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
