"""The port's negotiation core: its own build of the native runtime, bound
with ctypes (ROADMAP A8c1).

``horovod_tpu_torch/native/`` holds copies of the C++ sources of the
reference's core (``horovod_tpu/native/``, the Makefile's ``SRCS``: the
coordinator, tensor fusion, the response cache, the cycle, the TCP data
plane and the rest) and one source of the port's own, ``port_build.cc``.
The copies are the port's own to extend: the enqueue takes the tensor's
device, the coordinator rejects a name enqueued on the host by one rank
and on a GPU by another, the response cache keys on the device, and a
device op ahead of the CPU ops hands a response on GPU tensors to the
executor of ``common/device_plane.py`` (ROADMAP A8c2).
:func:`build` compiles them with g++ at first use, one g++ a source, all
at once (``common/cxx.py``), and links
``native/_build/libhvd_torch_core.<hash>.so`` (git-ignored); the hash
covers the sources and the flags, so an edited source is rebuilt. A file
lock serialises the build across processes (xdist workers, the ranks of
a job) and the library appears by an atomic rename. A failed build
raises ``cxx.CxxBuildError``; there is no fall-back.

The library exports only its C API (the ``horovod_tpu_*`` symbols, a
version script) and binds its own calls to itself (``-Bsymbolic``). A
process that also loads the reference's library, which the reference
loads with ``RTLD_GLOBAL``, would otherwise have the copy's internal C++
calls resolved to the reference's same-named symbols.

:class:`Core` is the port's copy of the reference's binding,
``horovod_tpu/common/basics.py``'s ``HorovodBasics``. :func:`init` starts
the core: on the launcher's table (``HVD_TPU_ADDRS``, after the dynamic
rendezvous where the launcher asked for one), or, in a process whose
``torch.distributed`` group is up, on ports that the ranks exchange
through that group's store (the group's store holds rank 0's port of the
table). Beside a running group the core's start also starts the device
plane's executor. Importing this module imports no torch.
"""

import atexit
import ctypes
import os
import sys
import threading
from pathlib import Path

from horovod_tpu_torch.common import cxx

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = NATIVE_DIR / "_build"
# horovod_tpu/native/Makefile's SRCS, and the port's build identity
SOURCES = (
    "logging.cc", "common.cc", "message.cc", "checksum.cc", "fault.cc",
    "net.cc", "shm_context.cc", "net_selftest.cc", "tcp_context.cc",
    "tensor_queue.cc", "response_cache.cc", "stall_inspector.cc",
    "divergence.cc", "metrics.cc", "trace.cc", "timeline.cc",
    "controller.cc", "tcp_controller.cc", "fusion_buffer_manager.cc",
    "collective_operations.cc", "cpu_operations.cc", "compression.cc",
    "bayesian_optimization.cc", "parameter_manager.cc", "operations.cc",
    "port_build.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-Wno-unused-parameter", "-pthread")
LD_FLAGS = ("-shared", "-pthread", "-Wl,-Bsymbolic")
LD_LIBS = ("-lrt",)
# only the C API leaves the library
VERSION_SCRIPT = "{\n  global: horovod_tpu_*;\n  local: *;\n};\n"
BUILD_SYMBOL = "horovod_tpu_torch_core_build"

# DataType values of native/message.h
HVD_UINT8, HVD_INT8, HVD_UINT16, HVD_INT16, HVD_INT32, HVD_INT64 = range(6)
HVD_FLOAT16, HVD_FLOAT32, HVD_FLOAT64, HVD_BOOL, HVD_BFLOAT16 = range(6, 11)
# native/common.h: the device id of host memory (any other is a CUDA
# ordinal)
HOST_DEVICE_ID = -1


def digest():
    """Hash of the sources, the headers, the flags and the version
    script: the build's identity and its library's name."""
    return cxx.digest(sorted(NATIVE_DIR.glob("*.h")) +
                      sorted(NATIVE_DIR.glob("*.cc")),
                      *CXX_FLAGS, *LD_FLAGS, *LD_LIBS, VERSION_SCRIPT)


def library_path():
    return BUILD_DIR / ("libhvd_torch_core.%s.so" % digest())


def build():
    """Builds the core's library if it is missing (``cxx.build``); returns
    the seconds spent (0 when it was there)."""
    return cxx.build(
        library_path(), [NATIVE_DIR / src for src in SOURCES], CXX_FLAGS,
        LD_FLAGS, LD_LIBS,
        defines={"port_build.cc": ['-DHVD_TORCH_CORE_BUILD="%s"'
                                   % digest()]},
        version_script=VERSION_SCRIPT,
        what="the negotiation core (horovod_tpu_torch/native)")


def _i64p():
    return ctypes.POINTER(ctypes.c_int64)


class Core:
    """The port's copy of the reference's binding (``HorovodBasics``,
    ``horovod_tpu/common/basics.py:88-206``) over the port's own build.
    """

    def __init__(self):
        build()
        self.path = library_path()
        # RTLD_LOCAL (ctypes' default): the copy's symbols are found
        # through this handle only, and interpose on nothing
        self.lib = lib = ctypes.CDLL(str(self.path))
        getattr(lib, BUILD_SYMBOL).restype = ctypes.c_char_p
        self.build_id = getattr(lib, BUILD_SYMBOL)().decode()
        if self.build_id != digest():
            raise cxx.CxxBuildError(
                "%s answers as build %s, not %s" % (self.path,
                                                    self.build_id, digest()))
        lib.horovod_tpu_init.restype = ctypes.c_int
        for fn in ("horovod_tpu_rank", "horovod_tpu_local_rank",
                   "horovod_tpu_cross_rank", "horovod_tpu_size",
                   "horovod_tpu_local_size", "horovod_tpu_cross_size",
                   "horovod_tpu_initialized", "horovod_tpu_is_homogeneous",
                   "horovod_tpu_connection_lost",
                   "horovod_tpu_tcp_built", "horovod_tpu_cpu_ops_built",
                   "horovod_tpu_device_op_built"):
            getattr(lib, fn).restype = ctypes.c_int
        # the enqueues of the asynchronous API: a process group (0: the
        # world) and the tensor's device id (-1 for host memory, else its
        # CUDA ordinal) last
        for fn in ("horovod_tpu_enqueue_allreduce_grp",
                   "horovod_tpu_enqueue_reduce_scatter_grp"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, _i64p(), ctypes.c_int, ctypes.c_double,
                ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.horovod_tpu_enqueue_allgather_grp.restype = ctypes.c_int
        lib.horovod_tpu_enqueue_allgather_grp.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, _i64p(),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.horovod_tpu_enqueue_broadcast_grp.restype = ctypes.c_int
        lib.horovod_tpu_enqueue_broadcast_grp.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            _i64p(), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        # the executor's side of the device op (common/device_plane.py)
        lib.horovod_tpu_device_next.restype = ctypes.c_int64
        lib.horovod_tpu_device_next.argtypes = [ctypes.c_int]
        lib.horovod_tpu_device_work_info.restype = ctypes.c_int
        lib.horovod_tpu_device_work_info.argtypes = [ctypes.c_int64, _i64p()]
        lib.horovod_tpu_device_work_entry.restype = ctypes.c_int
        lib.horovod_tpu_device_work_entry.argtypes = [
            ctypes.c_int64, ctypes.c_int, _i64p(),
            ctypes.POINTER(ctypes.c_double)]
        lib.horovod_tpu_device_work_sizes.restype = ctypes.c_int
        lib.horovod_tpu_device_work_sizes.argtypes = [ctypes.c_int64,
                                                      _i64p()]
        lib.horovod_tpu_device_done.restype = ctypes.c_int
        lib.horovod_tpu_device_done.argtypes = [ctypes.c_int64, ctypes.c_int,
                                                ctypes.c_char_p]
        lib.horovod_tpu_new_group.restype = ctypes.c_int
        lib.horovod_tpu_new_group.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.horovod_tpu_group_size.restype = ctypes.c_int
        lib.horovod_tpu_group_size.argtypes = [ctypes.c_int]
        lib.horovod_tpu_group_rank.restype = ctypes.c_int
        lib.horovod_tpu_group_rank.argtypes = [ctypes.c_int]
        lib.horovod_tpu_group_count.restype = ctypes.c_int
        lib.horovod_tpu_group_count.argtypes = []
        lib.horovod_tpu_sharded_update_default.restype = ctypes.c_int
        lib.horovod_tpu_sharded_update_default.argtypes = []
        lib.horovod_tpu_opt_state_metrics.restype = None
        lib.horovod_tpu_opt_state_metrics.argtypes = [ctypes.c_int64]
        lib.horovod_tpu_parse_compression.restype = ctypes.c_int
        lib.horovod_tpu_parse_compression.argtypes = [ctypes.c_char_p]
        lib.horovod_tpu_effective_compression.restype = ctypes.c_int
        lib.horovod_tpu_effective_compression.argtypes = [ctypes.c_int,
                                                          ctypes.c_int]
        lib.horovod_tpu_compressed_size.restype = ctypes.c_int64
        lib.horovod_tpu_compressed_size.argtypes = [ctypes.c_int64,
                                                    ctypes.c_int]
        lib.horovod_tpu_poll.restype = ctypes.c_int
        lib.horovod_tpu_poll.argtypes = [ctypes.c_int]
        lib.horovod_tpu_wait.restype = ctypes.c_int
        lib.horovod_tpu_wait.argtypes = [ctypes.c_int]
        lib.horovod_tpu_error_string.restype = ctypes.c_char_p
        lib.horovod_tpu_error_string.argtypes = [ctypes.c_int]
        lib.horovod_tpu_allgather_bytes.restype = ctypes.c_int64
        lib.horovod_tpu_allgather_bytes.argtypes = [ctypes.c_int]
        lib.horovod_tpu_allgather_rank_dim.restype = ctypes.c_int64
        lib.horovod_tpu_allgather_rank_dim.argtypes = [ctypes.c_int,
                                                       ctypes.c_int]
        lib.horovod_tpu_allgather_copy.restype = ctypes.c_int
        lib.horovod_tpu_allgather_copy.argtypes = [ctypes.c_int,
                                                   ctypes.c_void_p]
        lib.horovod_tpu_allgather_data.restype = ctypes.c_void_p
        lib.horovod_tpu_allgather_data.argtypes = [ctypes.c_int]
        lib.horovod_tpu_release.argtypes = [ctypes.c_int]
        lib.horovod_tpu_perf_counters.restype = None
        lib.horovod_tpu_perf_counters.argtypes = [_i64p(), _i64p()]
        lib.horovod_tpu_effective_fusion_threshold.restype = ctypes.c_int64
        lib.horovod_tpu_protocol_counters.restype = None
        lib.horovod_tpu_protocol_counters.argtypes = [
            ctypes.POINTER(ctypes.c_uint64)]
        lib.horovod_tpu_protocol_counters_reset.restype = None
        lib.horovod_tpu_protocol_counters_reset.argtypes = []
        lib.horovod_tpu_call_digest.restype = None
        lib.horovod_tpu_call_digest.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
        lib.horovod_tpu_metrics_json.restype = ctypes.c_char_p
        lib.horovod_tpu_metrics_json.argtypes = []
        lib.horovod_tpu_crc32c.restype = ctypes.c_uint32
        lib.horovod_tpu_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.horovod_tpu_crc32c_extend.restype = ctypes.c_uint32
        lib.horovod_tpu_crc32c_extend.argtypes = [
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint64]
        lib.horovod_tpu_net_selftest.restype = ctypes.c_int
        lib.horovod_tpu_net_selftest.argtypes = [ctypes.c_char_p]
        lib.horovod_tpu_job_metrics_json.restype = ctypes.c_char_p
        lib.horovod_tpu_job_metrics_json.argtypes = []

    # -- lifecycle --------------------------------------------------------
    def init(self):
        if not self.lib.horovod_tpu_init():
            raise RuntimeError(
                "the negotiation core did not start (rendezvous error?): "
                "check HVD_TPU_ADDRS / HVD_TPU_RANK / HVD_TPU_SIZE")

    def shutdown(self):
        self.lib.horovod_tpu_shutdown()

    def initialized(self):
        return bool(self.lib.horovod_tpu_initialized())

    # -- queries ----------------------------------------------------------
    def _query(self, fn):
        value = getattr(self.lib, fn)()
        if value == -1:
            raise ValueError("the negotiation core has not been started "
                             "(horovod_tpu_torch.common.core.init())")
        return value

    def rank(self):
        return self._query("horovod_tpu_rank")

    def size(self):
        return self._query("horovod_tpu_size")

    def local_rank(self):
        return self._query("horovod_tpu_local_rank")

    def cross_rank(self):
        return self._query("horovod_tpu_cross_rank")

    def perf_counters(self):
        """(responses_performed, tensors_performed): fewer responses than
        tensors means fusion grouped tensors into shared responses."""
        responses, tensors = ctypes.c_int64(), ctypes.c_int64()
        self.lib.horovod_tpu_perf_counters(ctypes.byref(responses),
                                           ctypes.byref(tensors))
        return responses.value, tensors.value

    def effective_fusion_threshold(self):
        """The controller's working fusion threshold in bytes; -1 before
        init."""
        return self.lib.horovod_tpu_effective_fusion_threshold()

    def protocol_counters(self):
        """This rank's control-plane counters (the reference's keys)."""
        out = (ctypes.c_uint64 * 5)()
        self.lib.horovod_tpu_protocol_counters(out)
        return dict(zip(("ctrl_bytes_sent", "ctrl_bytes_recv", "ctrl_msgs",
                         "cycles_fast", "cycles_full"), out))

    def protocol_counters_reset(self):
        self.lib.horovod_tpu_protocol_counters_reset()

    def metrics_json(self):
        """The core's metrics registry as a JSON string."""
        return self.lib.horovod_tpu_metrics_json().decode("utf-8")

    def crc32c(self, data, crc=0):
        """CRC32C over ``data`` (bytes), chained from ``crc``."""
        buf = bytes(data)
        if crc:
            return int(self.lib.horovod_tpu_crc32c_extend(
                ctypes.c_uint32(crc), buf, len(buf)))
        return int(self.lib.horovod_tpu_crc32c(buf, len(buf)))

    def net_selftest(self, scenario):
        """1 when the transport's named in-process selftest passes, 0 when
        it fails, -1 for an unknown name."""
        return self.lib.horovod_tpu_net_selftest(scenario.encode())


_core = None
_core_lock = threading.Lock()
# successful starts of the core in this process: a group registered at an
# earlier start is registered again (the core clears its table at start)
_starts = [0]


def starts():
    """How many times the core has started in this process."""
    return _starts[0]


def get_core():
    """The process's :class:`Core`, built and loaded at first use."""
    global _core
    with _core_lock:
        if _core is None:
            _core = Core()
    return _core


def is_initialized():
    return _core is not None and _core.initialized()


def _torch_group_up():
    basics = sys.modules.get("horovod_tpu_torch.common.basics")
    return basics is not None and basics.is_initialized()


def _reserve_port():
    """A port bound (not listening) with SO_REUSEPORT and held until the
    core listens beside it (``HVD_TPU_LISTEN_REUSEPORT``)."""
    from horovod_tpu_torch.run import rendezvous
    return rendezvous.reserve_port(hold=True)


def _table_through_store():
    """{HVD_TPU_ADDRS: ...} on fresh ports, exchanged through the running
    ``torch.distributed`` group's store; the topology stays the
    group's."""
    from horovod_tpu_torch.common import basics
    store = basics.process_group_store()
    rank, size = basics.rank(), basics.size()
    table = (os.environ.get("HVD_TPU_ADDRS") or "").split(",")
    host = table[rank].rsplit(":", 1)[0] if len(table) == size else \
        "127.0.0.1"
    gen = os.environ.get("HVD_TPU_GENERATION", "0")
    # a key a start of the core: every rank restarts it as often
    key = "hvd_torch/core/g%s/s%d/%%d" % (gen, _starts[0])
    store.set(key % rank, "%s:%d" % (host, _reserve_port()))
    import datetime
    keys = [key % r for r in range(size)]
    store.wait(keys, datetime.timedelta(seconds=float(
        os.environ.get("HVD_TPU_START_TIMEOUT", "60") or 60)))
    return {
        "HVD_TPU_RANK": str(rank), "HVD_TPU_SIZE": str(size),
        "HVD_TPU_LOCAL_RANK": str(basics.local_rank()),
        "HVD_TPU_LOCAL_SIZE": str(basics.local_size()),
        "HVD_TPU_CROSS_RANK": str(basics.cross_rank()),
        "HVD_TPU_CROSS_SIZE": str(basics.cross_size()),
        "HVD_TPU_ADDRS": ",".join(store.get(k).decode() for k in keys),
        "HVD_TPU_LISTEN_REUSEPORT": "1"}


def _launcher_table():
    """The env the core starts from when no ``torch.distributed`` group
    is up: the launcher's table, after the dynamic rendezvous (reserved
    ports, held until the core listens beside them) where the launcher
    gave only ``HVD_TPU_RENDEZVOUS_ADDR``."""
    size = int(os.environ.get("HVD_TPU_SIZE", "1") or 1)
    addr = os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    if os.environ.get("HVD_TPU_ADDRS") or size <= 1 or not addr:
        return {}
    from horovod_tpu_torch.run import rendezvous
    from horovod_tpu_torch.run.util import slots_from_env
    env = rendezvous.resolve_topology(
        int(os.environ.get("HVD_TPU_RANK", "0")), size, addr,
        float(os.environ.get("HVD_TPU_START_TIMEOUT", "60") or 60),
        generation=int(os.environ.get("HVD_TPU_GENERATION", "0") or 0),
        slots=slots_from_env(size))
    env["HVD_TPU_LISTEN_REUSEPORT"] = "1"
    return env


def init():
    """Starts the negotiation core (a no-op when it runs): its ranks are
    the launcher's (or the running ``torch.distributed`` group's), its
    TCP data plane on the launcher's table or on ports exchanged through
    the group's store. The core stops at :func:`shutdown` and at exit."""
    core = get_core()
    if core.initialized():
        return core
    from horovod_tpu_torch.run import rendezvous
    env = _table_through_store() if _torch_group_up() else _launcher_table()
    # the group's table goes to the core alone: the process keeps the
    # launcher's
    saved = {k: os.environ.get(k) for k in env} if _torch_group_up() \
        else {}
    os.environ.update(env)
    try:
        core.init()
    finally:
        rendezvous.release_held_ports()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _starts[0] += 1
    if _torch_group_up():
        # the executor of CUDA tensors, beside init()'s group
        from horovod_tpu_torch.common import device_plane
        device_plane.attach()
    return core


def shutdown():
    """Stops the core's background thread (a no-op when it is not
    running)."""
    if _core is not None and _core.initialized():
        _core.shutdown()


atexit.register(shutdown)


def process_group_store(table, rank, size, timeout):
    """The ``torch.distributed`` store of a group formed while the core
    runs: the core listens on the table's ports, rank 0's among them, so
    rank 0 binds its ``TCPStore`` on a free port and the core broadcasts
    it to the others."""
    import datetime

    import numpy as np
    import torch.distributed as dist

    from horovod_tpu_torch.common import async_ops
    host = table[0].rsplit(":", 1)[0]
    td = datetime.timedelta(seconds=timeout)
    store = None
    port = np.zeros(1, np.int64)
    if rank == 0:
        store = dist.TCPStore(host, 0, size, True, timeout=td,
                              wait_for_workers=False)
        port[0] = store.port
    port = async_ops.synchronize(async_ops.broadcast_async(
        port, 0, "hvd_torch.process_group_store"))
    if store is None:
        store = dist.TCPStore(host, int(port[0]), size, False, timeout=td)
    return store

