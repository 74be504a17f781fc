"""The port's build of the negotiation core (ROADMAP A8c1, A8c2), in
process: its build and what it exports (the device op's C API among it),
the mirrors of the reference's ``tests/test_transport.py`` (CRC32C known
answers and the transport's in-process selftests) on it, the reference's
core and the port's loaded in one process, the named error of a tensor
the asynchronous API cannot take, the build queries, and the one-process
short circuit of ``tests/test_distributed.py``."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from horovod_tpu_torch.common import async_ops, core
from horovod_tpu_torch.run import util

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lib():
    return core.get_core()


def test_library_is_built_into_the_ignored_directory_by_its_hash(lib):
    path = core.library_path()
    assert lib.path == path and path.exists()
    assert path.parent == core.BUILD_DIR == ROOT / "horovod_tpu_torch" / \
        "native" / "_build"
    assert path.name == "libhvd_torch_core.%s.so" % core.digest()
    assert lib.build_id == core.digest()
    assert core.build() == 0.0  # there: nothing to do
    # every source of the reference's Makefile is copied and compiled
    makefile = (ROOT / "horovod_tpu" / "native" / "Makefile").read_text()
    srcs = makefile.split("SRCS :=")[1].split("OBJS")[0]
    names = [w for w in srcs.replace("\\", " ").split() if w.endswith(".cc")]
    assert len(names) == 25 and set(core.SOURCES) == set(names) | {
        "port_build.cc"}
    for name in names:
        assert (core.NATIVE_DIR / name).exists(), name
    ignored = subprocess.run(["git", "check-ignore", "-q", str(path)],
                             cwd=ROOT)
    assert ignored.returncode == 0, "the core's build is not git-ignored"


def test_a_build_failure_raises_the_named_error(tmp_path):
    """A source g++ refuses raises ``CxxBuildError`` naming the source and
    what was being built; no library appears and nothing falls back."""
    from horovod_tpu_torch.common import cxx
    bad = tmp_path / "bad.cc"
    bad.write_text("int f( {\n")
    out = tmp_path / "_build" / "libbad.so"
    with pytest.raises(cxx.CxxBuildError, match="bad.cc") as err:
        cxx.build(out, [bad], core.CXX_FLAGS, core.LD_FLAGS,
                  what="the test's library")
    assert "the test's library" in str(err.value)
    assert not out.exists() and out.with_suffix(".log").exists()


def test_only_the_c_api_is_exported(lib):
    nm = shutil.which("nm")
    if nm is None:
        pytest.skip("no nm on this machine")
    out = subprocess.run([nm, "-D", "--defined-only", str(lib.path)],
                         capture_output=True, text=True, check=True).stdout
    names = [line.split()[-1] for line in out.splitlines()
             if line.split()[1] in "TtDdBbRrVvWw"]
    assert names and all(n.startswith("horovod_tpu_") for n in names), \
        [n for n in names if not n.startswith("horovod_tpu_")][:10]
    assert "horovod_tpu_enqueue_allreduce" in names
    assert core.BUILD_SYMBOL in names
    assert set(DEVICE_API) <= set(names)


# the device op's C API (ROADMAP A8c2): the enqueue in a group with a
# device, and the executor's side
DEVICE_API = (
    "horovod_tpu_enqueue_allreduce_grp", "horovod_tpu_enqueue_allgather_grp",
    "horovod_tpu_enqueue_broadcast_grp",
    "horovod_tpu_enqueue_reduce_scatter_grp", "horovod_tpu_device_next",
    "horovod_tpu_device_work_info", "horovod_tpu_device_work_entry",
    "horovod_tpu_device_work_sizes", "horovod_tpu_device_done",
    "horovod_tpu_device_op_built")


def test_the_device_op_is_built_and_present(lib):
    """The core's device op answers as built, its C API is there, and
    with no core running the executor's call reports the core stopped."""
    for name in DEVICE_API:
        assert hasattr(lib.lib, name), name
    assert lib.lib.horovod_tpu_device_op_built() == 1
    if not core.is_initialized():
        assert lib.lib.horovod_tpu_device_next(0) == -1


def test_build_queries_as_the_port_answers_them():
    """``tests/test_launcher.py::test_reference_capability_probes`` as the
    port answers: the gloo role and the TCP and CPU ops come from the
    core, NCCL is the device op with torch.distributed's NCCL, and MPI,
    DDL and MLSL are not built."""
    import horovod_tpu_torch as hvd
    assert hvd.gloo_built() and hvd.gloo_enabled()
    assert hvd.tcp_built() and hvd.cpu_ops_built()
    assert not hvd.mpi_built() and not hvd.mpi_enabled()
    assert not hvd.mpi_threads_supported()
    assert not hvd.ddl_built() and not hvd.mlsl_built()
    assert hvd.nccl_built() == torch.distributed.is_nccl_available()


def test_crc32c_known_answers(lib):
    assert lib.crc32c(b"123456789") == 0xE3069283
    assert lib.crc32c(b"") == 0
    assert lib.crc32c(b"\x00" * 32) == 0x8A9136AA


def test_crc32c_incremental_matches_oneshot(lib):
    data = bytes(range(256)) * 17 + b"tail-bytes"
    want = lib.crc32c(data)
    for split in (1, 7, 64, 255, len(data) - 1):
        assert lib.crc32c(data[split:], lib.crc32c(data[:split])) == want


def test_crc32c_detects_single_bit_flip(lib):
    data = bytearray(b"G" * 4096)
    want = lib.crc32c(bytes(data))
    data[1000] ^= 0x1
    assert lib.crc32c(bytes(data)) != want


@pytest.mark.parametrize("scenario", [
    "crc_roundtrip", "crc_corrupt_detected", "recv_deadline", "max_frame",
    "handshake_timeout", "stale_generation", "fault_spec", "shm_roundtrip",
    "shm_corrupt_detected", "shm_fallback", "shm_closed_wakes_peer"])
def test_net_selftest(lib, scenario):
    assert lib.net_selftest(scenario) == 1, scenario


def test_net_selftest_unknown_name(lib):
    assert lib.net_selftest("no_such_scenario") == -1


def test_no_tracked_native_binaries():
    """No build artefact of the port (*.so, *.o, *.d, *.a) is tracked, as
    the reference's test holds for horovod_tpu/."""
    out = subprocess.run(["git", "ls-files", "horovod_tpu_torch/"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    tracked = [f for f in out.stdout.splitlines()
               if f.endswith((".so", ".o", ".d", ".a", ".dylib"))]
    assert tracked == [], tracked


_BOTH = r"""
import ctypes, json, os, sys
import numpy as np
from horovod_tpu.common.basics import get_basics
from horovod_tpu.common import ops as ref_ops
ref = get_basics()          # the reference: libhorovod_tpu.so, RTLD_GLOBAL
from horovod_tpu_torch.common import async_ops, core
port = core.get_core()      # the port's copy, loaded after it
out = {"ref_path": ref.lib._name, "port_path": str(port.path),
       "build": port.build_id, "digest": core.digest()}
ref.init()
out["ref_up_port_down"] = [ref.initialized(), port.initialized()]
x = np.ones(4, np.float32)
for i in range(3):
    ref_ops.synchronize(ref_ops.allreduce_async(x, "ref.%d" % i))
core.init()
out["both_up"] = [ref.initialized(), port.initialized()]
async_ops.synchronize(async_ops.allreduce_async(x, "port.0"))
count = lambda m: json.loads(m)["counters"]["tensors_enqueued_total"]
out["enqueued"] = [count(ref.metrics_json()), count(port.metrics_json())]
ref.shutdown()
out["after_ref_down"] = [ref.initialized(), port.initialized()]
out["port_still_works"] = float(async_ops.synchronize(
    async_ops.allreduce_async(x, "port.1"))[0])
core.shutdown()
print("BOTH " + json.dumps(out))
"""


def test_the_reference_and_the_port_core_in_one_process():
    """The reference's core loaded first with RTLD_GLOBAL, then the
    port's: each keeps its own state (started, stopped, its metrics
    registry), and the port's library answers as its own build."""
    env = util.cpu_worker_env(repo_root=str(ROOT), extra_env={
        "HVD_TPU_SIZE": "1", "HVD_TPU_RANK": "0", "JAX_PLATFORMS": "cpu"})
    for key in ("HVD_TPU_ADDRS", "HVD_TPU_RENDEZVOUS_ADDR"):
        env.pop(key, None)
    proc = subprocess.run([sys.executable, "-c", _BOTH], env=env,
                          capture_output=True, text=True, timeout=240,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    line = [v for v in proc.stdout.splitlines() if v.startswith("BOTH ")]
    out = json.loads(line[0][5:])
    assert "libhorovod_tpu.so" in out["ref_path"]
    assert "libhvd_torch_core." in out["port_path"]
    assert out["build"] == out["digest"]
    assert out["ref_up_port_down"] == [True, False]
    assert out["both_up"] == [True, True]
    # each registry counts its own enqueues: 3 through the reference, 1
    # through the port
    assert out["enqueued"] == [3, 1]
    assert out["after_ref_down"] == [False, True]
    assert out["port_still_works"] == 1.0


class _OnCuda0(torch.Tensor):
    """A CPU tensor that reports itself on cuda:0: a CUDA tensor's
    stand-in where there is no card."""
    device = property(lambda self: torch.device("cuda", 0))
    is_cuda = property(lambda self: True)


def _on_cuda0():
    return torch.zeros(4).as_subclass(_OnCuda0)


@pytest.mark.parametrize("call", [
    lambda t, cuda: async_ops.allreduce_async(t, "x"),
    lambda t, cuda: async_ops.reduce_scatter_async(t, "x"),
    lambda t, cuda: async_ops.allgather_async(t, "x"),
    lambda t, cuda: async_ops.broadcast_async(t, 0, "x"),
    lambda t, cuda: async_ops.allreduce_async(torch.zeros(4), "x", out=t),
    lambda t, cuda: async_ops.allreduce_async(torch.zeros(4), "x",
                                              out=cuda),
    lambda t, cuda: async_ops.allreduce_async(_on_cuda0(), "x")])
def test_a_tensor_off_the_cpu_raises_the_named_error(call, monkeypatch):
    """The asynchronous API takes host tensors and CUDA tensors on this
    rank's GPU (ROADMAP A8c2). A tensor on any other device (a "meta"
    tensor here), as input or as ``out=``, an ``out=`` on another device
    than its input (a CPU input with a CUDA ``out=``: with no card here,
    a CPU tensor that ``device_id`` tags as GPU 0), and a CUDA tensor
    where ``init()`` runs on the CPU (whose gloo executor would carry it
    through host memory) raise ``DeviceTensorError`` naming the device,
    before the core starts."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    assert hvd.DeviceTensorError is async_ops.DeviceTensorError
    cuda = torch.zeros(4)
    host = async_ops.device_id
    monkeypatch.setattr(async_ops, "device_id", lambda v, what: 0
                        if v is cuda else host(v, what))
    # init() on the CPU
    monkeypatch.setattr(basics, "is_initialized", lambda: True)
    monkeypatch.setattr(basics, "device", lambda: torch.device("cpu"))
    starts = core.starts()
    with pytest.raises(hvd.DeviceTensorError,
                       match="on meta|out= is on cuda:0 but its input on "
                       "the host|on cuda:0, but init\\(\\) runs on the CPU"):
        call(torch.zeros(4, device="meta"), cuda)
    assert async_ops._handle_map == {} and core.starts() == starts


class _GlooPlane:
    backend = "gloo"


def test_a_cuda_tensor_never_meets_a_gloo_executor(monkeypatch):
    """Behind ``device_id``'s rule, the executor's own: a CUDA tensor
    that meets a device plane on gloo raises ``DevicePlaneError`` (at
    enqueue, and in the executor before any collective), while the CPU
    tensors that the CPU tests tag as device 0 take it."""
    from horovod_tpu_torch.common import device_plane
    monkeypatch.setattr(device_plane, "_plane", _GlooPlane())
    with pytest.raises(device_plane.DevicePlaneError,
                       match="on cuda:0 met the device plane's gloo "
                       "executor"):
        device_plane.require(_on_cuda0())
    assert device_plane.require(torch.zeros(4)) is device_plane._plane
    device_plane._refuse_host_route(_on_cuda0(), "nccl")


def test_single_process_short_circuit():
    """``tests/test_distributed.py::test_single_process_short_circuit``:
    one rank, every collective its own input."""
    env = util.cpu_worker_env(repo_root=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1",
         sys.executable, str(ROOT / "tests" / "torch_port_core_worker.py"),
         "single"], env=env, capture_output=True, text=True, timeout=120,
        cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "single-process OK" in proc.stdout
