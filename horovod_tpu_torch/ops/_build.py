"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, in
``horovod_tpu_torch/ops/_build/`` (git-ignored). The file name carries a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Several sources build in parallel, one
``nvcc`` each. Nothing here runs at import: the CPU tests import every
module on machines that have no ``nvcc``.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_fwd", "flash_bwd", "rope", "batch_norm", "wire_codec")
# Every library exports this (csrc/hvd_error.cuh): cudaGetErrorString.
ERROR_SYMBOL = "hvd_error_string"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc():
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the port's "
        "kernels are CUDA C++ and build on a machine with the CUDA toolkit")


def _digest(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / (name + ".cu")]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name):
    return BUILD_DIR / ("lib%s.%s.so" % (name, _digest(name)))


def build(names=SOURCES):
    """Compiles every named source that has no current library, all at
    once. Returns the seconds spent. Compiler output (register and
    shared-memory use from ``-Xptxas=-v``) goes to ``<library>.log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one builder across processes
        todo = [n for n in names if not library_path(n).exists()]
        if todo:
            exe = nvcc()
            procs = []
            for n in todo:
                out = library_path(n)
                tmp = out.with_suffix(".tmp%d" % os.getpid())
                cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / (n + ".cu"))]
                procs.append((n, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for n, out, tmp, proc in procs:
                log = proc.communicate()[0]
                out.with_suffix(".log").write_text(log)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    failed.append("%s.cu (rc %d):\n%s"
                                  % (n, proc.returncode, log))
                else:
                    os.replace(tmp, out)
            if failed:
                raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name):
    """The loaded ctypes library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        err = getattr(lib, ERROR_SYMBOL)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib, err, what):
    """Raises if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        msg = getattr(lib, ERROR_SYMBOL)(err).decode()
        raise RuntimeError("%s: CUDA error %d (%s)" % (what, err, msg))
