"""The float arrays of the serve plane's JSON, formatted and parsed in C
(``native/json_floats.cc``, built with g++ at first use into
``serve/_build/``, git-ignored) by calls that release the interpreter's
lock, so that a replica's HTTP threads do not hold it while its batch
loop waits: json.dumps and json.loads of the 2048-float rows took about
70 % of a replica's CPU a request, all of it under that lock.

:func:`dumps` writes what ``json.dumps(list(row))`` writes up to the
digits: every number parses back to the same double (17 significant
digits where Python writes the shortest), NaN and the infinities as
Python's json writes them. :func:`loads` reads a JSON array's inside as
Python's json would, or returns None for what it does not read the same
way (NaN, Infinity, integers of more than 15 digits, anything but
numbers and commas), which the caller parses with json.loads.
"""

import ctypes
import threading
from pathlib import Path

import numpy as np

from horovod_tpu_torch.common import cxx

SOURCE = Path(__file__).resolve().parent / "native" / "json_floats.cc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall")
LINK_FLAGS = ("-shared", "-Wl,-Bsymbolic")

_lib = None
_lock = threading.Lock()


def library_path():
    return BUILD_DIR / ("libhvd_serve_json.%s.so" % cxx.digest(
        [SOURCE], *CXX_FLAGS, *LINK_FLAGS))


def _library():
    global _lib
    with _lock:
        if _lib is None:
            cxx.build(library_path(), [SOURCE], CXX_FLAGS, LINK_FLAGS,
                      what="the serve plane's JSON float codec")
            lib = ctypes.CDLL(str(library_path()))
            lib.hvd_serve_format_floats.restype = ctypes.c_size_t
            lib.hvd_serve_format_floats.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_size_t]
            lib.hvd_serve_parse_floats.restype = ctypes.c_long
            lib.hvd_serve_parse_floats.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_size_t]
            _lib = lib
    return _lib


def dumps(row):
    """``row`` (a 1-D array or sequence of numbers) as a JSON array."""
    values = np.ascontiguousarray(row, dtype=np.float64).reshape(-1)
    cap = 32 * values.size + 2
    buf = ctypes.create_string_buffer(cap)
    n = _library().hvd_serve_format_floats(values.ctypes.data, values.size,
                                           buf, cap)
    return buf.raw[:n].decode("ascii")


def loads(inside):
    """The float64 array of the numbers of a JSON array's inside (bytes
    between the brackets), or None where Python's json would read it
    differently or not at all."""
    cap = inside.count(b",") + 1
    out = np.empty(cap, np.float64)
    n = _library().hvd_serve_parse_floats(inside, len(inside),
                                          out.ctypes.data, cap)
    return None if n < 0 else out[:n]
