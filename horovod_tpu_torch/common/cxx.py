"""Builds the port's host C++ at first use (the negotiation core, the serve
plane's JSON float codec): one g++ a source, all started at once, then
one link, into a library whose name the caller derives from a hash of
its sources and flags (``digest``), so that an edited source is rebuilt.
A file lock in the build directory serialises builders across processes
(xdist workers, the ranks of a job, the replicas of a pool), and the
library appears by an atomic rename. Imports no torch."""

import fcntl
import hashlib
import os
import shutil
import subprocess
import time


class CxxBuildError(RuntimeError):
    """g++ is missing or refused a source of the port's host C++."""


def digest(paths, *flags):
    """16 hex digits of a hash of the flags and of each file's name and
    bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def compiler():
    cxx = os.environ.get("CXX") or shutil.which("g++") or \
        shutil.which("c++")
    if not cxx:
        raise CxxBuildError("no C++ compiler (g++, c++ or $CXX) to build "
                            "the port's host C++")
    return cxx


def build(out, sources, cxx_flags, link_flags=(), libs=(), defines=None,
          version_script=None, what="a library"):
    """Builds the shared library ``out`` (a Path) from ``sources`` (Paths)
    if it is missing; returns the seconds spent (0 when it was there).
    ``defines`` maps a source's name to extra compile flags;
    ``version_script`` is the text of a linker version script. The
    compiler's output goes to ``<out>.log``; a refusal raises
    ``CxxBuildError`` naming ``what``."""
    t0 = time.perf_counter()
    if out.exists():
        return 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one builder across processes
        if out.exists():
            return time.perf_counter() - t0
        cxx = compiler()
        work = out.parent / ("tmp%d" % os.getpid())
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir()
        try:
            procs = []
            for src in sources:
                obj = work / (src.stem + ".o")
                cmd = [cxx, *cxx_flags, *(defines or {}).get(src.name, ()),
                       "-c", str(src), "-o", str(obj)]
                procs.append((src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs, failed = [], []
            for src, obj, proc in procs:
                text = proc.communicate()[0]
                logs.append("== %s (rc %d)\n%s" % (src.name,
                                                   proc.returncode, text))
                if proc.returncode != 0:
                    failed.append("%s (rc %d):\n%s"
                                  % (src.name, proc.returncode, text))
            if not failed:
                link_args = list(link_flags)
                if version_script is not None:
                    script = work / "exports.map"
                    script.write_text(version_script)
                    link_args.append("-Wl,--version-script=%s" % script)
                tmp = work / out.name
                link = subprocess.run(
                    [cxx, *link_args, "-o", str(tmp),
                     *[str(o) for _, o, _ in procs], *libs],
                    capture_output=True, text=True)
                logs.append("== link (rc %d)\n%s%s" % (
                    link.returncode, link.stdout, link.stderr))
                if link.returncode != 0:
                    failed.append("link (rc %d):\n%s"
                                  % (link.returncode, link.stderr))
                else:
                    os.replace(tmp, out)
            out.with_suffix(".log").write_text("\n".join(logs))
            if failed:
                raise CxxBuildError("%s failed to build %s:\n%s"
                                    % (cxx, what, "\n".join(failed)))
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return time.perf_counter() - t0
