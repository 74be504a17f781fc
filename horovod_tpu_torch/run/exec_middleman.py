"""Process-tree middleman for launched workers.

``python -m horovod_tpu_torch.run.exec_middleman -- cmd args...`` (or
this file run as a script) runs the
command and guarantees that when the middleman is told to stop (or the
command exits), the command's WHOLE descendant tree dies — including
grandchildren that called ``setsid`` and thereby escaped the launcher's
process-group kill. Reference analogue: ``safe_shell_exec``'s middleman
that reaps the executor tree
(Horovod's `horovod/run/common/util/safe_shell_exec.py`). A copy of
``horovod_tpu/run/exec_middleman.py``; stdlib only, so it starts
without importing torch.

Descendants are discovered by walking /proc ppid links (Linux), and the
middleman registers itself as a child subreaper
(``PR_SET_CHILD_SUBREAPER``) so descendants orphaned by their parent's
exit — including setsid'd and double-forked ones — reparent to the
middleman instead of init and can still be swept after the command
exits.

When ``HVD_TPU_LOG_FILE`` is set, the middleman additionally TEES the
command's stdout/stderr into that file (line-wise, so concurrent ranks
sharing the launcher's pipes never interleave mid-line) while still
passing everything through — the launcher's failure summary can then
point at the exact log of the first-failing rank.

A command killed by a signal is reported as exit code 128+signum (the
shell convention) instead of a raw negative status, so supervisors and
failure summaries can name the signal.
"""

import os
import signal
import sys
import time


def _ppid_map():
    """pid -> ppid for every live (non-zombie) process, via
    /proc/*/stat; empty on systems without /proc."""
    ppids = {}
    try:
        entries = os.listdir("/proc")
    except OSError:
        return ppids
    for entry in entries:
        if not entry.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % entry, "rb") as f:
                stat = f.read().decode("ascii", "replace")
        except OSError:
            continue
        # comm may contain spaces/parens: state is field 1 and ppid
        # field 2 after the LAST ')'.
        try:
            fields = stat[stat.rindex(")") + 2:].split()
            if fields[0] == "Z":
                continue  # zombie: nothing left to kill
            ppids[int(entry)] = int(fields[1])
        except (ValueError, IndexError):
            continue
    return ppids


def descendants(root_pid):
    """All transitive children of root_pid, leaves first."""
    ppids = _ppid_map()
    children = {}
    for pid, ppid in ppids.items():
        children.setdefault(ppid, []).append(pid)
    found, stack = [], [root_pid]
    while stack:
        for child in children.get(stack.pop(), []):
            found.append(child)
            stack.append(child)
    return list(reversed(found))  # leaves first


def kill_tree(root_pid, sig=signal.SIGTERM, grace=3.0):
    """Signals root+descendants; escalates to SIGKILL after `grace`."""
    targets = descendants(root_pid) + [root_pid]
    for pid in targets:
        try:
            os.kill(pid, sig)
        except (ProcessLookupError, PermissionError):
            pass
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        if not any(_alive(p) for p in targets):
            return
        time.sleep(0.1)
    for pid in descendants(root_pid) + [root_pid]:
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def _alive(pid):
    """True for live processes; zombies count as dead (kill(pid, 0)
    succeeds on them, which would make the grace loop spin its full
    length on already-exited children)."""
    try:
        with open("/proc/%d/stat" % pid, "rb") as f:
            stat = f.read().decode("ascii", "replace")
        return stat[stat.rindex(")") + 2:].split()[0] != "Z"
    except (OSError, ValueError, IndexError):
        pass
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def _become_subreaper():
    """PR_SET_CHILD_SUBREAPER: orphaned descendants reparent to us, not
    init, so they stay sweepable after their parent exits."""
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(36, 1, 0, 0, 0)  # PR_SET_CHILD_SUBREAPER = 36
    except (OSError, AttributeError):
        pass  # non-Linux: tree walk still covers live-parent chains


def _sweep_orphans(exclude):
    """Kills every process currently parented to us except `exclude`
    (reparented stragglers), then reaps zombies."""
    me = os.getpid()
    for pid, ppid in _ppid_map().items():
        if ppid == me and pid != exclude:
            kill_tree(pid)
    try:
        while True:
            pid, _ = os.waitpid(-1, os.WNOHANG)
            if pid == 0:
                break
    except ChildProcessError:
        pass


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--":
        argv = argv[1:]
    if not argv:
        sys.stderr.write("usage: exec_middleman -- cmd args...\n")
        return 2

    _become_subreaper()
    import subprocess
    child = None

    def _terminate(signum, frame):
        # Installed BEFORE the spawn: a teardown signal racing the
        # launch must still sweep (child may be None in that window).
        if child is not None:
            kill_tree(child.pid)
        _sweep_orphans(exclude=child.pid if child else -1)
        sys.exit(128 + signum)

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)
    # SIGHUP: the remote (ssh) path tears down by dropping the channel.
    try:
        signal.signal(signal.SIGHUP, _terminate)
    except (ValueError, AttributeError):
        pass

    log_f = None
    log_path = os.environ.get("HVD_TPU_LOG_FILE")
    if log_path:
        try:
            log_f = open(log_path, "ab", buffering=0)
        except OSError:
            log_f = None  # unwritable log dir: plain pass-through

    if log_f is None:
        child = subprocess.Popen(argv)
        pumps = []
    else:
        import threading
        child = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
        log_lock = threading.Lock()

        def pump(src, dst):
            # Line-wise tee: each complete line is written atomically to
            # the inherited stream, so other ranks' middlemen sharing
            # the launcher's pipe never interleave mid-line.
            for line in iter(src.readline, b""):
                with log_lock:
                    try:
                        log_f.write(line)
                    except (OSError, ValueError):
                        pass  # ValueError: log closed during teardown
                try:
                    dst.write(line)
                    dst.flush()
                except (OSError, ValueError):
                    pass
            src.close()

        pumps = [
            threading.Thread(target=pump,
                             args=(child.stdout, sys.stdout.buffer),
                             daemon=True),
            threading.Thread(target=pump,
                             args=(child.stderr, sys.stderr.buffer),
                             daemon=True),
        ]
        for t in pumps:
            t.start()

    rc = child.wait()
    # The command exited on its own: descendants it left behind (even
    # setsid'd/double-forked ones) have reparented to us — sweep them
    # BEFORE joining the pumps: a straggler holding the pipes would
    # otherwise keep readline blocked and stall teardown; killing it
    # closes the pipes and EOFs the pumps promptly.
    _sweep_orphans(exclude=child.pid)
    for t in pumps:
        t.join(timeout=5)
    if log_f is not None:
        try:
            log_f.close()
        except OSError:
            pass
    # Signal deaths surface as 128+signum (shell convention) so the
    # launcher's failure summary can name the signal.
    return 128 - rc if rc < 0 else rc


if __name__ == "__main__":
    sys.exit(main())
