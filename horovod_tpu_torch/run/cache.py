"""On-disk result cache for launcher host checks (a copy of
``horovod_tpu/run/cache.py``).

Reference analogue: `horovod/run/util/cache.py` — a 60-minute
staleness window over an on-disk store keyed by the run parameters,
used so repeated `horovodrun` invocations skip re-probing every host
(`horovod/run/run.py:421-424`). TPU-native differences: JSON instead
of cloudpickle (stdlib-only, human-inspectable, no code execution on
load), atomic replace writes that merge with the on-disk state and
prune expired entries, best-effort I/O (an unwritable cache never
breaks a launch), and corrupt/stale-format files self-heal to empty
instead of raising.
"""

import json
import os
import threading
import time


class Cache:
    """String-keyed (timestamp, value) store under ``folder``.

    Entries older than ``staleness_minutes`` read as misses; a
    ``parameters_hash`` mismatch (different launcher arguments than the
    run that wrote the file) invalidates the whole store, like the
    reference's parameters_hash gate."""

    def __init__(self, folder, staleness_minutes, parameters_hash):
        self._file = os.path.join(folder, "cache.json")
        self._ttl = staleness_minutes * 60.0
        self._lock = threading.Lock()
        os.makedirs(folder, exist_ok=True)
        content = {}
        try:
            with open(self._file) as f:
                content = json.load(f)
        except (OSError, ValueError):
            content = {}
        if not isinstance(content, dict) or \
                content.get("parameters_hash") != parameters_hash:
            content = {"parameters_hash": parameters_hash}
        content.setdefault("entries", {})
        self._content = content

    def get(self, key):
        with self._lock:
            ent = self._content["entries"].get(key)
        if not ent:
            return None
        ts, val = ent
        if time.time() - ts <= self._ttl:
            return val
        return None

    def put(self, key, val):
        """Best-effort write-through: merges with whatever is on disk
        (another launcher may have written since we loaded), prunes
        expired entries, and never raises on I/O failure — a read-only
        or vanished cache directory must not break a launch (the cache
        only saves re-probing)."""
        now = time.time()
        with self._lock:
            self._content["entries"][key] = (now, val)
            # Merge: keep the newer timestamp per key so concurrent
            # launchers don't clobber each other's fresh probes.
            try:
                with open(self._file) as f:
                    disk = json.load(f)
                if isinstance(disk, dict) and \
                        disk.get("parameters_hash") == \
                        self._content["parameters_hash"]:
                    ours = self._content["entries"]
                    for k, ent in disk.get("entries", {}).items():
                        try:
                            ts = float(ent[0])
                        except (TypeError, ValueError, IndexError):
                            continue
                        if k not in ours or ts > ours[k][0]:
                            ours[k] = (ts, ent[1])
            except (OSError, ValueError):
                pass
            # Prune: expired entries only grow the file; they already
            # read as misses.
            self._content["entries"] = {
                k: ent for k, ent in self._content["entries"].items()
                if now - ent[0] <= self._ttl}
            tmp = self._file + ".tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump(self._content, f)
                os.replace(tmp, self._file)
            except OSError:
                pass
