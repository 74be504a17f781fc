"""Dynamic rendezvous — launcher-hosted HTTP KV store + worker client.

Copy of ``horovod_tpu/run/rendezvous.py`` for the port, byte-compatible on
the wire: a port worker resolves its topology from the reference's server
and a reference worker from the port's. Where the reference's native
listener binds the reserved port of each worker, the port's rank 0 binds
its reserved port with the process group's ``TCPStore``
(``common/basics.py``).

The launcher starts :class:`RendezvousServer` and hands every worker just
``HVD_TPU_RENDEZVOUS_ADDR`` (+ rank/size). Each worker binds a free port
on its own host, publishes ``rank -> ip:port``, then polls until the full
peer table is present and derives its local/cross topology from it. This
replaces pre-assigned port tables (the fixed ``29500+i`` scheme) with
worker-chosen ports, the way the reference's Gloo path does it
(capability parity with Horovod's horovod/run/rendezvous/
http_server.py:33-205 and horovod/common/gloo/http_store.cc:1-134;
fresh implementation over the Python stdlib http server).

Protocol (scoped KV, values are opaque bytes):
  PUT  /set/<scope>/<key>   body = value         -> 200
  GET  /get/<scope>/<key>                        -> 200 value | 404
  GET  /list/<scope>                             -> 200 JSON {key: utf8 value}

Requests are HMAC-authenticated: the launcher generates a per-job secret
(injected as ``HVD_TPU_RENDEZVOUS_KEY``) and every request carries
``X-Hvd-Auth: hmac_sha256(secret, method + path + body)`` — an
unauthenticated peer on the network cannot poison the peer table
(reference analogue: the HMAC-signed launcher service messages,
``horovod/run/common/util/secret.py:26-36`` + ``network.py``).
"""

import hashlib
import hmac
import json
import os
import secrets as _secrets
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

MAX_VALUE_BYTES = 1 << 20

SCOPE_ADDRS = "addrs"
# Rank 0 publishes the probed, globally-consistent address table here;
# every rank consumes it verbatim (a per-rank interface choice could
# diverge and split the local/cross topology).
SCOPE_RESOLVED = "resolved"


def gen_scope(base, generation):
    """Scope name for one elastic generation. Generation 0 keeps the bare
    name (static jobs never re-register); later generations get their own
    scope so a re-rendezvous never reads stale entries from the previous
    membership (e.g. an old size-3 table during a size-2 restart)."""
    return base if not generation else "%s@g%d" % (base, generation)

PROBE_CONNECT_TIMEOUT = 2.0

AUTH_HEADER = "X-Hvd-Auth"
KEY_ENV = "HVD_TPU_RENDEZVOUS_KEY"


def make_secret():
    return _secrets.token_hex(16)


def _sign(key, method, path, body):
    mac = hmac.new(key.encode(), digestmod=hashlib.sha256)
    mac.update(method.encode())
    mac.update(path.encode())
    mac.update(body or b"")
    return mac.hexdigest()


class RendezvousServer:
    """Threaded HTTP KV server; one per launcher process.

    `key=None` disables authentication (unit tests); the launcher always
    passes a per-job secret."""

    def __init__(self, host="0.0.0.0", port=0, key=None):
        self._store = {}  # (scope, key) -> bytes
        self._lock = threading.Lock()
        store, lock = self._store, self._lock
        auth_key = key

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _reply(self, code, body=b"",
                       ctype="application/octet-stream"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self, body=b""):
                if auth_key is None:
                    return True
                got = self.headers.get(AUTH_HEADER, "")
                want = _sign(auth_key, self.command, self.path, body)
                return hmac.compare_digest(got, want)

            def do_PUT(self):
                parts = self.path.strip("/").split("/")
                if len(parts) != 3 or parts[0] != "set":
                    return self._reply(400, b"bad path")
                # Before buffering the body: a peer without the key
                # can't produce even a well-formed signature header, so
                # reject it here rather than reading (and holding) up
                # to MAX_VALUE_BYTES per unauthenticated connection.
                if auth_key is not None:
                    header = self.headers.get(AUTH_HEADER, "")
                    if len(header) != 64 or any(
                            c not in "0123456789abcdef" for c in header):
                        return self._reply(403, b"bad signature")
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_VALUE_BYTES:
                    return self._reply(413, b"value too large")
                value = self.rfile.read(length)
                if not self._authorized(value):
                    return self._reply(403, b"bad signature")
                with lock:
                    store[(parts[1], parts[2])] = value
                self._reply(200)

            do_POST = do_PUT

            def do_GET(self):
                if not self._authorized():
                    return self._reply(403, b"bad signature")
                parts = self.path.strip("/").split("/")
                if len(parts) == 3 and parts[0] == "get":
                    with lock:
                        value = store.get((parts[1], parts[2]))
                    if value is None:
                        return self._reply(404, b"not found")
                    return self._reply(200, value)
                if len(parts) == 2 and parts[0] == "list":
                    with lock:
                        scoped = {k: v.decode("utf-8", "replace")
                                  for (s, k), v in store.items()
                                  if s == parts[1]}
                    return self._reply(200, json.dumps(scoped).encode(),
                                       "application/json")
                self._reply(400, b"bad path")

        class Server(ThreadingHTTPServer):
            # socketserver's default listen backlog of 5 drops
            # connections when every worker of a large job publishes at
            # once (observed at 32 local ranks: ECONNRESET on PUT).
            request_queue_size = 512
            daemon_threads = True

        self._httpd = Server((host, port), Handler)
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    # Same-process access for the elastic driver (which owns the server):
    # no HTTP round trip, no signing.
    def put_local(self, scope, key, value):
        if isinstance(value, str):
            value = value.encode()
        with self._lock:
            self._store[(scope, str(key))] = value

    def scope_items(self, scope):
        """{key: bytes} snapshot of one scope."""
        with self._lock:
            return {k: v for (s, k), v in self._store.items() if s == scope}

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="hvd-tpu-rendezvous")
        self._thread.start()
        return self.port

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


# ---------------------------------------------------------------------------
# Client side (workers)

def _auth_key():
    return os.environ.get(KEY_ENV)


def _request(method, addr, path, body=None):
    req = urllib.request.Request("http://%s%s" % (addr, path), data=body,
                                 method=method)
    key = _auth_key()
    if key is not None:
        req.add_header(AUTH_HEADER, _sign(key, method, path, body))
    return urllib.request.urlopen(req, timeout=10)


def put(addr, scope, key, value, timeout=30):
    """Publishes key=value, retrying transient connection failures:
    under a large simultaneous fan-out the server may reset or refuse
    individual connections even with a deep listen backlog."""
    if isinstance(value, str):
        value = value.encode()
    deadline = time.monotonic() + timeout
    delay = 0.05
    while True:
        try:
            with _request("PUT", addr, "/set/%s/%s" % (scope, key),
                          value):
                return
        except urllib.error.HTTPError:
            raise  # auth/size errors are not transient
        except OSError as e:
            # DNS failure means a misconfigured address, not a burst —
            # surface it immediately instead of retrying for 30s.
            reason = getattr(e, "reason", e)
            if isinstance(reason, socket.gaierror):
                raise
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "rendezvous PUT to %s kept failing: %s" % (addr, e))
            time.sleep(delay)
            delay = min(delay * 2, 1.0)


def get(addr, scope, key):
    try:
        with _request("GET", addr, "/get/%s/%s" % (scope, key)) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise


def list_scope(addr, scope):
    with _request("GET", addr, "/list/%s" % scope) as resp:
        return json.loads(resp.read().decode())


def wait_all(addr, scope, keys, timeout, poll_interval=0.1):
    """Polls until every key in `keys` is present; returns {key: str}."""
    deadline = time.monotonic() + timeout
    keys = [str(k) for k in keys]
    while True:
        try:
            table = list_scope(addr, scope)
        except urllib.error.HTTPError as e:
            if e.code == 403:
                raise RuntimeError(
                    "rendezvous auth failed (HTTP 403): %s mismatch "
                    "between launcher and worker" % KEY_ENV) from e
            raise
        except (urllib.error.URLError, ConnectionError, socket.timeout) as e:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "rendezvous server at %s unreachable: %s" % (addr, e))
            table = {}
        missing = [k for k in keys if k not in table]
        if not missing:
            return table
        if time.monotonic() > deadline:
            raise TimeoutError(
                "rendezvous timed out after %.0fs waiting for %d/%d "
                "workers (missing ranks: %s...). A worker likely failed "
                "to start — check its log." %
                (timeout, len(missing), len(keys),
                 ",".join(missing[:8])))
        time.sleep(poll_interval)


def routable_ip(peer_host, peer_port=80):
    """The local IP the kernel routes toward `peer_host` (UDP connect
    trick — no packet is sent). Falls back through getfqdn to hostname."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect((peer_host, peer_port or 80))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        for name in (socket.getfqdn(), socket.gethostname()):
            try:
                return socket.gethostbyname(name)
            except OSError:
                continue
        return "127.0.0.1"


def candidate_ips(peer_host=None, peer_port=80):
    """All plausible local IPv4 addresses, the kernel-routed guess
    toward `peer_host` first. On a multi-NIC host the interface the
    kernel routes toward the launcher may not be the one peers can
    reach — publishing every candidate lets the coordinator probe and
    pick a working one (reference analogue: the driver/task services'
    interface discovery, horovod/run/run.py:189-259).
    """
    cands = []
    if peer_host:
        primary = routable_ip(peer_host, peer_port)
        if primary:
            cands.append(primary)
    try:
        import fcntl
        import struct
        for _, name in socket.if_nameindex():
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                try:
                    packed = fcntl.ioctl(
                        s.fileno(), 0x8915,  # SIOCGIFADDR
                        struct.pack("256s", name.encode()[:15]))
                except OSError:  # interface without an IPv4 address
                    continue
            ip = socket.inet_ntoa(packed[20:24])
            if ip not in cands and not ip.startswith("127."):
                cands.append(ip)
    except (OSError, ImportError):  # ImportError: no fcntl off-Linux
        pass
    return cands or ["127.0.0.1"]


class ProbeListener:
    """Accept-and-close TCP listener: lets the coordinator verify this
    worker's advertised interfaces actually accept connections, before
    the process group's store exists. Runs until release_held_ports()."""

    def __init__(self):
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", 0))
        self._sock.listen(128)
        self._sock.settimeout(0.25)
        self.port = self._sock.getsockname()[1]
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-tpu-probe")
        self._thread.start()

    def _loop(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
                conn.close()
            except socket.timeout:
                continue
            except OSError:
                return

    def stop(self):
        self._stop = True
        try:
            self._sock.close()
        except OSError:
            pass


_probe_listeners = []


def probe_connect(ip, port, timeout=None):
    """True when a TCP connect to ip:port succeeds within timeout."""
    try:
        socket.create_connection(
            (ip, port),
            timeout=PROBE_CONNECT_TIMEOUT if timeout is None else timeout
        ).close()
        return True
    except OSError:
        return False


# Reservation sockets held open (bound, not listening) until the
# process group's store binds the port — see reserve_port(hold=True).
_held_sockets = []


def reserve_port(hold=False):
    """Binds an ephemeral port; with ``hold=False`` releases it
    immediately (callers that only need a number and tolerate the tiny
    reuse window, e.g. picking a coordinator port to broadcast).

    ``hold=True`` keeps the socket open (with SO_REUSEPORT, as the
    reference holds it) so no other process can be handed the port
    between the rendezvous and init. ``TCPStore`` sets no SO_REUSEPORT,
    so it cannot bind beside the reservation: rank 0 calls
    `release_held_ports()` just before it binds its store on the port
    (retrying a bind that loses the short race), and the other ranks
    release theirs after init. The reservation socket never listens.
    """
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if hold and hasattr(socket, "SO_REUSEPORT"):
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind(("0.0.0.0", 0))
        _held_sockets.append(s)
        return s.getsockname()[1]
    s.bind(("0.0.0.0", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def release_held_ports():
    """Closes reservation sockets held by reserve_port(hold=True) and
    stops probe listeners: by rank 0 just before its store binds the
    port, by every rank after init."""
    while _held_sockets:
        _held_sockets.pop().close()
    while _probe_listeners:
        _probe_listeners.pop().stop()


def _parse_entry(value):
    """A published worker entry: JSON {"cands": [...], "port": p,
    "probe": pp}, or the legacy plain "ip:port" form."""
    try:
        d = json.loads(value)
        return list(d["cands"]), int(d["port"]), int(d.get("probe", 0))
    except (ValueError, KeyError, TypeError):
        ip, _, port = value.rpartition(":")
        return [ip], int(port), 0


def _resolve_table(table, size, my_rank):
    """Coordinator-side interface selection: for each worker, the first
    published candidate that accepts a TCP connect to the worker's
    probe listener. Raises (fast, actionably) when none does — the
    failure that would otherwise surface as a silent init hang.

    Known blind spot: candidates of workers colocated with the
    coordinator's host are probed over local routing, which succeeds
    even for interfaces other hosts can't reach (the reference's
    interface-set intersection has the same single-vantage limitation,
    run/run.py:189-259). Cross-host misadvertises from the
    coordinator's own host still fall through to the bounded store
    connect (HVD_TPU_START_TIMEOUT); HVD_TPU_RENDEZVOUS_HOST overrides the
    launcher side."""
    import concurrent.futures

    entries = {r: _parse_entry(table[str(r)]) for r in range(size)}

    def pick(r):
        cands, port, probe_port = entries[r]
        if not probe_port:  # legacy entry without a probe listener
            return "%s:%d" % (cands[0], port)
        for ip in cands:
            if probe_connect(ip, probe_port):
                return "%s:%d" % (ip, port)
        raise RuntimeError(
            "rank %d advertised interface(s) %s but none accepts "
            "connections from rank %d (probe port %d). Check firewalls "
            "and that the hosts share a network; on multi-NIC hosts "
            "verify the advertised interfaces are the routable ones."
            % (r, ",".join(cands), my_rank, probe_port))

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(32, size)) as pool:
        return list(pool.map(pick, range(size)))


def resolve_topology(rank, size, rendezvous_addr, timeout=60, generation=0,
                     slots=None):
    """Worker-side rendezvous: publish my candidate addresses + chosen
    port, let rank 0 probe reachability and publish ONE resolved table
    (globally consistent — per-rank interface choices could split the
    derived local/cross topology), derive the HVD_TPU_* env from it.
    `generation` scopes the exchange to one elastic membership epoch;
    `slots` (every rank's local slot) sets the local ranks."""
    from .util import topology_env

    scope_addrs = gen_scope(SCOPE_ADDRS, generation)
    scope_resolved = gen_scope(SCOPE_RESOLVED, generation)
    host = rendezvous_addr.rsplit(":", 1)[0]
    port = int(rendezvous_addr.rsplit(":", 1)[1])
    cands = candidate_ips(host, port)
    my_port = reserve_port(hold=True)
    probe = ProbeListener()
    _probe_listeners.append(probe)
    put(rendezvous_addr, scope_addrs, str(rank),
        json.dumps({"cands": cands, "port": my_port, "probe": probe.port}))
    deadline = time.monotonic() + timeout
    if rank == 0:
        table = wait_all(rendezvous_addr, scope_addrs, range(size),
                         timeout)
        try:
            addrs = _resolve_table(table, size, my_rank=0)
        except RuntimeError as e:
            # Publish the failure so waiting ranks fail fast with the
            # actionable message instead of a generic timeout.
            put(rendezvous_addr, scope_resolved, "table",
                json.dumps({"error": str(e)}))
            raise
        put(rendezvous_addr, scope_resolved, "table", json.dumps(addrs))
    else:
        # Wait out the shared publish deadline PLUS a probing allowance
        # (rank 0 starts probing only after the last publish, and each
        # unreachable candidate burns PROBE_CONNECT_TIMEOUT).
        resolved = wait_all(
            rendezvous_addr, scope_resolved, ["table"],
            max(30.0, deadline - time.monotonic() + 30.0))
        addrs = json.loads(resolved["table"])
        if isinstance(addrs, dict):
            raise RuntimeError(
                "rendezvous coordinator failed: %s"
                % addrs.get("error", "unknown error"))
        if len(addrs) != size:
            raise RuntimeError(
                "resolved rendezvous table has %d entries for world "
                "size %d" % (len(addrs), size))
    return topology_env(rank, addrs, slots)
