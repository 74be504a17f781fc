"""Stdlib HTTP client for the serve plane (docs/SERVE.md). A copy of
``horovod_tpu/serve/client.py``; it imports no torch. Unlike the
reference it also re-queues a request whose response came back cut short
or garbled (``http.client.HTTPException``: a replica killed mid-answer, or
a connection to a dead replica's port that met itself).

:class:`ServeClient` owns the re-queue half of the serving plane's
fault contract: a replica that answers with a RETRYABLE cause-named
error (``draining``, ``overload``) or that dies mid-request
(connection refused / reset / timed out) costs the caller one retry on
the next endpoint in the rotation, not an error — the request is
re-queued to a surviving replica. Only a request-terminal cause
(``bad-request``, ``shape``, ``frame-corrupt``, ``forward``) or the
total deadline surfaces a :class:`ServeError`, and it names the cause.
"""

import http.client
import json
import time
import urllib.error
import urllib.request


class ServeError(Exception):
    """A request that ended without an answer; ``cause`` names why."""

    def __init__(self, message, cause="error", attempts=0):
        super().__init__(message)
        self.cause = cause
        self.attempts = attempts


class ServeClient:
    """Round-robin client over a set of replica endpoints.

    ``endpoints`` is a list of ``host:port`` strings (or a callable
    returning one, so a supervisor-backed client tracks autoscaling).
    ``total_deadline`` bounds one logical request across all retries.
    """

    def __init__(self, endpoints, total_deadline=15.0,
                 attempt_timeout=12.0, backoff=0.05):
        self._endpoints = endpoints
        self.total_deadline = float(total_deadline)
        self.attempt_timeout = float(attempt_timeout)
        self.backoff = float(backoff)
        self._rr = 0

    def endpoints(self):
        eps = self._endpoints() if callable(self._endpoints) \
            else self._endpoints
        return list(eps)

    def _post(self, endpoint, doc, timeout):
        req = urllib.request.Request(
            "http://%s/infer" % endpoint,
            data=json.dumps(doc).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read().decode("utf-8"))
            except Exception:
                body = {"error": "HTTP %d" % e.code, "cause": "http"}
            body.setdefault("cause", "http")
            body["_status"] = e.code
            return body

    def infer(self, x, rid=""):
        """One logical inference: returns the response doc (``y``,
        ``model_step``, ``weights_crc``, ``replica``) or raises
        :class:`ServeError` with a named cause. Replica death and
        re-queueable rejections are absorbed by retrying the rotation
        until ``total_deadline``."""
        deadline = time.monotonic() + self.total_deadline
        attempts = 0
        last = ("no replica endpoints", "no-endpoints")
        while time.monotonic() < deadline:
            eps = self.endpoints()
            if not eps:
                time.sleep(self.backoff)
                continue
            endpoint = eps[self._rr % len(eps)]
            self._rr += 1
            attempts += 1
            remain = deadline - time.monotonic()
            if remain <= 0:
                break
            try:
                doc = self._post(endpoint,
                                 {"id": rid,
                                  "x": [float(v) for v in x]},
                                 timeout=min(self.attempt_timeout,
                                             max(remain, 0.05)))
            except (OSError, urllib.error.URLError,
                    http.client.HTTPException) as e:
                # Replica gone mid-request (SIGKILL chaos, connection
                # refused/reset, a response cut short): re-queue to the
                # next endpoint.
                last = ("replica %s unreachable: %s" % (endpoint, e),
                        "replica-lost")
                time.sleep(self.backoff)
                continue
            if "y" in doc:
                return doc
            cause = doc.get("cause", "error")
            status = doc.get("_status", 0)
            if status == 503 or cause in ("draining", "overload",
                                          "deadline"):
                last = (doc.get("error", "rejected"), cause)
                time.sleep(self.backoff)
                continue
            raise ServeError(doc.get("error", "request failed"),
                             cause=cause, attempts=attempts)
        raise ServeError(
            "deadline (%.1fs) expired after %d attempt(s); last: %s"
            % (self.total_deadline, attempts, last[0]),
            cause=last[1] if attempts else "deadline",
            attempts=attempts)
