"""The serve plane's JSON float codec (``serve/jsonfloats.py``, C through
ctypes, outside the interpreter's lock) against Python's json: every row
a replica writes parses to the same floats as ``json.dumps`` of it, every
request body it reads fast gives the row ``json.loads`` gives, and every
other body goes through json.loads, so the front door answers as the
reference's does."""

import http.client
import json
import math
import threading

import numpy as np
import pytest

from horovod_tpu.serve.batcher import MicroBatcher as RefBatcher
from horovod_tpu.serve.metrics import ServeMetrics as RefMetrics
from horovod_tpu.serve.server import ReplicaContext as RefContext
from horovod_tpu.serve.server import start_front_door as ref_front_door
from horovod_tpu_torch.serve import jsonfloats, server
from horovod_tpu_torch.serve.batcher import MicroBatcher
from horovod_tpu_torch.serve.metrics import ServeMetrics
from horovod_tpu_torch.serve.server import ReplicaContext, start_front_door

SPECIAL = [0.0, -0.0, 1.0, -1.0, 0.5, 1e16, 1e17, 1e-5, 123456789.0,
           float("nan"), float("inf"), float("-inf"), 5e-324, 1.4e-45,
           3.4028234663852886e38, 2.0 ** -126, 0.1, 1 / 3]


def _same(a, b):
    """Element-wise the same floats: NaN as NaN, zeros by sign."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert type(x) is float and type(y) is float, (x, y)
        if math.isnan(y):
            assert math.isnan(x)
        else:
            assert x == y and math.copysign(1, x) == math.copysign(1, y)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dumps_parses_to_what_json_dumps_parses_to(dtype):
    rng = np.random.default_rng(5)
    rows = [rng.standard_normal(2048).astype(dtype),
            (rng.standard_normal(300) * 10.0 ** rng.integers(
                -40, 38, 300)).astype(dtype),
            np.asarray(SPECIAL, dtype), np.zeros(0, dtype)]
    for row in rows:
        text = jsonfloats.dumps(row)
        _same(json.loads(text), json.loads(json.dumps(
            [float(v) for v in row])))
        assert text.startswith("[") and text.endswith("]")


def test_loads_reads_numbers_as_json_loads_and_refuses_the_rest():
    rng = np.random.default_rng(6)
    x = rng.standard_normal(2048)
    for text in (json.dumps([float(v) for v in x]),
                 json.dumps([float(v) for v in x.astype(np.float32)]),
                 "[1, -0, 0, 1e5, 1E-5, 2.5e+3, 123456789012345, -7]",
                 "[ 1 ,2\t,\n3 ]", "[]", "[  ]", "[0.1]"):
        got = jsonfloats.loads(text[1:-1].encode())
        want = json.loads(text)
        assert got is not None and got.dtype == np.float64
        _same([float(v) for v in got], [float(v) for v in want])
    for inside in (b"NaN", b"Infinity", b"-Infinity", b"1234567890123456",
                   b"1, NaN", b"[1]", b"1,,2", b"1 2", b"+1", b"01", b".5",
                   b"1.", b"--1", b"1e", b"1,", b",1", b'"1"', b"true",
                   b"1.5x"):
        assert jsonfloats.loads(inside) is None, inside


def test_fast_request_takes_the_clients_form_only():
    x = np.random.default_rng(7).standard_normal(16).astype(np.float32)
    body = json.dumps({"id": "r-17", "x": [float(v) for v in x]}).encode()
    rid, got = server._fast_request(body)
    assert rid == "r-17"
    assert np.array_equal(got, np.asarray(json.loads(body)["x"]))
    assert np.array_equal(got.astype(np.float32), x)
    for other in (json.dumps({"x": [1.0], "id": "a"}),  # key order
                  json.dumps({"id": 5, "x": [1.0]}),  # id not a string
                  json.dumps({"id": "é", "x": [1.0]}),  # escaped
                  json.dumps({"id": "a", "x": [[1.0, 2.0]]}),  # nested
                  json.dumps({"id": "a", "x": [float("nan")]}),
                  '{"id": "a", "x": [1.0]} ', '{"id":"a","x":[1.0]}',
                  '{"id": "a\x01", "x": [1.0]}'):
        assert server._fast_request(other.encode()) is None, other


def _door(ctx_cls, door, batcher_cls, metrics_cls):
    m = metrics_cls()
    b = batcher_cls(max_batch=4, max_delay=0.002, metrics=m)
    ctx = ctx_cls(b, m, worker_id=3, request_deadline=5.0)
    ctx.set_weights(7, "cafef00d")
    httpd, port = door(0, ctx)
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            tickets = b.next_batch(timeout=0.05)
            if tickets:
                b.run_batch(lambda f: (f * 2.0 + 0.1).astype(np.float32),
                            tickets, stamp=(7, "cafef00d"))
    threading.Thread(target=loop, daemon=True).start()
    return httpd, port, stop


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", "/infer", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_front_door_answers_as_the_reference_for_every_body_form():
    """The port's and the reference's front doors over the same forward:
    the same status, and for a 200 the same document, float for float,
    whatever form the body takes."""
    port_door = _door(ReplicaContext, start_front_door, MicroBatcher,
                      ServeMetrics)
    ref_door = _door(RefContext, ref_front_door, RefBatcher, RefMetrics)
    x = [float(v) for v in
         np.random.default_rng(8).standard_normal(8).astype(np.float32)]
    bodies = [json.dumps({"id": "r1", "x": x}),
              json.dumps({"x": x, "id": "r2"}),
              json.dumps({"id": 3, "x": x}),
              json.dumps({"id": "r4", "x": [1, 2, 3, 4, 5, 6, 7, 8]}),
              json.dumps({"id": "r5", "x": SPECIAL[:8]}),
              json.dumps({"id": "r6", "x": [[1.0, 2.0]]}),
              '{"id": "r7", "x": [1.0, ]}', '{"id": "r8"}', "not json"]
    try:
        for body in bodies:
            got = _post(port_door[1], body.encode())
            want = _post(ref_door[1], body.encode())
            assert got[0] == want[0], (body, got, want)
            if want[0] == 200:
                assert set(got[1]) == set(want[1])
                _same(got[1].pop("y"), want[1].pop("y"))
                assert got[1] == want[1], body
            else:
                assert got[1]["cause"] == want[1]["cause"], body
    finally:
        for httpd, _, stop in (port_door, ref_door):
            stop.set()
            httpd.shutdown()
