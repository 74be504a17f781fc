"""The port's serve plane (``horovod_tpu_torch.serve``) against the JAX
package's (``horovod_tpu.serve``), on the CPU.

The unit tests mirror ``tests/test_serve.py``'s: the micro-batcher, the
chaos grammar, the histograms and the Prometheus families, the
fingerprint and the lineage's leaf extraction, the swap watcher's edge
cases, the front door's cause-named errors, the client's retry, the load
generator catching wrong weights, the autoscaler and the supervisor's
endpoints. Where a function is pure, the port's output is held equal to
the reference's on the same seeded inputs. The forward runs through
``make_forward(device="cpu")`` against the reference's numpy ``forward``
and its ``jax.jit`` ``make_forward`` (rtol 1e-5 and atol 1e-4, or 2e-6
of the largest output where that is more: the products sum in another
order, and the affine model's unscaled weights at dim 2048 give outputs
up to about 220, whose float32 sums of 2048 products differ by up to
1.5e-4: a third of the limit). Interop runs a reference client, load
generator and supervisor against port replicas' front doors and the
port's load generator against a reference front door; the lineage is
written by one package and served or read by the other; a port trace
shard is merged by the reference's ``trace/merge.py``. The two e2e tests
run real replica subprocesses (``HVD_TPU_SERVE_DEVICE=cpu``) under the
port's elastic driver; their kill hits the replica process, not the
driver's middleman above it, so that no orphaned replica outlives the
test.

The ``hvd-top --serve`` renderer and the serve parts of ``test_fleet.py``
are mirrored in ``tests/test_torch_port_fleet.py`` (the port's
``run.top`` and fleet); below, the reference's ``top`` renders a port
replica's view, whose ``device`` field it ignores.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu import _metrics as ref_metrics_mod
from horovod_tpu.elastic import durable as ref_durable
from horovod_tpu.serve import model as ref_model
from horovod_tpu.serve.batcher import MicroBatcher as RefBatcher
from horovod_tpu.serve.batcher import bucket_for as ref_bucket_for
from horovod_tpu.serve.chaos import ServeChaos as RefChaos
from horovod_tpu.serve.client import ServeClient as RefClient
from horovod_tpu.serve.loadgen import request_input as ref_request_input
from horovod_tpu.serve.loadgen import run_load as ref_run_load
from horovod_tpu.serve.metrics import ServeMetrics as RefMetrics
from horovod_tpu.serve.metrics import (
    histogram_quantile as ref_histogram_quantile)
from horovod_tpu.serve.metrics import (
    render_prometheus as ref_render_serve)
from horovod_tpu.serve.server import ReplicaContext as RefContext
from horovod_tpu.serve.server import start_front_door as ref_front_door
from horovod_tpu.serve.supervisor import ServeSupervisor as RefSupervisor
from horovod_tpu.serve.swap import SwapWatcher as RefWatcher
from horovod_tpu.serve.swap import publish_leaves as ref_publish
from horovod_tpu_torch import _metrics
from horovod_tpu_torch.elastic import durable
from horovod_tpu_torch.elastic.state import EXIT_DRAINED
from horovod_tpu_torch.run import util
from horovod_tpu_torch.run.exec_middleman import _ppid_map
from horovod_tpu_torch.serve import model as smodel
from horovod_tpu_torch.serve import replica as sreplica
from horovod_tpu_torch.serve.batcher import (BUCKETS, MicroBatcher,
                                             QueueFull, bucket_for)
from horovod_tpu_torch.serve.chaos import ServeChaos
from horovod_tpu_torch.serve.client import ServeClient, ServeError
from horovod_tpu_torch.serve.loadgen import (check_response, request_input,
                                             run_load)
from horovod_tpu_torch.serve.metrics import (ServeMetrics,
                                             histogram_quantile,
                                             render_prometheus)
from horovod_tpu_torch.serve.server import ReplicaContext, start_front_door
from horovod_tpu_torch.serve.supervisor import ServeSupervisor
from horovod_tpu_torch.serve.swap import SwapWatcher, publish_leaves
from horovod_tpu_torch.trace import emit

ROOT = Path(__file__).resolve().parent.parent
DIM = 4
# make_forward on the CPU against the numpy forward and the reference's
# jitted one: rtol, and atol or ATOL_SCALE of the largest output
ATOL, ATOL_SCALE, RTOL = 1e-4, 2e-6, 1e-5


def _assert_close(got, want):
    atol = max(ATOL, ATOL_SCALE * float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, atol=atol, rtol=RTOL)


def _leaves(seed, name="affine", dim=DIM):
    return smodel.init_leaves(name, dim, seed=seed)


def _fwd(leaves, name="affine"):
    return smodel.make_forward(name, leaves, device="cpu")


def _run_batches(batcher, forward, stamp=None, stop=None):
    """Drives the batch loop on a thread until `stop` is set."""
    def loop():
        while not stop.is_set():
            tickets = batcher.next_batch(timeout=0.02)
            if tickets:
                batcher.run_batch(forward, tickets, stamp=stamp)
    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# Micro-batcher

def test_bucket_for_powers_of_two_capped():
    assert bucket_for(1, 16) == 1
    assert bucket_for(3, 16) == 4
    assert bucket_for(9, 16) == 16
    assert bucket_for(9, 8) == 8
    assert bucket_for(100, 64) == 64
    for max_batch in (1, 2, 3, 8, 16, 64, 100):
        for n in range(0, 130):
            assert bucket_for(n, max_batch) == ref_bucket_for(n, max_batch)


def test_batcher_batches_and_splits_responses():
    m = ServeMetrics()
    b = MicroBatcher(max_batch=8, max_delay=0.01, metrics=m)
    leaves = _leaves(0)
    fwd = _fwd(leaves)
    tickets = [b.submit(str(i), np.full(DIM, i, np.float32))
               for i in range(5)]
    batch = b.next_batch(timeout=1.0)
    assert len(batch) == 5
    b.run_batch(fwd, batch, stamp=(3, "abcd1234"))
    for i, t in enumerate(tickets):
        assert t.event.is_set()
        assert t.error is None
        expect = ref_model.forward("affine", leaves,
                                   np.full(DIM, i, np.float32))
        assert np.allclose(t.response, expect, atol=1e-5)
        assert t.model_step == 3 and t.weights_crc == "abcd1234"
    snap = m.snapshot()
    assert snap["counters"]["serve_batches_total"] == 1
    assert snap["counters"]["serve_responses_total"] == 5


def test_batcher_releases_on_deadline_without_filling():
    b = MicroBatcher(max_batch=64, max_delay=0.02)
    b.submit("1", np.zeros(DIM, np.float32))
    t0 = time.monotonic()
    batch = b.next_batch(timeout=1.0)
    took = time.monotonic() - t0
    assert len(batch) == 1
    assert took < 0.5  # released by max_delay, not the 1s timeout


def test_batcher_bounded_queue_rejects_promptly():
    m = ServeMetrics()
    b = MicroBatcher(max_batch=4, queue_max=3, metrics=m)
    for i in range(3):
        b.submit(str(i), np.zeros(DIM, np.float32))
    with pytest.raises(QueueFull):
        b.submit("overflow", np.zeros(DIM, np.float32))
    assert m.snapshot()["counters"]["serve_rejects_total"] == 1


def test_batcher_close_drains_and_refuses_admission():
    b = MicroBatcher(max_batch=4)
    t = b.submit("1", np.zeros(DIM, np.float32))
    b.close()
    with pytest.raises(QueueFull):
        b.submit("2", np.zeros(DIM, np.float32))
    batch = b.next_batch(timeout=0.5)
    assert batch == [t]
    assert b.next_batch(timeout=0.05) == []


def test_batcher_shape_mismatch_fails_only_that_request():
    b = MicroBatcher(max_batch=4)
    good = b.submit("g", np.zeros(DIM, np.float32))
    bad = b.submit("b", np.zeros(DIM + 1, np.float32))
    batch = b.next_batch(timeout=0.5)
    b.run_batch(_fwd(_leaves(0)), batch)
    assert good.error is None and good.response is not None
    assert bad.cause == "shape" and bad.event.is_set()


def test_batcher_rejects_non_flat_input_at_admission():
    b = MicroBatcher(max_batch=4)
    with pytest.raises(ValueError):
        b.submit("2d", [[0.0] * DIM, [1.0] * DIM])
    with pytest.raises(ValueError):
        b.submit("3d", np.zeros((1, 2, DIM), np.float32))
    assert b.depth() == 0
    t = b.submit("ok", np.zeros(DIM, np.float32))
    b.run_batch(_fwd(_leaves(0)), b.next_batch(timeout=0.5))
    assert t.error is None and t.response is not None


def test_run_batch_never_raises_on_malformed_ticket():
    b = MicroBatcher(max_batch=4)
    good = b.submit("g", np.zeros(DIM, np.float32))
    bad = b.submit("b", np.zeros(DIM, np.float32))
    bad.x = np.zeros((2, DIM), np.float32)  # simulate the bypass
    batch = b.next_batch(timeout=0.5)
    b.run_batch(_fwd(_leaves(0)), batch)
    assert good.error is None and good.response is not None
    assert bad.cause == "shape" and bad.event.is_set()


def test_forward_error_fails_the_batch_cause_named():
    """A forward that raises (a CUDA error on the card) fails every
    request of its batch with the cause "forward": nothing computes it
    elsewhere."""
    m = ServeMetrics()
    b = MicroBatcher(max_batch=4, metrics=m)
    tickets = [b.submit(str(i), np.zeros(DIM, np.float32))
               for i in range(3)]

    def broken(frame):
        raise RuntimeError("CUDA error: an illegal memory access")

    b.run_batch(broken, b.next_batch(timeout=0.5))
    assert [t.cause for t in tickets] == ["forward"] * 3
    assert all("illegal memory access" in t.error for t in tickets)
    assert all(t.response is None for t in tickets)
    assert m.snapshot()["counters"]["serve_errors_total"] == 3


def test_cancelled_ticket_dropped_without_forward_row():
    m = ServeMetrics()
    b = MicroBatcher(max_batch=4, metrics=m)
    kept = b.submit("kept", np.zeros(DIM, np.float32))
    gone = b.submit("gone", np.ones(DIM, np.float32))
    gone.cancel()
    batch = b.next_batch(timeout=0.5)
    assert gone not in batch
    b.run_batch(_fwd(_leaves(0)), batch)
    assert kept.response is not None
    assert gone.response is None and not gone.event.is_set()
    snap = m.snapshot()
    assert snap["counters"]["serve_cancelled_total"] == 1
    assert snap["counters"]["serve_responses_total"] == 1
    late = b.submit("late", np.zeros(DIM, np.float32))
    batch = b.next_batch(timeout=0.5)
    late.cancel()
    b.run_batch(_fwd(_leaves(0)), batch)
    assert late.response is None
    assert m.snapshot()["counters"]["serve_cancelled_total"] == 2


def test_corrupt_frame_fails_request_with_named_cause():
    """One byte of one row flipped by the seeded chaos fails exactly that
    request; the reference's batcher under the same seed fails the same
    one."""
    leaves = _leaves(0)
    failed = []
    for batcher_cls, chaos_cls, fwd in (
            (MicroBatcher, ServeChaos, _fwd(leaves)),
            (RefBatcher, RefChaos,
             lambda x: ref_model.forward("affine", leaves, x))):
        m = ServeMetrics()
        chaos = chaos_cls(seed=7, corrupt_batches=(1,))
        b = batcher_cls(max_batch=8, metrics=m, chaos=chaos)
        tickets = [b.submit(str(i), np.full(DIM, i, np.float32))
                   for i in range(4)]
        b.run_batch(fwd, b.next_batch(timeout=0.5))
        corrupted = [t for t in tickets if t.cause == "frame-corrupt"]
        answered = [t for t in tickets if t.error is None]
        assert len(corrupted) == 1 and len(answered) == 3
        assert "not computed" in corrupted[0].error
        assert m.snapshot()["counters"]["serve_frame_corrupt_total"] == 1
        failed.append(corrupted[0].rid)
        t2 = [b.submit("x%d" % i, np.full(DIM, i, np.float32))
              for i in range(2)]
        b.run_batch(fwd, b.next_batch(timeout=0.5))
        assert all(t.error is None for t in t2)
    assert failed[0] == failed[1]


# ---------------------------------------------------------------------------
# Chaos grammar

@pytest.mark.parametrize("spec", [
    "seed=9;corrupt_batch=2,5;kill_after=1.5", "seed=3;corrupt_batch=1",
    " seed = 4 ; kill_after = 0.25 ;", "corrupt_batch=7,", ""])
def test_serve_chaos_parse_grammar(spec):
    c = ServeChaos.parse(spec)
    r = RefChaos.parse(spec)
    assert (c.seed, c.corrupt_batches, c.kill_after) == (
        r.seed, r.corrupt_batches, r.kill_after)
    if spec.startswith("seed=9"):
        assert c.seed == 9 and c.corrupt_batches == {2, 5}
        assert c.kill_after == 1.5
    assert ServeChaos.from_env({"HVD_TPU_SERVE_CHAOS_SPEC": ""}) is None
    got = ServeChaos.from_env(
        {"HVD_TPU_SERVE_CHAOS_SPEC": "seed=3;corrupt_batch=1"})
    assert got.seed == 3
    with pytest.raises(ValueError):
        ServeChaos.parse("seed=1;explode=now")


# ---------------------------------------------------------------------------
# Metrics

def _observed(metrics_cls):
    m = metrics_cls()
    for v in [0.002] * 50 + [0.004] * 45 + [0.5] * 5 + [12.0]:
        m.observe("serve_request_seconds", v)
    for v in (0, 3, 3, 300):
        m.observe("serve_queue_depth_sampled", v)
    m.inc("serve_requests_total", 3)
    m.set_gauge("serve_model_step", 20)
    m.add_gauge("serve_inflight", 2)
    return m


def test_histogram_quantiles_and_latency():
    m = ServeMetrics()
    for v in [0.002] * 50 + [0.004] * 45 + [0.5] * 5:
        m.observe("serve_request_seconds", v)
    p50, p99 = m.latency_quantiles()
    assert p50 is not None and p50 <= 0.005
    assert p99 >= 0.25
    snap = m.snapshot()["histograms"]["serve_request_seconds"]
    assert snap["count"] == 100
    assert histogram_quantile(snap, 0.0) <= histogram_quantile(snap, 1.0)
    port, ref = _observed(ServeMetrics), _observed(RefMetrics)
    assert port.snapshot() == ref.snapshot()
    assert port.latency_quantiles() == ref.latency_quantiles()
    for snap in list(port.snapshot()["histograms"].values()) + [
            {"bounds": [1.0], "counts": [0, 0], "sum": 0.0, "count": 0}]:
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert histogram_quantile(snap, q) == \
                ref_histogram_quantile(snap, q)


def test_metrics_render_prometheus_serve_families():
    m = ServeMetrics()
    m.inc("serve_requests_total", 3)
    m.observe("serve_request_seconds", 0.01)
    text = render_prometheus(m)
    assert "hvdtpu_serve_requests_total 3" in text
    assert "hvdtpu_serve_request_seconds_bucket" in text
    assert text == ref_render_serve(m)
    m = _observed(ServeMetrics)
    assert render_prometheus(m) == ref_render_serve(m)
    snap = dict(m.snapshot(), per_group={"2": {"negotiated_total": 5},
                                         "10": {"negotiated_total": 1.5}},
                rank_lag_seconds=[0.0, 0.25, 3])
    for labels in (None, {"rank": 1, "job": "serve"}):
        assert _metrics.render_prometheus(snap, labels) == \
            ref_metrics_mod.render_prometheus(snap, labels)
    for v in (0, 3, 3.0, 2.5, -1, 1e15, 1e16, 0.1):
        assert _metrics._fmt(v) == ref_metrics_mod._fmt(v)


# ---------------------------------------------------------------------------
# Model registry / fingerprint / lineage extraction

@pytest.mark.parametrize("name,dim", [("affine", 4), ("affine", 16),
                                      ("mlp", 16), ("mlp", 64)])
def test_fingerprint_identifies_weight_sets(name, dim):
    a, b = _leaves(1, name, dim), _leaves(2, name, dim)
    assert smodel.fingerprint(a) == smodel.fingerprint(_leaves(1, name,
                                                               dim))
    assert smodel.fingerprint(a) != smodel.fingerprint(b)
    assert smodel.fingerprint(a) == ref_model.fingerprint(
        ref_model.init_leaves(name, dim, seed=1))
    for key in a:
        assert np.array_equal(a[key], ref_model.init_leaves(
            name, dim, seed=1)[key])


def test_extract_leaves_from_training_lineage_paths():
    leaves = _leaves(3)
    raw = {".w": leaves["w"], ".b": leaves["b"],
           ".opt.0.mu.w": np.zeros((DIM, DIM), np.float32),
           ".step": np.int64(7)}
    out = smodel.extract_leaves(raw, _leaves(0))
    assert out is not None
    assert smodel.fingerprint(out) == smodel.fingerprint(leaves)
    ref = ref_model.extract_leaves(raw, _leaves(0))
    assert set(out) == set(ref)
    for key in out:
        assert out[key].dtype == ref[key].dtype == np.float32
        assert np.array_equal(out[key], ref[key])
    for bad in ({".w": leaves["w"]},
                {".w": np.zeros((2, 2), np.float32), ".b": leaves["b"]}):
        assert smodel.extract_leaves(bad, _leaves(0)) is None
        assert ref_model.extract_leaves(bad, _leaves(0)) is None
    # the port's own training lineage holds tensors (bfloat16 ones too)
    tensors = {".model.w": torch.from_numpy(leaves["w"]),
               ".model.b": torch.from_numpy(leaves["b"]).bfloat16()}
    out = smodel.extract_leaves(tensors, _leaves(0))
    assert np.array_equal(out["w"], leaves["w"])
    assert np.array_equal(out["b"], tensors[".model.b"].float().numpy())


@pytest.mark.parametrize("name,dim", [("affine", 16), ("mlp", 16),
                                      ("affine", 2048), ("mlp", 2048)])
def test_forward_parity_every_bucket(name, dim, monkeypatch):
    """make_forward on the CPU against the reference's numpy forward and
    its jax.jit make_forward, for every bucket of the batcher."""
    monkeypatch.delenv("HVD_TPU_SERVE_JIT", raising=False)
    leaves = _leaves(4, name, dim)
    fwd = smodel.make_forward(name, leaves, device="cpu")
    assert fwd.device == torch.device("cpu")
    jitted = ref_model.make_forward(name, leaves)
    rng = np.random.RandomState(dim)
    for bucket in BUCKETS:
        x = rng.standard_normal((bucket, dim)).astype(np.float32)
        got = fwd(x)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert got.shape == (bucket, dim)
        _assert_close(got, ref_model.forward(name, leaves, x))
        _assert_close(got, jitted(x))
        assert np.array_equal(smodel.forward(name, leaves, x),
                              ref_model.forward(name, leaves, x))


def test_make_forward_holds_its_own_leaves():
    """The forward's weights are its own copy: a later change to the dict
    it was built from (a swap loading into it) does not reach it."""
    leaves = _leaves(5)
    fwd = _fwd(leaves)
    x = np.ones((2, DIM), np.float32)
    before = fwd(x)
    leaves["w"] += 1.0
    assert np.array_equal(fwd(x), before)
    with pytest.raises(ValueError, match="unknown serve model"):
        smodel.make_forward("resnet", leaves, device="cpu")


# ---------------------------------------------------------------------------
# Rolling swap watcher

def _watcher(ckpt_dir, metrics=None, current=(-1,), flips=None,
             draining_fn=None, stagger=0.0):
    flips = flips if flips is not None else []

    def flip(step, leaves, crc):
        current[0] = step
        flips.append((step, crc))

    return SwapWatcher(str(ckpt_dir), _leaves(0),
                       current_step_fn=lambda: current[0],
                       flip_fn=flip, metrics=metrics,
                       draining_fn=draining_fn, stagger=stagger), flips


def test_swap_watcher_flips_to_newer_checkpoint(tmp_path):
    m = ServeMetrics()
    leaves = _leaves(5)
    publish_leaves(str(tmp_path), 10, leaves)
    current = [-1]
    w, flips = _watcher(tmp_path, metrics=m, current=current)
    assert w.poll_once() == 10
    assert flips == [(10, smodel.fingerprint(leaves))]
    assert w.poll_once() is None
    assert m.snapshot()["counters"]["serve_swaps_total"] == 1


def test_swap_watcher_rejects_torn_manifest_and_falls_back(tmp_path):
    m = ServeMetrics()
    good = _leaves(6)
    publish_leaves(str(tmp_path), 10, good)
    publish_leaves(str(tmp_path), 20, _leaves(7))
    step20 = [p for s, g, p in durable.list_checkpoints(str(tmp_path))
              if s == 20][0]
    manifest = os.path.join(step20, durable.MANIFEST_NAME)
    raw = open(manifest, "rb").read()
    with open(manifest, "wb") as f:
        f.write(raw[:len(raw) // 2])
    current = [-1]
    w, flips = _watcher(tmp_path, metrics=m, current=current)
    assert w.poll_once() == 10
    assert flips == [(10, smodel.fingerprint(good))]
    assert m.snapshot()["counters"]["serve_swap_rejects_total"] == 1
    assert w.poll_once() is None
    assert m.snapshot()["counters"]["serve_swap_rejects_total"] == 1


def test_swap_watcher_rejects_crc_invalid_shard(tmp_path):
    m = ServeMetrics()
    publish_leaves(str(tmp_path), 10, _leaves(8))
    step10 = [p for s, g, p in durable.list_checkpoints(str(tmp_path))
              if s == 10][0]
    shard = [os.path.join(step10, f) for f in os.listdir(step10)
             if f != durable.MANIFEST_NAME][0]
    blob = bytearray(open(shard, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(bytes(blob))
    current = [5]
    w, flips = _watcher(tmp_path, metrics=m, current=current)
    assert w.poll_once() is None
    assert flips == []
    assert current[0] == 5
    assert m.snapshot()["counters"]["serve_swap_rejects_total"] == 1


def test_swap_abandoned_when_drain_wins_the_race(tmp_path):
    m = ServeMetrics()
    publish_leaves(str(tmp_path), 10, _leaves(9))
    calls = [0]

    def draining():
        calls[0] += 1
        return calls[0] > 1

    current = [-1]
    w, flips = _watcher(tmp_path, metrics=m, current=current,
                        draining_fn=draining)
    assert w.poll_once() is None
    assert flips == []
    snap = m.snapshot()["counters"]
    assert snap["serve_swap_aborts_total"] == 1
    assert snap["serve_swaps_total"] == 0


# ---------------------------------------------------------------------------
# Front door + client

def _replica_fixture(max_batch=8, deadline=5.0, leaves=None):
    m = ServeMetrics()
    b = MicroBatcher(max_batch=max_batch, max_delay=0.003, metrics=m)
    leaves = _leaves(0) if leaves is None else leaves
    crc = smodel.fingerprint(leaves)
    ctx = ReplicaContext(b, m, worker_id=0, request_deadline=deadline,
                         device="cpu")
    ctx.set_weights(1, crc)
    httpd, port = start_front_door(0, ctx)
    stop = threading.Event()
    _run_batches(b, _fwd(leaves), stamp=(1, crc), stop=stop)
    return ctx, b, httpd, port, stop, leaves, crc


def _get(port, path):
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=5) as r:
        return json.loads(r.read())


def test_front_door_roundtrip_and_error_causes():
    ctx, b, httpd, port, stop, leaves, crc = _replica_fixture()
    try:
        client = ServeClient(["127.0.0.1:%d" % port], total_deadline=5)
        x = np.arange(DIM, dtype=np.float32)
        doc = client.infer(x, rid="r1")
        assert np.allclose(doc["y"], smodel.forward("affine", leaves, x),
                           atol=1e-4)
        assert doc["weights_crc"] == crc and doc["model_step"] == 1

        for body in (b"{nope", json.dumps(
                {"id": "r2", "x": [[0.0] * DIM, [1.0] * DIM]}).encode()):
            req = urllib.request.Request(
                "http://127.0.0.1:%d/infer" % port, data=body,
                headers={"Content-Type": "application/json"},
                method="POST")
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=5)
            assert err.value.code == 400
            assert json.loads(err.value.read())["cause"] == "bad-request"
        doc = client.infer(x, rid="r3")
        assert np.allclose(doc["y"], smodel.forward("affine", leaves, x),
                           atol=1e-4)

        view = _get(port, "/serve")
        assert view["state"] == "serving"
        assert view["weights_crc"] == crc
        assert view["responses_total"] >= 1
        assert view["device"] == "cpu"
        assert _get(port, "/healthz") == {"ok": True, "draining": False,
                                          "replica": 0, "device": "cpu"}

        ctx.begin_drain()
        b.close()
        with pytest.raises(ServeError) as err:
            ServeClient(["127.0.0.1:%d" % port],
                        total_deadline=0.4).infer(x)
        assert err.value.cause == "draining"
    finally:
        stop.set()
        httpd.shutdown()


def test_client_retries_to_surviving_replica():
    ctx, b, httpd, port, stop, leaves, crc = _replica_fixture()
    try:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
        s.close()
        client = ServeClient(
            ["127.0.0.1:%d" % dead_port, "127.0.0.1:%d" % port],
            total_deadline=5)
        for i in range(4):
            doc = client.infer(np.full(DIM, i, np.float32))
            assert doc["replica"] == 0
    finally:
        stop.set()
        httpd.shutdown()


@pytest.mark.parametrize("reply", [b"", b"garbage\r\n\r\n",
                                   b"HTTP/1.1 200 OK\r\nContent-Length: "
                                   b"100\r\n\r\n{\"y\": [1"])
def test_client_requeues_a_response_cut_short(reply):
    """A replica that dies mid-answer (nothing, a garbled status line, a
    body cut short) costs a retry on the next endpoint, not an error."""
    ctx, b, httpd, port, stop, leaves, crc = _replica_fixture()
    broken = socket.socket()
    broken.bind(("127.0.0.1", 0))
    broken.listen(8)

    def answer_badly():
        while True:
            try:
                conn, _ = broken.accept()
            except OSError:
                return
            conn.recv(65536)
            conn.sendall(reply)
            conn.close()

    threading.Thread(target=answer_badly, daemon=True).start()
    try:
        client = ServeClient(
            ["127.0.0.1:%d" % broken.getsockname()[1],
             "127.0.0.1:%d" % port], total_deadline=5)
        for i in range(4):
            doc = client.infer(np.full(DIM, i, np.float32))
            assert doc["replica"] == 0
    finally:
        broken.close()
        stop.set()
        httpd.shutdown()


def test_loadgen_detects_wrong_weights():
    for seed, rid, dim in ((0, 1, DIM), (3, 17, 16), (2 ** 20, 5, 2048)):
        assert np.array_equal(request_input(seed, rid, dim),
                              ref_request_input(seed, rid, dim))
    x = request_input(seed=0, rid=1, dim=DIM)
    leaves = _leaves(0)
    crc = smodel.fingerprint(leaves)
    y = smodel.forward("affine", leaves, x)
    good = {"y": [float(v) for v in y], "weights_crc": crc}
    assert check_response(good, x, "affine", {crc: leaves}) is None
    wrong = {"y": [float(v) for v in smodel.forward(
        "affine", _leaves(1), x)], "weights_crc": crc}
    assert "does not match" in check_response(
        wrong, x, "affine", {crc: leaves})
    unknown = {"y": [0.0] * DIM, "weights_crc": "ffffffff"}
    assert "unknown" in check_response(
        unknown, x, "affine", {crc: leaves})


# ---------------------------------------------------------------------------
# Supervisor autoscaler (unit, against a stub driver)

class _StubDriver:
    def __init__(self, live, hosts=None):
        self._live = list(live)
        self._hosts = hosts or {wid: "localhost" for wid in live}
        self.resized_to = None
        self.drained = None

    def live_workers(self):
        return list(self._live)

    def worker_hosts(self):
        return dict(self._hosts)

    def resize(self, n):
        self.resized_to = n

    def request_drain(self, victims, grace=None):
        self.drained = victims


def _stub_supervisor(live, views, **kwargs):
    sup = ServeSupervisor(
        ["true"], {"localhost": 8}, min_replicas=1, max_replicas=4,
        **kwargs)
    sup.driver = _StubDriver(live)
    sup.replica_views = lambda timeout=0.5: views
    return sup


def test_autoscaler_grows_on_queue_pressure():
    views = [{"queue_depth": 9}, {"queue_depth": 7}]
    sup = _stub_supervisor([0, 1], views, scale_up_queue=4.0)
    assert sup.autoscale_once() == 1
    assert sup.driver.resized_to == 3
    assert sup.scale_events[-1]["to"] == 3


def test_autoscaler_shrinks_after_sustained_idle():
    views = [{"queue_depth": 0}, {"queue_depth": 0}]
    sup = _stub_supervisor([0, 3], views, scale_down_idle=0.0)
    assert sup.autoscale_once() in (0, -1)
    assert sup.autoscale_once() == -1
    assert sup.driver.resized_to == 1
    assert sup.driver.drained == [3]


def test_autoscaler_respects_ceiling():
    views = [{"queue_depth": 50}] * 4
    sup = _stub_supervisor([0, 1, 2, 3], views)
    assert sup.autoscale_once() == 0
    assert sup.driver.resized_to is None


def test_supervisor_endpoints_follow_worker_hosts():
    sup = _stub_supervisor([0, 1, 2], [])
    sup.driver = _StubDriver(
        [0, 1, 2], hosts={0: "localhost", 1: "nodeB", 2: "127.0.0.1"})
    base = sup.port_base
    assert sup.endpoints() == ["127.0.0.1:%d" % base,
                               "nodeB:%d" % (base + 1),
                               "127.0.0.1:%d" % (base + 2)]


def test_supervisor_status_endpoints_aggregate_replicas():
    """The status server's /serve sums the replicas' counters and carries
    each replica's document (with its device); /healthz counts the live
    replicas."""
    ctx, b, httpd, port, stop, leaves, crc = _replica_fixture()
    try:
        ServeClient(["127.0.0.1:%d" % port]).infer(np.ones(DIM,
                                                           np.float32))
        sup = ServeSupervisor(["true"], {"localhost": 2}, port_base=port)
        sup.driver = _StubDriver([0])
        status, status_port = sup.start_status_server(0)
        try:
            doc = _get(status_port, "/serve")
            assert doc["kind"] == "serve-pool"
            assert doc["replicas"] == doc["replicas_reporting"] == 1
            assert doc["responses_total"] == 1
            assert doc["model_steps"] == [1]
            assert doc["per_replica"][0]["device"] == "cpu"
            assert _get(status_port, "/healthz") == {"ok": True,
                                                     "replicas": 1}
        finally:
            status.shutdown()
    finally:
        stop.set()
        httpd.shutdown()


# ---------------------------------------------------------------------------
# Interop with the reference's wire

def test_reference_client_and_loadgen_drive_a_port_front_door():
    """The reference's client and load generator against a port replica's
    front door; the reference's supervisor aggregates its /serve
    document, whose new ``device`` field its readers ignore (hvd-top
    renders the row as before)."""
    leaves = _leaves(11)
    ctx, b, httpd, port, stop, leaves, crc = _replica_fixture(
        leaves=leaves)
    try:
        ep = "127.0.0.1:%d" % port
        doc = RefClient([ep], total_deadline=5).infer(
            np.arange(DIM, dtype=np.float32), rid="ref")
        assert doc["weights_crc"] == ref_model.fingerprint(leaves)
        res, wall = ref_run_load([ep], rate=50, duration=0.6, dim=DIM,
                                 seed=1, leaves_by_crc={crc: leaves},
                                 workers=3)
        assert res.errors == [] and res.mismatches == []
        assert res.ok == 30 and res.by_crc == {crc: 30}
        sup = RefSupervisor(["true"], {"localhost": 2}, port_base=port)
        sup.driver = _StubDriver([0])
        view = sup.view()
        assert view["responses_total"] == 31
        assert view["per_replica"][0]["device"] == "cpu"
        from horovod_tpu.run import top
        frame = top.render_serve(view, ep)
        assert crc in frame
    finally:
        stop.set()
        httpd.shutdown()


def test_port_loadgen_drives_a_reference_front_door(monkeypatch):
    monkeypatch.setenv("HVD_TPU_SERVE_JIT", "0")
    leaves = ref_model.init_leaves("affine", DIM, seed=12)
    crc = ref_model.fingerprint(leaves)
    m = RefMetrics()
    b = RefBatcher(max_batch=8, max_delay=0.003, metrics=m)
    ctx = RefContext(b, m, worker_id=0, request_deadline=5.0)
    ctx.set_weights(3, crc)
    httpd, port = ref_front_door(0, ctx)
    stop = threading.Event()
    _run_batches(b, ref_model.make_forward("affine", leaves), stamp=(3, crc),
                 stop=stop)
    try:
        ep = "127.0.0.1:%d" % port
        res, wall = run_load([ep], rate=50, duration=0.6, dim=DIM, seed=2,
                             leaves_by_crc={crc: leaves}, workers=3)
        assert res.errors == [] and res.mismatches == []
        assert res.ok == 30 and res.by_crc == {crc: 30}
        sup = ServeSupervisor(["true"], {"localhost": 2}, port_base=port)
        sup.driver = _StubDriver([0])
        view = sup.view()
        assert view["responses_total"] == 30
        assert "device" not in view["per_replica"][0]
    finally:
        stop.set()
        httpd.shutdown()


# ---------------------------------------------------------------------------
# The lineage in both directions

def _replica(ckpt_dir, model="affine", dim=DIM):
    args = sreplica.make_parser().parse_args(
        ["--model", model, "--dim", str(dim), "--ckpt-dir", str(ckpt_dir),
         "--device", "cpu", "--swap-stagger", "0"])
    return sreplica.Replica(args)


def test_reference_lineage_served_by_a_port_replica(tmp_path, monkeypatch):
    """A lineage the reference's publish_leaves wrote: the port replica
    loads it, every answer carries the reference's fingerprint of those
    leaves, and a newer reference step swaps in."""
    monkeypatch.setenv("HVD_TPU_WORKER_ID", "0")
    old = ref_model.init_leaves("mlp", 8, seed=21)
    new = ref_model.init_leaves("mlp", 8, seed=22)
    ref_publish(str(tmp_path), 10, old)
    rep = _replica(tmp_path, model="mlp", dim=8)
    assert rep.device == torch.device("cpu")
    rep._load_initial()
    assert (rep.step, rep.crc) == (10, ref_model.fingerprint(old))
    httpd, port = start_front_door(0, rep.ctx)
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            tickets = rep.batcher.next_batch(timeout=0.02)
            if tickets:
                fwd, stamp = rep._snapshot_forward()
                rep.batcher.run_batch(fwd, tickets, stamp=stamp)

    threading.Thread(target=loop, daemon=True).start()
    try:
        client = RefClient(["127.0.0.1:%d" % port], total_deadline=5)
        x = ref_request_input(0, 1, 8)
        doc = client.infer(x)
        assert doc["weights_crc"] == ref_model.fingerprint(old)
        _assert_close(doc["y"], ref_model.forward("mlp", old, x))
        ref_publish(str(tmp_path), 20, new)
        watcher = SwapWatcher(str(tmp_path), rep.template,
                              current_step_fn=lambda: rep.step,
                              flip_fn=rep._flip, metrics=rep.metrics)
        assert watcher.poll_once() == 20
        doc = client.infer(x)
        assert (doc["model_step"], doc["weights_crc"]) == (
            20, ref_model.fingerprint(new))
        _assert_close(doc["y"], ref_model.forward("mlp", new, x))
        assert _get(port, "/healthz")["device"] == "cpu"
    finally:
        stop.set()
        httpd.shutdown()


@pytest.mark.parametrize("max_batch,buckets", [(16, [1, 2, 4, 8, 16]),
                                               (6, [1, 2, 4, 6])])
def test_replica_flip_runs_every_bucket_before_publishing(
        tmp_path, monkeypatch, max_batch, buckets):
    """A flip (boot, respawn, swap) calls the new forward once in each
    bucket the batcher can form, before the replica publishes it."""
    monkeypatch.setenv("HVD_TPU_WORKER_ID", "0")
    args = sreplica.make_parser().parse_args(
        ["--model", "affine", "--dim", str(DIM), "--device", "cpu",
         "--max-batch", str(max_batch)])
    rep = sreplica.Replica(args)
    made, calls = [], []
    real = smodel.make_forward

    def make_forward(name, leaves, device=None):
        fwd = real(name, leaves, device=device)

        def run(x):
            calls.append((x.shape, rep.forward is run))
            return fwd(x)
        made.append(run)
        return run

    monkeypatch.setattr(smodel, "make_forward", make_forward)
    rep._load_initial()
    assert calls == [((b, DIM), False) for b in buckets]
    assert rep.forward is made[-1]
    calls.clear()
    leaves = smodel.init_leaves("affine", DIM, seed=7)
    rep._flip(20, leaves, smodel.fingerprint(leaves))
    assert calls == [((b, DIM), False) for b in buckets]
    assert (rep.step, rep.forward) == (20, made[-1])


def test_port_lineage_read_by_the_reference(tmp_path):
    leaves = _leaves(23, "mlp", 8)
    assert publish_leaves(str(tmp_path), 7, leaves) == 7
    manifest, path = ref_durable.latest_valid_manifest(str(tmp_path))
    assert manifest is not None and manifest["step"] == 7
    raw = ref_durable.load_leaves(manifest, path, verify=True)
    template = ref_model.init_leaves("mlp", 8)
    got = ref_model.extract_leaves(raw, template)
    assert set(got) == set(leaves)
    for key in leaves:
        assert np.array_equal(got[key], leaves[key])
    assert ref_model.fingerprint(got) == smodel.fingerprint(leaves)
    flips = []
    watcher = RefWatcher(str(tmp_path), template,
                         current_step_fn=lambda: -1,
                         flip_fn=lambda s, lv, crc: flips.append((s, crc)))
    assert watcher.poll_once() == 7
    assert flips == [(7, smodel.fingerprint(leaves))]


# ---------------------------------------------------------------------------
# Trace shards

def test_port_trace_shard_merged_by_the_reference(tmp_path, monkeypatch):
    from horovod_tpu.trace.merge import merge_shards
    monkeypatch.delenv("HVD_TPU_TRACE_DIR", raising=False)
    emit._shards.clear()
    off = emit.shard_for("serve_r9")
    assert not off.enabled
    off.span("noop", 0, 1)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("HVD_TPU_TRACE_DIR", str(trace_dir))
    emit._shards.clear()
    try:
        em = emit.shard_for("serve_r9", rank=9)
        assert em.enabled and emit.shard_for("serve_r9") is em
        t0 = emit.now_ns()
        em.span("serve.batch", t0, emit.now_ns(), nbytes=4, cycle=7)
        merged = merge_shards([str(trace_dir / "trace_serve_r9.jsonl")])
    finally:
        emit._shards.clear()
    assert 9 in merged.ranks
    spans = merged.ranks[9]["spans"]
    assert len(spans) == 1
    assert spans[0]["n"] == "serve.batch"
    assert spans[0]["p"] == emit.TRACE_REQUEST == 8
    assert spans[0]["b"] == 4 and spans[0]["c"] == 7


# ---------------------------------------------------------------------------
# The replica without a GPU

def test_replica_without_a_gpu_exits_naming_the_error():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    env = util.cpu_worker_env(repo_root=str(ROOT), extra_env={
        "HVD_TPU_SERVE_PORT": "0"})
    env.pop("HVD_TPU_SERVE_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.serve.replica"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CudaUnavailableError" in proc.stderr
    assert "HVD_TPU_SERVE_DEVICE=cpu" in proc.stderr


# ---------------------------------------------------------------------------
# E2E: real replica subprocesses under the port's elastic driver

def _replica_pid(middleman_pid, timeout=10):
    """The replica process the driver's middleman started (killing the
    replica, not the middleman, leaves no orphan serving on its port)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        kids = [p for p, pp in _ppid_map().items() if pp == middleman_pid]
        if kids:
            return kids[0]
        time.sleep(0.05)
    raise AssertionError("no replica under middleman %d" % middleman_pid)


class _Pool:
    """A real serve pool: the port's supervisor in-process, replica
    subprocesses on the CPU, ``max_np`` slots on localhost."""

    def __init__(self, replicas=2, max_np=None, ckpt_dir=None,
                 extra_env=None, **sup_kwargs):
        from tests.test_serve import _free_port_base
        max_np = max_np or replicas
        self.port_base = _free_port_base(max_np + 2)
        env = util.cpu_worker_env(repo_root=str(ROOT), extra_env=dict({
            "HVD_TPU_SERVE_DEVICE": "cpu",
            "HVD_TPU_SERVE_MODEL": "affine",
            "HVD_TPU_SERVE_DIM": str(DIM),
            "HVD_TPU_SERVE_PORT": str(self.port_base),
            "HVD_TPU_SERVE_SWAP_INTERVAL": "0.1",
            "HVD_TPU_SERVE_SWAP_STAGGER": "0.2",
        }, **(extra_env or {})))
        if ckpt_dir:
            env["HVD_TPU_CKPT_DIR"] = str(ckpt_dir)
        self.sup = ServeSupervisor(
            [sys.executable, "-m", "horovod_tpu_torch.serve.replica"],
            {"localhost": max_np}, min_replicas=1,
            max_replicas=max_np, np_initial=replicas,
            port_base=self.port_base, env=env, **sup_kwargs)
        self.rc = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            self.rc = self.sup.driver.run(install_signal_handlers=False)
        except Exception as e:  # surfaced by the test's join/assert
            self.rc = ("driver crashed", e)

    def wait_healthy(self, n, timeout=60):
        """Replicas import torch before they answer: a minute, not the
        reference's 30 s."""
        deadline = time.monotonic() + timeout
        up = 0
        while time.monotonic() < deadline:
            up = 0
            for ep in self.sup.endpoints():
                try:
                    with urllib.request.urlopen(
                            "http://%s/healthz" % ep, timeout=1) as r:
                        doc = json.loads(r.read())
                        if doc.get("ok") and doc.get("device") == "cpu":
                            up += 1
                except Exception:
                    pass
            if up >= n:
                return
            time.sleep(0.1)
        raise AssertionError("only %d/%d replicas healthy (rc=%r)"
                             % (up, n, self.rc))

    def drain(self, timeout=60):
        self.sup.driver.request_drain("all")
        self.thread.join(timeout=timeout)
        assert not self.thread.is_alive(), "driver did not finish drain"
        return self.rc

    def kill(self):
        if self.thread.is_alive():
            self.sup.driver.terminate()
            self.thread.join(timeout=15)


@pytest.mark.e2e
def test_e2e_rolling_swap_zero_dropped_new_weights_proven(tmp_path):
    old, new = _leaves(1), _leaves(2)
    crc_old, crc_new = (smodel.fingerprint(old), smodel.fingerprint(new))
    publish_leaves(str(tmp_path), 10, old)
    pool = _Pool(replicas=2, ckpt_dir=tmp_path)
    try:
        pool.wait_healthy(2)
        by_crc = {crc_old: old, crc_new: new}
        result_box = {}

        def load():
            result_box["r"], result_box["wall"] = run_load(
                pool.sup.endpoints, rate=40, duration=4.0, dim=DIM,
                seed=3, leaves_by_crc=by_crc, workers=4,
                total_deadline=10.0)

        t = threading.Thread(target=load)
        t.start()
        time.sleep(1.0)
        publish_leaves(str(tmp_path), 20, new)
        t.join(timeout=60)
        assert not t.is_alive()
        res = result_box["r"]
        assert res.errors == [], res.errors[:5]
        assert res.mismatches == [], res.mismatches[:5]
        assert res.ok == 160
        assert res.by_crc.get(crc_old, 0) > 0
        assert res.by_crc.get(crc_new, 0) > 0, res.by_crc
        for ep in pool.sup.endpoints():
            view = json.loads(urllib.request.urlopen(
                "http://%s/serve" % ep, timeout=5).read())
            assert view["model_step"] == 20
            assert view["swaps_total"] >= 1
            assert view["device"] == "cpu"
        rc = pool.drain()
        assert rc == EXIT_DRAINED
    finally:
        pool.kill()


@pytest.mark.e2e
def test_e2e_sigkill_replica_mid_request_no_hang_no_wrong_answer(
        tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_ELASTIC_COOLDOWN", "1")
    leaves = _leaves(4)
    crc = smodel.fingerprint(leaves)
    publish_leaves(str(tmp_path), 10, leaves)
    pool = _Pool(replicas=2, max_np=2, ckpt_dir=tmp_path)
    try:
        pool.wait_healthy(2)
        by_crc = {crc: leaves}
        result_box = {}

        def load():
            result_box["r"], _ = run_load(
                pool.sup.endpoints, rate=30, duration=4.0, dim=DIM,
                seed=5, leaves_by_crc=by_crc, workers=4,
                total_deadline=8.0)

        t = threading.Thread(target=load)
        t.start()
        time.sleep(1.0)
        victim = pool.sup.driver.live_workers()[0]
        os.kill(_replica_pid(pool.sup.driver.worker_pid(victim)),
                signal.SIGKILL)
        t.join(timeout=90)
        assert not t.is_alive(), "load generator hung after the kill"
        res = result_box["r"]
        assert res.mismatches == [], res.mismatches[:5]
        assert res.ok + len(res.errors) == 120
        assert res.ok >= 110, (res.ok, res.errors[:10])
        for rid, cause, msg in res.errors:
            assert cause in ("replica-lost", "draining", "overload",
                             "deadline"), (rid, cause, msg)
        pool.wait_healthy(2)
        assert victim not in pool.sup.driver.live_workers()
        rc = pool.drain()
        assert rc == EXIT_DRAINED
    finally:
        pool.kill()
