"""Worker of the port's negotiation-core tests (ROADMAP A8c1), run under
``python -m horovod_tpu_torch.run -np N``: the asynchronous API of
``horovod_tpu_torch`` on CPU tensors (and numpy arrays), through the
port's own build of the core. One mode a run (the first argument):

* ``ops``: the collective matrix of the reference's
  ``tests/distributed_ops_worker.py`` (every dtype, bfloat16 included,
  the average, bool, fusion, variable allgather, broadcast from every
  root, the mismatch and duplicate-name errors, the response cache's
  steady state); prints ``rank R: all distributed op tests passed``;
* ``single``: the one-process short circuit
  (``tests/single_proc_worker.py``); prints ``single-process OK``;
* ``fuzz``: ``tests/negotiation_fuzz_worker.py``'s out-of-order enqueue
  and synchronize (allreduce, allgather, broadcast, reduce-scatter);
  prints ``rank R: negotiation fuzz passed``;
* ``fusion``: ``tests/fusion_worker.py``'s 8 batches of 4 concurrent 1 KB
  allreduces; rank 0 prints ``FUSION_COUNTERS responses=.. tensors=..
  threshold=..``;
* ``bench``: ``tests/negotiation_bench_worker.py``'s zero-element
  allreduces (numpy only: imports no torch); rank 0 prints
  ``NEGOTIATION_US_PER_OP us``;
* ``order``: the core beside a ``torch.distributed`` group, started in
  either order (``HVD_CORE_FIRST=1``: the core first); prints ``rank R:
  core and process group OK``;
* ``smoke``: what ``chip_smoke.py``'s core phase checks (sums, gathers
  and broadcasts against numpy, bfloat16, an out-of-order enqueue, the
  fusion counters); prints ``CORE_SMOKE {json}``;
* ``device [cpu]``: the core's device op (ROADMAP A8c2) beside
  ``init()``'s group, on the GPU unless given ``cpu``. On the CPU the
  worker replaces ``async_ops.device_id``, the one function that maps a
  tensor to its request's device, so that CPU tensors are tagged as
  device 0: negotiation then takes the device op, and the executor of
  ``common/device_plane.py`` runs on a gloo group with the code that
  runs NCCL on the card (numpy arrays stay on the host plane). Sections,
  each printing ``rank R: device SECTION ok``: ``ops`` (the collective
  matrix above), ``fuzz`` (the out-of-order enqueue), ``mixed_device``,
  ``mixed_sharded`` (the raw collectives and the optimizers),
  ``mixed_compression``, ``groups`` (4 ranks: every kind in disjoint
  groups; 2 ranks: the rejections by name and the unregistered group),
  and ``fusion`` (the counters of 32 1 KB tensors with fusion off, by
  default, split by a 2 KB threshold, and unpaced), the last ones on
  restarts of the core with the knobs they need; then ``hvd.shutdown()``
  with a device handle outstanding (``rank R: device shutdown ok``);
* ``grads OUT_DIR [cpu]``: the small test LM's gradients (seeded weights,
  each rank's own tokens) through the negotiated route, on the device op
  as in ``device``: ``allreduce_gradients(negotiated=True)`` on a copy,
  the same without ``negotiated`` (``torch.distributed``), and
  ``DistributedOptimizer(negotiated=True)``'s hooks over a second
  backward, and over a third with the synchronous API on ``init()``'s
  group issued while the buckets run (``rank R: overlap ok``); writes
  ``OUT_DIR/{local,negotiated,direct,optimizer,overlap}_R.pt``.

Imports the port and numpy only (torch where a mode needs tensors).
"""

import ctypes
import json
import os
import random
import sys
import time

import numpy as np

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import async_ops, core
from horovod_tpu_torch.common.async_ops import shard_partition


def sync(handle):
    return hvd.synchronize(handle)


def _dev():
    """The device new tensors go to (the GPU in the device mode on one)."""
    import torch
    return torch.empty(0).device


def _host(out):
    """A result as a numpy array (a tensor is copied off its device)."""
    return out.cpu().numpy() if hasattr(out, "cpu") else out


def tolerance(dtype, n):
    if dtype == np.float16:
        return 1e-2 * n
    if dtype == np.float32:
        return 1e-5 * n
    if dtype == np.float64:
        return 1e-10 * n
    return 0


def test_allreduce_matrix(r, n):
    import torch
    rng = np.random.RandomState(1234)
    for dtype in (np.uint8, np.int8, np.int32, np.int64, np.float16,
                  np.float32, np.float64):
        for ndim in range(1, 4):
            shape = (5,) * ndim
            base = rng.uniform(-50, 50, size=shape)
            x = torch.as_tensor((base + r).astype(dtype), device=_dev())
            got = sync(hvd.allreduce_async(
                x, "ar.%s.%d" % (np.dtype(dtype).name, ndim)))
            assert isinstance(got, torch.Tensor) and got.dtype == x.dtype
            expected = np.zeros(shape, dtype=dtype)
            for rr in range(n):
                expected = expected + (base + rr).astype(dtype)
            expected = expected.astype(np.float64)
            tol = tolerance(dtype, n) * np.abs(expected).max() + 1e-6
            assert np.allclose(_host(got).astype(np.float64), expected,
                               atol=max(tol, 1e-6)), (dtype, ndim)
    # bfloat16 (no numpy dtype: only a tensor's data_ptr carries it), on
    # integers it holds exactly
    base = np.round(rng.uniform(-50, 50, size=(4, 6)))
    x = torch.as_tensor(base + r, device=_dev()).to(torch.bfloat16)
    got = sync(hvd.allreduce_async(x, "ar.bfloat16"))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_host(got.float()),
                          sum(base + rr for rr in range(n)))
    # a numpy array, as the reference takes
    got = sync(hvd.allreduce_async(np.arange(6, dtype=np.float32) * (r + 1),
                                   "ar.numpy"))
    assert isinstance(got, np.ndarray)
    assert np.allclose(got, np.arange(6) * sum(range(1, n + 1)))


def test_allreduce_average_and_scales(r, n):
    import torch
    x = torch.arange(20, dtype=torch.float32) + r
    got = sync(hvd.allreduce_async(x, "avg", postscale_factor=1.0 / n))
    assert torch.allclose(got, torch.arange(20.0) + (n - 1) / 2.0,
                          atol=1e-5), got
    got = sync(hvd.allreduce_async(torch.ones(3), "pre",
                                   prescale_factor=2.0,
                                   postscale_factor=0.5))
    assert torch.allclose(got, torch.full((3,), float(n))), got
    # out= aliasing the input: in place
    y = torch.full((4,), float(r + 1))
    assert sync(hvd.allreduce_async(y, "inplace", out=y)) is y
    assert torch.equal(y, torch.full((4,), float(n * (n + 1) // 2)))


def test_allreduce_bool(r, n):
    import torch
    got = sync(hvd.allreduce_async(torch.tensor([r == 0, True, False]),
                                   "bool"))
    assert got.dtype == torch.bool and got.tolist() == [True, True, False]


def test_fusion(r, n):
    import torch
    handles = [hvd.allreduce_async(torch.full((4,), float(i + r)),
                                   "fuse.%d" % i) for i in range(64)]
    for i, h in enumerate(handles):
        out = hvd.synchronize(h)
        assert torch.allclose(out, torch.full((4,), float(
            sum(i + rr for rr in range(n))))), (i, out)


def test_allgather_variable(r, n):
    import torch
    got = sync(hvd.allgather_async(torch.full((r + 2, 3), r,
                                              dtype=torch.int32), "ag_var"))
    assert got.shape == (sum(rr + 2 for rr in range(n)), 3)
    off = 0
    for rr in range(n):
        assert bool((got[off:off + rr + 2] == rr).all()), (rr, got)
        off += rr + 2


def test_allgather_dtypes_and_copy(r, n):
    import torch
    for dtype in (torch.uint8, torch.int64, torch.float16, torch.float64,
                  torch.bfloat16):
        got = sync(hvd.allgather_async(torch.full((2, 2), r, dtype=dtype),
                                       "ag.%s" % dtype))
        assert got.shape == (2 * n, 2) and got.dtype == dtype
        for rr in range(n):
            assert bool((got[2 * rr:2 * rr + 2].long() == rr).all())
    os.environ["HVD_TPU_ALLGATHER_COPY"] = "1"
    try:
        got = sync(hvd.allgather_async(torch.full((1,), float(r)),
                                       "ag.copy"))
    finally:
        del os.environ["HVD_TPU_ALLGATHER_COPY"]
    assert got.tolist() == [float(rr) for rr in range(n)]


def test_broadcast(r, n):
    import torch
    for root in range(n):
        for dtype in (torch.int32, torch.float32, torch.float64):
            x = torch.full((3, 3), r + 1, dtype=dtype)
            got = sync(hvd.broadcast_async(x, root, "bc.%d.%s"
                                           % (root, dtype)))
            assert bool((got == root + 1).all()), (root, got)


def test_reduce_scatter(r, n):
    import torch
    x = torch.arange(25, dtype=torch.float32) * (r + 1)
    got = sync(hvd.reduce_scatter_async(x, "rs"))
    counts, offsets = shard_partition(25, n)
    want = torch.arange(25.0)[offsets[r]:offsets[r] + counts[r]] * \
        sum(range(1, n + 1))
    assert got.shape == (counts[r],) and torch.equal(got, want)
    out = torch.empty(counts[r])
    assert sync(hvd.reduce_scatter_async(x, "rs.out", out=out)) is out
    assert torch.equal(out, want)
    try:
        hvd.reduce_scatter_async(x, "rs.bad", out=torch.empty(counts[r] + 1))
    except ValueError as e:
        assert "this rank's" in str(e)
    else:
        raise AssertionError("a reduce-scatter out of the wrong size")


def test_wire_compression(r, n):
    """The core's codec on each ring hop ('bf16', 'int8'; every rank the
    same): values the codecs carry exactly sum exactly, in float32."""
    import torch
    x = torch.full((300,), float(r + 1))
    for mode in ("bf16", "int8"):
        got = sync(hvd.allreduce_async(x, "wire.%s" % mode,
                                       compression=mode))
        assert got.dtype == torch.float32
        assert torch.equal(got, torch.full((300,), float(n * (n + 1) // 2)))


def _expect_error(fn, text):
    try:
        sync(fn())
    except hvd.HorovodInternalError as e:
        assert text in str(e), e
    else:
        raise AssertionError("expected an error naming %r" % text)


def test_error_mismatched_shape(r, n):
    import torch
    _expect_error(lambda: hvd.allreduce_async(torch.zeros(3 + r),
                                              "mismatch_shape"),
                  "Mismatched")


def test_error_mismatched_dtype(r, n):
    import torch
    _expect_error(lambda: hvd.allreduce_async(torch.zeros(
        4, dtype=torch.float32 if r == 0 else torch.float64),
        "mismatch_dtype"), "Mismatched")


def test_error_mismatched_root(r, n):
    import torch
    _expect_error(lambda: hvd.broadcast_async(torch.zeros(4), r % n,
                                              "mismatch_root"), "root")


def test_duplicate_name(r, n):
    import torch
    h1 = hvd.allreduce_async(torch.zeros(4), "dup")
    try:
        h2 = hvd.allreduce_async(torch.zeros(4), "dup")  # hvd-lint: disable=duplicate-collective-name
        try:
            hvd.synchronize(h2)
        except hvd.HorovodInternalError:
            pass
        else:
            raise AssertionError("expected duplicate-name error")
    finally:
        hvd.synchronize(h1)


def test_cache_steady_state(r, n):
    import torch
    for it in range(30):
        out = sync(hvd.allreduce_async(torch.full((8,), float(it * (r + 1))),
                                       "steady"))
        assert torch.allclose(out, torch.full((8,), float(
            it * sum(rr + 1 for rr in range(n))))), (it, out)


def test_poll_and_unknown_handle(r, n):
    import torch
    h = hvd.allreduce_async(torch.ones(2), "polled")
    deadline = time.monotonic() + 30
    while not hvd.poll(h):
        assert time.monotonic() < deadline
        time.sleep(0.001)
    assert torch.equal(hvd.synchronize(h), torch.full((2,), float(n)))
    try:
        hvd.synchronize(h)
    except ValueError as e:
        assert "unknown handle" in str(e)
    else:
        raise AssertionError("a synchronized handle is gone")


def mode_ops():
    c = core.init()
    r, n = c.rank(), c.size()
    assert n >= 2, "run under the launcher with -np >= 2"
    tests = [v for k, v in sorted(globals().items())
             if k.startswith("test_")]
    for t in tests:
        t(r, n)
        if r == 0:
            print("PASS %s" % t.__name__, flush=True)
    print("rank %d: all distributed op tests passed" % r, flush=True)


def mode_single():
    import torch
    c = core.init()
    assert (c.size(), c.rank(), c.local_rank(), c.cross_rank()) == \
        (1, 0, 0, 0)
    x = torch.arange(6, dtype=torch.float32)
    assert torch.equal(sync(hvd.allreduce_async(x, "x")), x)
    assert torch.equal(sync(hvd.allreduce_async(x, "xa",
                                                postscale_factor=1.0)), x)
    assert torch.equal(sync(hvd.allgather_async(x.reshape(2, 3), "g")),
                       x.reshape(2, 3))
    assert torch.equal(sync(hvd.broadcast_async(x, 0, "b")), x)
    assert torch.equal(sync(hvd.reduce_scatter_async(x, "single.rs")), x)
    print("single-process OK", flush=True)


def fuzz_round(r, n, num_tensors, seed, rnd, wrap=lambda a: a):
    """One round of the reference's fuzz: the same jobs, enqueued and
    synchronized in rank-shuffled orders; returns the jobs checked.
    ``wrap`` makes each input (numpy by default) the caller's kind."""
    kinds = ("allreduce", "allgather", "broadcast", "reduce_scatter")
    order = list(range(num_tensors))
    random.Random(seed + r + 101 * rnd).shuffle(order)
    handles = {}
    for idx in order:
        kind = kinds[idx % len(kinds)]
        name = "fuzz.%d.%d" % (rnd, idx)
        # the names are the round's and the job's, as in the reference's
        # fuzz, whose sites carry the same suppressions
        if kind == "allreduce":
            x = np.full((idx + 1, 3), float(r + 1), np.float32)
            h = hvd.allreduce_async(wrap(x), name)  # hvd-lint: disable=loop-auto-name
        elif kind == "reduce_scatter":
            x = np.full((idx + 1, 3), float(r + 1), np.float32)
            h = hvd.reduce_scatter_async(wrap(x), name)  # hvd-lint: disable=loop-auto-name
        elif kind == "allgather":
            x = np.full((r + 1, 2), float(idx * 1000 + r), np.float32)
            h = hvd.allgather_async(wrap(x), name)  # hvd-lint: disable=loop-auto-name
        else:
            x = np.full((2, idx + 1), float(r * 100 + idx), np.float32)
            h = hvd.broadcast_async(wrap(x), idx % n, name)  # hvd-lint: disable=loop-auto-name
        handles[idx] = (kind, h)
    sync_order = list(range(num_tensors))
    random.Random(seed * 3 + 7 + r + 101 * rnd).shuffle(sync_order)
    for idx in sync_order:
        kind, h = handles[idx]
        out = _host(hvd.synchronize(h))
        total = sum(rr + 1 for rr in range(n))
        if kind == "allreduce":
            assert out.shape == (idx + 1, 3) and np.allclose(out, total)
        elif kind == "reduce_scatter":
            counts, _ = shard_partition(
                (idx + 1) * 3, n)
            assert out.shape == (counts[r],) and np.allclose(out, total)
        elif kind == "allgather":
            want = np.concatenate([np.full((rr + 1, 2),
                                           float(idx * 1000 + rr),
                                           np.float32) for rr in range(n)])
            assert np.array_equal(out, want), (idx, out)
        else:
            assert out.shape == (2, idx + 1)
            assert np.allclose(out, float((idx % n) * 100 + idx))
    return len(handles)


def mode_fuzz():
    c = core.init()
    r, n = c.rank(), c.size()
    assert n >= 2
    num_tensors = int(os.environ.get("HVD_TPU_FUZZ_TENSORS", "40"))
    rounds = int(os.environ.get("HVD_TPU_FUZZ_ROUNDS", "1"))
    seed = int(os.environ.get("HVD_TPU_FUZZ_SEED", "1234"))
    for rnd in range(rounds):
        fuzz_round(r, n, num_tensors, seed, rnd)
    print("rank %d: negotiation fuzz passed" % r, flush=True)


def mode_fusion():
    import torch
    c = core.init()
    size, r = c.size(), c.rank()
    base = torch.arange(256, dtype=torch.float32)  # 1 KB
    for i in range(8):
        handles = [hvd.allreduce_async(base + float(r), "fuse.%d" % j)
                   for j in range(4)]
        for h in handles:
            out = hvd.synchronize(h)
            if not torch.allclose(out, base * size + sum(range(size))):
                print("MISMATCH batch %d" % i, flush=True)
                return 1
    if r == 0:
        responses, tensors = c.perf_counters()
        print("FUSION_COUNTERS responses=%d tensors=%d threshold=%d" % (
            responses, tensors, c.effective_fusion_threshold()), flush=True)
    print("rank %d done" % r, flush=True)
    return 0


def mode_bench():
    c = core.init()
    r = c.rank()
    x = np.zeros(0, dtype=np.float32)
    iters = int(os.environ.get("HVD_TPU_BENCH_ITERS", "200"))
    k = int(os.environ.get("HVD_TPU_BENCH_TENSORS", "1"))
    names = (["nb.layer%03d.weight_gradient_accumulator" % i
              for i in range(k)] if k > 1 else ["nb"])

    def step():
        for h in [hvd.allreduce_async(x, nm) for nm in names]:
            hvd.synchronize(h)

    for _ in range(int(os.environ.get("HVD_TPU_BENCH_WARMUP", "20"))):
        step()
    c.protocol_counters_reset()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    dt = time.perf_counter() - t0
    if r <= 1:
        counters = c.protocol_counters()
        counters.update(rank=r, iters=iters, tensors_per_step=k)
        print("PROTOCOL_COUNTERS %s" % json.dumps(counters), flush=True)
    if r == 0:
        print("NEGOTIATION_US_PER_OP %.1f" % (dt / (iters * k) * 1e6),
              flush=True)
    assert "torch" not in sys.modules, "the bench worker loaded torch"
    print("rank %d done" % r, flush=True)


def mode_order():
    import torch
    import torch.distributed as dist
    core_first = os.environ.get("HVD_CORE_FIRST") == "1"
    if core_first:
        core.init()
        hvd.init(device="cpu")
    else:
        hvd.init(device="cpu")
        core.init()
    c = core.get_core()
    r, n = hvd.rank(), hvd.size()
    assert (c.rank(), c.size()) == (r, n)
    x = torch.full((5,), float(r + 1))
    want = torch.full((5,), float(n * (n + 1) // 2))
    assert torch.equal(sync(hvd.allreduce_async(x, "order.core")), want)
    assert torch.equal(hvd.allreduce(x, average=False), want)
    dist.barrier()
    print("rank %d: core and process group OK (%s first)"
          % (r, "core" if core_first else "group"), flush=True)
    hvd.shutdown()


def mode_smoke():
    """The chip_smoke core phase's worker: CPU tensors only (one H100
    holds one NCCL rank)."""
    import torch
    t0 = time.perf_counter()
    c = core.init()
    start_s = time.perf_counter() - t0
    r, n = c.rank(), c.size()
    rng = np.random.RandomState(7)
    checks = {}
    base = [rng.standard_normal((1000, 33)).astype(np.float32)
            for _ in range(n)]
    got = sync(hvd.allreduce_async(torch.from_numpy(base[r]), "sm.sum"))
    checks["allreduce_f32_max_err"] = float(np.abs(
        got.numpy() - np.sum(base, axis=0)).max())
    ints = [rng.randint(-100, 100, (64, 7)) for _ in range(n)]
    got = sync(hvd.allreduce_async(torch.from_numpy(ints[r]), "sm.int"))
    checks["allreduce_int64_equal"] = bool(np.array_equal(
        got.numpy(), np.sum(ints, axis=0)))
    got = sync(hvd.allreduce_async(
        torch.from_numpy(ints[r].astype(np.float32)).to(torch.bfloat16),
        "sm.bf16"))
    checks["allreduce_bf16_equal"] = bool(np.array_equal(
        got.float().numpy(), np.sum(ints, axis=0).astype(np.float32)))
    rows = [rng.standard_normal((3 + rr, 5)).astype(np.float32)
            for rr in range(n)]
    got = sync(hvd.allgather_async(torch.from_numpy(rows[r]), "sm.gather"))
    checks["allgather_equal"] = bool(np.array_equal(got.numpy(),
                                                    np.concatenate(rows)))
    got = sync(hvd.broadcast_async(torch.from_numpy(base[r]), n - 1,
                                   "sm.bcast"))
    checks["broadcast_equal"] = bool(np.array_equal(got.numpy(),
                                                    base[n - 1]))
    flat = np.concatenate([b.ravel() for b in base[:1]])
    got = sync(hvd.reduce_scatter_async(torch.from_numpy(flat * (r + 1)),
                                        "sm.rs"))
    counts, offsets = shard_partition(flat.size, n)
    want = (flat * sum(range(1, n + 1)))[offsets[r]:offsets[r] + counts[r]]
    checks["reduce_scatter_max_err"] = float(np.abs(got.numpy() -
                                                    want).max())
    checks["out_of_order_jobs"] = fuzz_round(r, n, 24, 99, 0)
    # 16 small allreduces enqueued together: fewer responses than tensors
    responses0, tensors0 = c.perf_counters()
    handles = [hvd.allreduce_async(torch.full((256,), float(i + r)),
                                   "sm.fuse.%d" % i) for i in range(16)]
    fused_ok = all(torch.equal(hvd.synchronize(h), torch.full(
        (256,), float(n * i + n * (n - 1) // 2)))
        for i, h in enumerate(handles))
    responses1, tensors1 = c.perf_counters()
    checks["fusion_equal"] = bool(fused_ok)
    checks["fusion_tensors"] = tensors1 - tensors0
    checks["fusion_responses"] = responses1 - responses0
    checks["seconds"] = time.perf_counter() - t0
    checks["core_start_s"] = start_s
    checks["rank"], checks["size"] = r, n
    print("CORE_SMOKE %s" % json.dumps(checks), flush=True)


# ------------------------------------------------ the device op (A8c2)


def tag_cpu_tensors_as_device():
    """Requests of CPU tensors carry device 0: the CPU tests' way onto the
    core's device op (numpy arrays stay on the host plane)."""
    import torch
    host = async_ops.device_id

    def tagged(value, what):
        if isinstance(value, torch.Tensor) and value.device.type == "cpu":
            return 0
        return host(value, what)

    async_ops.device_id = tagged


def restart_core(env):
    """Stops the core and starts it again with ``env`` (knobs read at the
    start), on every rank; the device plane's executor restarts with it
    and the groups are registered again."""
    core.shutdown()
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return core.init()


def _raises(fn, *texts, kind=None):
    kind = kind or hvd.HorovodInternalError
    try:
        fn()
    except kind as e:
        for t in texts:
            assert t in str(e), (t, str(e))
        return str(e)
    raise AssertionError("expected %s naming %r" % (kind.__name__, texts))


def _both_ranks(msg, n):
    """The message names rank 0 and another rank."""
    assert "rank 0" in msg, msg
    assert any("rank %d" % rr in msg for rr in range(1, n)), msg


def device_ops(r, n):
    for k, v in sorted(globals().items()):
        if k.startswith("test_"):
            v(r, n)


def device_fuzz(r, n):
    import torch
    assert fuzz_round(r, n, 24, 1234, 0, wrap=lambda a: torch.as_tensor(
        a, device=_dev())) == 24


def device_mixed_device(r, n):
    """One rank's tensor on the host, the others' on the device: rejected
    on every rank naming both ranks and both devices, within 30 s."""
    import torch
    t0 = time.monotonic()
    x = torch.ones(5)
    msg = _raises(lambda: sync(hvd.allreduce_async(
        _host(x) if r == 0 else x, "mixed.device")),
        "Mismatched devices", "the host", "GPU ")
    _both_ranks(msg, n)
    assert time.monotonic() - t0 < 30, time.monotonic() - t0
    # per tensor, not fatal
    assert torch.equal(sync(hvd.allreduce_async(x, "mixed.device.after")),
                       torch.full((5,), float(n)))


def _assert_mixed_modes(msg, n):
    assert "Mixed execution modes" in msg, msg
    assert "sharded_update" in msg and "reduce-scatter" in msg, msg
    assert "allreduce" in msg, msg
    _both_ranks(msg, n)


def device_mixed_sharded(r, n):
    """``tests/sharded_mixed_worker.py``: rank 0 sharded, the others
    replicated, on one name: at the raw level and the optimizer level."""
    import torch
    x = torch.ones(100)
    if r == 0:
        msg = _raises(lambda: sync(hvd.reduce_scatter_async(x, "mixed")))  # hvd-lint: disable=rank-conditional-collective,verify-kind-mismatch
    else:
        msg = _raises(lambda: sync(hvd.allreduce_async(x, "mixed")))  # hvd-lint: disable=rank-conditional-collective,name-attr-mismatch
    _assert_mixed_modes(msg, n)
    # a sharded optimizer meeting replicated ones on "grad.0"
    w = torch.nn.Parameter(torch.ones(10))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),  # hvd-lint: disable=missing-initial-broadcast
                                   sharded_update=(r == 0), negotiated=True)
    w.grad = torch.full((10,), float(r + 1))
    _assert_mixed_modes(_raises(opt.step), n)
    assert torch.equal(sync(hvd.allreduce_async(x, "uniform")),
                       torch.full((100,), float(n)))


def device_mixed_compression(r, n):
    """``tests/compression_mixed_worker.py``: bf16 on rank 0, int8 on the
    others: rejected naming both modes; a uniform int8 op completes."""
    import torch
    x = torch.ones(100)
    msg = _raises(lambda: sync(hvd.allreduce_async(
        x, "mixed.comp", compression="bf16" if r == 0 else "int8")),
        "Mismatched compression modes", "bf16", "int8")
    _both_ranks(msg, n)
    out = sync(hvd.allreduce_async(x, "uniform.comp", compression="int8"))
    assert torch.allclose(out, torch.full((100,), float(n)), atol=0.1), out


def device_groups(r, n):
    """``tests/group_worker.py`` on the asynchronous API: at 4 ranks every
    kind in the disjoint groups {0, 2} and {1, 3} on the same names, and
    a whole-world group; at 2 ranks the rejections by name, then a group
    the coordinator never registered (after a restart of the core with a
    2 s divergence grace)."""
    import json
    import torch
    import torch.distributed as dist
    if n == 4:
        g_even, g_odd = hvd.new_group([0, 2]), hvd.new_group([1, 3])
        g_all = hvd.new_group(range(n))
        assert [g.core_id for g in (g_even, g_odd, g_all)] == \
            [g.id for g in (g_even, g_odd, g_all)]
        mine = g_even if r % 2 == 0 else g_odd
        members = list(mine.ranks)
        out = sync(hvd.allreduce_async(torch.full((7,), float(r + 1)),
                                       "grad.0", group=mine))
        assert torch.allclose(out, torch.full((7,), float(sum(
            m + 1 for m in members)))), (r, out)
        root = members[1]
        out = sync(hvd.broadcast_async(torch.full((3,), float(r)), root,
                                       "bc.0", group=mine))
        assert bool((out == root).all()), (r, out)
        out = sync(hvd.allgather_async(torch.full((r + 1, 2), float(r)),
                                       "ag.0", group=mine))
        want = torch.cat([torch.full((m + 1, 2), float(m))
                          for m in members])
        assert torch.equal(out, want), (r, out)
        t = torch.arange(10, dtype=torch.float32) + r
        out = sync(hvd.reduce_scatter_async(t, "rs.0", group=mine))
        counts, offsets = shard_partition(10, 2)
        gr = mine.rank()
        full = sum(torch.arange(10, dtype=torch.float32) + m
                   for m in members)
        assert torch.equal(out, full[offsets[gr]:offsets[gr] + counts[gr]])
        out = sync(hvd.allreduce_async(torch.full((4,), float(r)), "avg.0",
                                       postscale_factor=0.5, group=mine))
        assert torch.allclose(out, torch.full((4,), sum(members) / 2.0))
        out = sync(hvd.allreduce_async(torch.ones(5), "world.0",
                                       group=g_all))
        assert torch.equal(out, torch.full((5,), float(n)))
        m = json.loads(core.get_core().metrics_json())
        assert m["gauges"]["groups"] == 3, m["gauges"]
        assert m["counters"]["group_tensors_total"] >= 6, m["counters"]
        return
    assert n == 2
    g0 = hvd.new_group([0])
    if r == 1:
        # the port's rule: a non-member raises before it enqueues
        _raises(lambda: hvd.allreduce_async(torch.ones(3), "nm.0",
                                            group=g0),
                "not a member", kind=ValueError)
    _raises(lambda: sync(hvd.allreduce_async(torch.ones(3), "ug.0",
                                             group=999)),
            "unknown process group")
    g2 = hvd.new_group([r])  # the same id, another member list a rank
    # Rank 1 announces first and is rejected by name: announced together,
    # rank 0's own submission may complete alone first, and the core then
    # runs that response on rank 1 too, whose table makes it a member
    # (ROADMAP queue C). Then rank 0's completes alone.
    if r == 1:
        _raises(lambda: sync(hvd.allreduce_async(torch.ones(3), "mm.0",
                                                 group=g2)),
                "Mixed membership")
    dist.barrier()
    if r == 0:
        out = sync(hvd.allreduce_async(torch.ones(3), "mm.0", group=g2))  # hvd-lint: disable=duplicate-collective-name
        assert torch.equal(out, torch.ones(3)), out
    # the core stops on every rank at once: rank 0's "mm.0" first
    dist.barrier()
    if r == 1:
        # rank 1 alone registers a group in the core (a new_group that
        # rank 0 skipped): past the grace window it errors by name
        restart_core({"HVD_TPU_DIVERGENCE_GRACE_SECONDS": "2"})
        c = core.get_core()
        gid = c.lib.horovod_tpu_new_group((ctypes.c_int32 * 1)(1), 1)
        _raises(lambda: sync(hvd.allreduce_async(torch.ones(4),
                                                 "ur.0", group=gid)),
                "never registered that group")
    else:
        restart_core({"HVD_TPU_DIVERGENCE_GRACE_SECONDS": "2"})
    dist.barrier()


def device_fusion(r, n):
    """``tests/test_fusion_knobs.py``'s counters through the device op: 8
    batches of 4 concurrent 1 KB allreduces at a 50 ms cycle, the core
    restarted for each knob (its counters start at 0)."""
    import torch
    base = torch.arange(256, dtype=torch.float32)
    found = {}
    for label, env in (
            ("off", {"HVD_TPU_FUSION_THRESHOLD": "0"}),
            ("default", {"HVD_TPU_FUSION_THRESHOLD": None}),
            ("split", {"HVD_TPU_FUSION_THRESHOLD": "2048"}),
            ("unpaced", {"HVD_TPU_FUSION_THRESHOLD": None,
                         "HVD_TPU_CYCLE_TIME": "0"})):
        env.setdefault("HVD_TPU_CYCLE_TIME", "50")
        c = restart_core(env)
        for i in range(8):
            handles = [hvd.allreduce_async(base + float(r), "fuse.%d" % j)
                       for j in range(4)]
            for h in handles:
                assert torch.allclose(hvd.synchronize(h),
                                      base * n + sum(range(n))), (label, i)
        found[label] = c.perf_counters() + (c.effective_fusion_threshold(),)
    if r == 0:
        print("DEVICE_FUSION %s" % json.dumps(found), flush=True)
    restart_core({"HVD_TPU_FUSION_THRESHOLD": None,
                  "HVD_TPU_CYCLE_TIME": None})


def device_shutdown(r, n):
    """``hvd.shutdown()`` with a device handle outstanding (a name that no
    other rank enqueues): the core stops before the executor, fails the
    handle, and its synchronize raises within 30 s instead of waiting on
    a response that nothing would take."""
    import torch
    handle = hvd.allreduce_async(torch.ones(3), "orphan.%d" % r)  # hvd-lint: disable=rank-dependent-name
    t0 = time.monotonic()
    hvd.shutdown()
    assert not core.is_initialized()
    _raises(lambda: sync(handle))
    assert time.monotonic() - t0 < 30, time.monotonic() - t0


DEVICE_SECTIONS = (("ops", device_ops), ("fuzz", device_fuzz),
                   ("mixed_device", device_mixed_device),
                   ("mixed_sharded", device_mixed_sharded),
                   ("mixed_compression", device_mixed_compression),
                   ("fusion", device_fusion), ("groups", device_groups))


def mode_device(device=None):
    """The device op's sections (module docstring), on ``init()``'s
    group: NCCL on the GPU by default (one GPU a rank; the sections'
    tensors are made there), gloo for ``cpu``."""
    import torch
    hvd.init(device=device)
    if hvd.device().type == "cpu":
        tag_cpu_tensors_as_device()
    else:  # the sections' tensors are made on this rank's GPU
        torch.set_default_device(hvd.device())
    c = core.init()
    r, n = c.rank(), c.size()
    assert (r, n) == (hvd.rank(), hvd.size()) and n >= 2
    for name, fn in DEVICE_SECTIONS:
        fn(r, n)
        print("rank %d: device %s ok" % (r, name), flush=True)
    device_shutdown(r, n)
    print("rank %d: device shutdown ok" % r, flush=True)


# the test LM of tests/test_torch_port_transformer.py
SMALL_LM = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64,
                mlp_dim=256, max_seq_len=256)


def mode_grads(out_dir, device=None):
    """The negotiated gradient route on the small LM (module docstring)."""
    import torch
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.parallel import lm_loss
    hvd.init(device=device)
    dev = hvd.device()
    if dev.type == "cpu":
        tag_cpu_tensors_as_device()
    r = hvd.rank()
    model = Transformer(TransformerConfig(**SMALL_LM), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, SMALL_LM["vocab_size"], (4, 32), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               100 + r))
    params = dict(model.named_parameters())
    lm_loss(model, tokens).backward()
    local = {k: p.grad.detach().clone() for k, p in params.items()}

    def reduced(**kw):
        for k, p in params.items():
            p.grad = local[k].clone()
        hvd.allreduce_gradients(params.values(), **kw)
        return {k: p.grad.detach().clone() for k, p in params.items()}

    found = {"local": local, "negotiated": reduced(negotiated=True),
             "direct": reduced()}
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters()),
                                   model.named_parameters(),
                                   negotiated=True)
    opt.zero_grad()
    lm_loss(model, tokens).backward()
    opt.synchronize()
    assert opt.launch_order == list(range(len(opt.buckets)))
    found["optimizer"] = {k: p.grad.detach().clone()
                          for k, p in params.items()}
    found["overlap"] = overlapped_backward(model, tokens, opt, params)
    for kind, grads in found.items():
        torch.save({k: v.cpu() for k, v in grads.items()},
                   os.path.join(out_dir, "%s_%d.pt" % (kind, r)))
    print("rank %d: grads written" % r, flush=True)
    core.shutdown()
    hvd.shutdown()


def overlapped_backward(model, tokens, opt, params):
    """The negotiated backward again, with the synchronous API on
    ``init()``'s group issued from the main thread while the buckets run
    on the executor's group: an ``allreduce`` from a gradient hook in the
    middle of the backward, then ``broadcast_parameters`` and another
    ``allreduce`` before ``synchronize``. Each must hold, and the
    gradients must be the optimizer's; returns them."""
    import torch
    from horovod_tpu_torch.parallel import lm_loss
    r, n = hvd.rank(), hvd.size()
    probe = torch.full((1024,), float(r + 1), device=hvd.device())
    want = torch.full((1024,), float(n * (n + 1) // 2))
    sums = []
    first = next(iter(params.values()))
    hook = first.register_post_accumulate_grad_hook(
        lambda p: sums.append(hvd.allreduce(probe, average=False)))
    opt.zero_grad()
    lm_loss(model, tokens).backward()
    hook.remove()
    before = {k: p.detach().clone() for k, p in params.items()}
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    sums.append(hvd.allreduce(probe, average=False))
    opt.synchronize()
    assert len(sums) == 2 and all(torch.equal(s.cpu(), want) for s in sums)
    assert all(torch.equal(p, before[k]) for k, p in params.items())
    print("rank %d: overlap ok" % r, flush=True)
    return {k: p.grad.detach().clone() for k, p in params.items()}


MODES = {"ops": mode_ops, "single": mode_single, "fuzz": mode_fuzz,
         "fusion": mode_fusion, "bench": mode_bench, "order": mode_order,
         "smoke": mode_smoke, "device": mode_device, "grads": mode_grads}


if __name__ == "__main__":
    sys.exit(MODES[sys.argv[1]](*sys.argv[2:]) or 0)
