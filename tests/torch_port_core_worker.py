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
  fusion counters); prints ``CORE_SMOKE {json}``.

Imports the port and numpy only (torch where a mode needs tensors).
"""

import json
import os
import random
import sys
import time

import numpy as np

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import core
from horovod_tpu_torch.common.async_ops import shard_partition


def sync(handle):
    return hvd.synchronize(handle)


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
            x = torch.from_numpy((base + r).astype(dtype))
            got = sync(hvd.allreduce_async(
                x, "ar.%s.%d" % (np.dtype(dtype).name, ndim)))
            assert isinstance(got, torch.Tensor) and got.dtype == x.dtype
            expected = np.zeros(shape, dtype=dtype)
            for rr in range(n):
                expected = expected + (base + rr).astype(dtype)
            expected = expected.astype(np.float64)
            tol = tolerance(dtype, n) * np.abs(expected).max() + 1e-6
            assert np.allclose(got.numpy().astype(np.float64), expected,
                               atol=max(tol, 1e-6)), (dtype, ndim)
    # bfloat16 (no numpy dtype: only a tensor's data_ptr carries it), on
    # integers it holds exactly
    base = np.round(rng.uniform(-50, 50, size=(4, 6)))
    x = torch.from_numpy(base + r).to(torch.bfloat16)
    got = sync(hvd.allreduce_async(x, "ar.bfloat16"))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
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


def fuzz_round(r, n, num_tensors, seed, rnd):
    """One round of the reference's fuzz: the same jobs, enqueued and
    synchronized in rank-shuffled orders; returns the jobs checked."""
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
            h = hvd.allreduce_async(x, name)  # hvd-lint: disable=loop-auto-name
        elif kind == "reduce_scatter":
            x = np.full((idx + 1, 3), float(r + 1), np.float32)
            h = hvd.reduce_scatter_async(x, name)  # hvd-lint: disable=loop-auto-name
        elif kind == "allgather":
            x = np.full((r + 1, 2), float(idx * 1000 + r), np.float32)
            h = hvd.allgather_async(x, name)  # hvd-lint: disable=loop-auto-name
        else:
            x = np.full((2, idx + 1), float(r * 100 + idx), np.float32)
            h = hvd.broadcast_async(x, idx % n, name)  # hvd-lint: disable=loop-auto-name
        handles[idx] = (kind, h)
    sync_order = list(range(num_tensors))
    random.Random(seed * 3 + 7 + r + 101 * rnd).shuffle(sync_order)
    for idx in sync_order:
        kind, h = handles[idx]
        out = hvd.synchronize(h)
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


MODES = {"ops": mode_ops, "single": mode_single, "fuzz": mode_fuzz,
         "fusion": mode_fusion, "bench": mode_bench, "order": mode_order,
         "smoke": mode_smoke}


if __name__ == "__main__":
    sys.exit(MODES[sys.argv[1]]() or 0)
