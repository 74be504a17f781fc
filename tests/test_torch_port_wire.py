"""The port's wire compression against the JAX package's.

- The codec's plain versions (``ops/wire_codec.py``: ``quantize_int8_ref``,
  ``dequantize_int8_ref`` and the decode-add, the bf16 cast) against
  ``quantize_int8_jax``, ``dequantize_int8_jax`` and the numpy
  ``quantize_int8`` and ``bf16_roundtrip`` on the reference's cases
  (random blocks, constants, zeros, non-finite blocks, the symmetric
  range): equal, q and scales, NaN where NaN; and the port's copies of the
  numpy quantizers equal to the reference's.
- One module fixture spawns 4 gloo ranks once
  (tests/torch_port_wire_worker.py): ``ring_allreduce``,
  ``ring_reduce_scatter``, ``ring_allgather`` and scatter-then-gather in
  modes none, bf16 and int8 against the JAX rings under ``shard_map`` on 4
  CPU devices. The schedule is the reference's, so the sums are added in
  the same order: none and bf16 are equal, int8 within a few f32 ulps
  (``_matches_jax``); every rank's allreduce is identical; int32 rides
  mode none and sums exactly. Every payload a rank sent equals, hop for
  hop, what the reference's hop codec (``_ring_codec``) sends when run
  eagerly on the reference's schedule over 4 virtual ranks, and so do the
  results.
- ``allreduce`` and ``reduce_scatter`` with a wire mode against
  ``hvd_jax.allreduce`` and ``reduce_scatter`` in-jit, and the replicated
  ``DistributedOptimizer`` under the int8 wire against its bucket summed
  by ``ring_allreduce`` by hand.

The worker's own timeout (240 s) keeps a hung rank from eating the
suite's limit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu.jax as hvd_jax
import horovod_tpu_torch as hvd
import torch_port_api_worker
import torch_port_wire_worker as worker
from horovod_tpu import compression as comp
from horovod_tpu.parallel.ring import (_ring_codec, ring_allgather,
                                       ring_allreduce, ring_reduce_scatter)
from horovod_tpu_torch import compression as port_comp
from horovod_tpu_torch.ops import wire_codec as wc

# tests/test_compression.py:138: the ring's sum against the f32 sum, of
# max |sum|; none differs by the f32 sum order only
SUM_TOL = {"none": 1e-5, "bf16": 2e-2, "int8": 4e-2}
# the plain mean of the collectives against JAX's psum: the same f32 values
# added in another order
F32_TOL = 1e-6


# int8 against the jitted JAX ring, of max |want|: XLA fuses the ring's
# decode-add into an FMA inside the jitted loop (one rounding where the
# port's, and the kernel's, __fadd_rn(acc, __fmul_rn(q, s)) has two), so
# an element can land a few f32 ulps apart (at most 3.8e-6 seen)
INT8_F32_TOL = 1e-5


def _matches_jax(got, want, mode):
    """none and bf16: equal. int8: within INT8_F32_TOL of max |want|."""
    if mode != "int8":
        return np.array_equal(got, want)
    return np.abs(got - want).max() <= INT8_F32_TOL * np.abs(want).max()


def _codec_cases():
    """name -> f32 array of whole 256-blocks, the reference's cases
    (tests/test_compression.py:19-72)."""
    rng = np.random.RandomState(256)
    cases = {"random_%g" % mag: (rng.randn(256 * 12) * mag).astype(np.float32)
             for mag in (1e-4, 1.0, 1e4)}
    for c in (1.0, -3.5, 0.0):
        cases["constant_%g" % c] = np.full(1024, c, np.float32)
    x = np.ones(768, np.float32)
    x[300] = np.nan
    x[10] = np.inf
    x[600] = -np.inf
    cases["nonfinite"] = x
    cases["symmetric_range"] = np.linspace(-1000, 1000, 4096).astype(
        np.float32)
    cases["huge"] = (np.clip(rng.randn(512), -3, 3) * 1e38).astype(
        np.float32)
    cases["half_steps"] = ((np.arange(1024) % 9 - 4) * 0.5).astype(
        np.float32)
    return cases


CODEC_CASES = _codec_cases()


def _same(a, b):
    """Equal arrays, NaN where NaN."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and bool(np.all(
        (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == "f"
        else a == b))


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_quantize_matches_jax_and_numpy(case):
    x = CODEC_CASES[case]
    q, s = wc.quantize_int8_ref(torch.from_numpy(x))
    qj, sj = comp.quantize_int8_jax(jnp.asarray(x))
    qn, sn = comp.quantize_int8(x)
    assert _same(q.numpy(), np.asarray(qj).reshape(-1)), case
    assert _same(s.numpy(), np.asarray(sj)), case
    assert _same(q.numpy(), qn) and _same(s.numpy(), sn), case
    # the port's copy of the numpy quantizer, on whole and on short blocks
    for arr in (x, x[:-100]):
        (qp, sp), (qr, sr) = port_comp.quantize_int8(arr), \
            comp.quantize_int8(arr)
        assert _same(qp, qr) and _same(sp, sr), case
        assert _same(port_comp.dequantize_int8(qp, sp),
                     comp.dequantize_int8(qr, sr)), case
    assert q.min() >= -127 and q.max() <= 127
    # the wrapper on a CPU tensor is the plain version
    qw, sw = wc.wire_encode(torch.from_numpy(x), "int8")
    assert torch.equal(qw, q) and _same(sw.numpy(), s.numpy())


def test_denormal_blocks_keep_their_denormals():
    """A block of denormals quantizes as numpy's quantize_int8 does (the
    kernel's IEEE operations keep denormals too); XLA's CPU backend flushes
    them to zero, so quantize_int8_jax gives q = 0 there."""
    x = (np.random.RandomState(9).randn(512) * 1e-40).astype(np.float32)
    q, s = wc.quantize_int8_ref(torch.from_numpy(x))
    qn, sn = comp.quantize_int8(x)
    assert _same(q.numpy(), qn) and _same(s.numpy(), sn)
    assert np.abs(qn).max() == 127


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_decode_add_matches_jax(case):
    """The decode-add of rs_body: acc + dequantize_int8_jax(q, scales),
    and the decode alone into an empty destination."""
    x = CODEC_CASES[case]
    qj, sj = comp.quantize_int8_jax(jnp.asarray(x))
    acc = np.random.RandomState(3).randn(x.size).astype(np.float32)
    want = np.asarray(jnp.asarray(acc) + comp.dequantize_int8_jax(qj, sj))
    payload = (torch.from_numpy(np.asarray(qj).reshape(-1).copy()),
               torch.from_numpy(np.asarray(sj).copy()))
    got = wc.wire_decode_add(torch.from_numpy(acc.copy()), payload, "int8")
    assert _same(got.numpy(), want), case
    dec = wc.wire_decode_add(torch.zeros(x.size), payload, "int8", add=False)
    assert _same(dec.numpy(), np.asarray(comp.dequantize_int8_jax(qj, sj)))
    assert _same(wc.dequantize_int8_ref(*payload).numpy(), dec.numpy())


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_bf16_matches_the_roundtrip(case):
    x = CODEC_CASES[case]
    (b,) = wc.wire_encode(torch.from_numpy(x), "bf16")
    assert b.dtype == torch.bfloat16
    assert _same(b.float().numpy(), comp.bf16_roundtrip(x)), case
    assert _same(port_comp.bf16_roundtrip(x), comp.bf16_roundtrip(x)), case
    acc = np.random.RandomState(4).randn(x.size).astype(np.float32)
    got = wc.wire_decode_add(torch.from_numpy(acc.copy()), (b,), "bf16")
    assert _same(got.numpy(), acc + comp.bf16_roundtrip(x))


def test_codec_wrappers_refuse_what_the_kernels_do_not_take():
    before = wc.launch_counts()
    with pytest.raises(ValueError, match="multiple of 256"):
        wc.wire_encode(torch.zeros(300), "int8")
    with pytest.raises(ValueError, match="none"):
        wc.wire_encode(torch.zeros(256), "none")
    with pytest.raises(ValueError, match="float32"):
        wc.wire_encode(torch.zeros(256, dtype=torch.float64), "bf16")
    with pytest.raises(ValueError, match="payload has 2"):
        wc.wire_decode_add(torch.zeros(256), (torch.zeros(256),), "int8")
    with pytest.raises(ValueError, match="unknown compression"):
        wc.wire_encode(torch.zeros(256), "int4")
    assert wc.launch_counts() == before == {"wire_encode": 0,
                                            "wire_decode_add": 0}


def test_wire_modes_resolve_as_the_reference():
    for spec, name in ((None, "none"), ("bf16", "bf16"), ("INT8", "int8"),
                       (2, "int8"), (port_comp.Compression.wire_bf16,
                                     "bf16")):
        assert port_comp.resolve(spec).name == comp.resolve(spec).name
    for count in (0, 1, 255, 256, 257, 1000, 1 << 20):
        for mode in ("none", "bf16", "int8"):
            assert port_comp.wire_bytes(count, mode) == \
                comp.wire_bytes(count, mode)
    assert port_comp.codec("int8") is port_comp.Compression.none
    assert port_comp.wire_mode(port_comp.Compression.fp16) == "none"
    with pytest.raises(TypeError, match="legacy codec"):
        port_comp.resolve(port_comp.Compression.fp16)
    with pytest.raises(ValueError, match="legacy codec"):
        port_comp.resolve_wire_arg(port_comp.Compression.bf16)
    assert port_comp.resolve_wire_arg(port_comp.Compression.none) == "none"


def test_env_default_selects_the_wire_mode(monkeypatch):
    monkeypatch.setenv("HVD_TPU_COMPRESSION", "int8")
    assert port_comp.wire_mode(None) == "int8"
    assert port_comp.resolve_wire_arg(port_comp.Compression.none) == "int8"
    assert port_comp.wire_mode("none") == "none"
    monkeypatch.setenv("HVD_TPU_COMPRESSION", "int4")  # a typo: none
    assert port_comp.wire_mode(None) == "none"


# ------------------------------------------------------ 4 gloo ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.spawn_wire(tmp_path_factory.mktemp("wire"))


def _jax_rings(fn, x):
    """``fn`` on each of 4 CPU devices' slice of x ([4, ...]) under
    shard_map; returns [4, ...]."""
    mesh = Mesh(np.array(jax.devices("cpu")[:worker.WORLD]), ("hvd",))
    return np.asarray(jax.jit(jax.shard_map(
        lambda a: fn(a[0])[None], mesh=mesh, in_specs=P("hvd"),
        out_specs=P("hvd"), check_vma=False))(jnp.asarray(x)))


def _stack(fn, *args):
    return np.stack([fn(r, *args) for r in range(worker.WORLD)])


@pytest.mark.parametrize("mode", worker.MODES)
def test_ring_allreduce_matches_the_jax_ring(ranks, mode):
    x = _stack(worker.allreduce_input)
    want = _jax_rings(lambda a: ring_allreduce(a, "hvd", compression=mode),
                      x)
    total = x.sum(axis=0)
    for r, out in enumerate(ranks):
        got = out["allreduce/" + mode].numpy()
        assert got.dtype == np.float32 and got.shape == worker.ALLREDUCE_SHAPE
        assert _matches_jax(got, want[r], mode), (mode, r)
        # every rank holds the same values
        assert np.array_equal(got, ranks[0]["allreduce/" + mode].numpy())
        err = np.abs(got - total).max() / np.abs(total).max()
        assert err < SUM_TOL[mode], (mode, err)


@pytest.mark.parametrize("mode", worker.MODES)
def test_ring_reduce_scatter_matches_the_jax_ring(ranks, mode):
    x = _stack(worker.scatter_input)
    want = _jax_rings(
        lambda a: ring_reduce_scatter(a, "hvd", compression=mode), x)
    c = -(-(-(-worker.SCATTER_SIZE // 4)) // comp.BLOCK) * comp.BLOCK
    assert want.shape == (4, c)
    for r, out in enumerate(ranks):
        got = out["reduce_scatter/" + mode].numpy()
        assert _matches_jax(got, want[r], mode), (mode, r)


@pytest.mark.parametrize("mode", worker.MODES)
def test_ring_allgather_matches_the_jax_ring(ranks, mode):
    x = np.stack([worker.gather_input(r, mode) for r in range(4)])
    want = _jax_rings(lambda a: ring_allgather(a, "hvd", compression=mode),
                      x)
    for r, out in enumerate(ranks):
        got = out["allgather/" + mode].numpy()
        assert np.array_equal(got, want[r]), (mode, r)
        assert np.array_equal(got, ranks[0]["allgather/" + mode].numpy())
    if mode == "none":
        assert np.array_equal(ranks[0]["allgather/none"].numpy(),
                              x.reshape(-1))


@pytest.mark.parametrize("mode", worker.MODES)
def test_scatter_then_gather_matches_the_jax_ring(ranks, mode):
    x = _stack(worker.round_trip_input)

    def both(a):
        return ring_allgather(ring_reduce_scatter(a, "hvd",
                                                  compression=mode),
                              "hvd", compression=mode)

    want = _jax_rings(both, x)
    for r, out in enumerate(ranks):
        assert _matches_jax(out["round_trip/" + mode].numpy(),
                                  want[r], mode)


def _reference_hops(kind, inputs, mode):
    """The reference's hop codec (``_ring_codec``: the bf16 cast, or
    ``quantize_int8_jax`` and ``dequantize_int8_jax``) run eagerly, op by
    op, over 4 virtual ranks on the reference's schedules: ``kind``
    "allreduce" (``ring_allreduce``), "reduce_scatter" (its leg with every
    chunk index shifted by -1) or "round_trip" (that leg, then the
    allgather of each rank's chunk). Returns (each rank's encoded payloads
    in the order it sent them, each rank's flat result)."""
    enc, dec, _ = _ring_codec(comp.resolve(mode))
    n = worker.WORLD
    size = inputs[0].size
    c = -(-(-(-size // n)) // comp.BLOCK) * comp.BLOCK
    chunks = [list(jnp.asarray(np.pad(x.reshape(-1), (0, n * c - size))
                               .reshape(n, c))) for x in inputs]
    sent = [[] for _ in range(n)]

    def send(r, v):
        sent[r].append(enc(v))
        return sent[r][-1]

    shift = 0 if kind == "allreduce" else -1
    for s in range(n - 1):
        out = [send(r, chunks[r][(r - s + shift) % n]) for r in range(n)]
        for r in range(n):
            i = (r - s - 1 + shift) % n
            chunks[r][i] = chunks[r][i] + dec(out[(r - 1) % n])
    if kind == "reduce_scatter":
        return sent, [np.asarray(chunks[r][r]) for r in range(n)]
    # the allgather: each owner encodes its chunk once, every payload
    # travels verbatim and the owner decodes its own copy too
    own = [(r + 1) % n if kind == "allreduce" else r for r in range(n)]
    payload = [send(r, chunks[r][own[r]]) for r in range(n)]
    for r in range(n):
        chunks[r][own[r]] = dec(payload[r])
    for s in range(n - 1):
        payload = [payload[(r - 1) % n] for r in range(n)]
        for r in range(n):
            chunks[r][(own[r] - s - 1) % n] = dec(payload[r])
    flat = [np.concatenate([np.asarray(t) for t in chunks[r]])
            for r in range(n)]
    return sent, [f[:size] if kind == "allreduce" else f for f in flat]


RING_INPUTS = {"allreduce": worker.allreduce_input,
               "reduce_scatter": worker.scatter_input,
               "round_trip": worker.round_trip_input}


@pytest.mark.parametrize("mode", worker.MODES)
@pytest.mark.parametrize("kind", sorted(RING_INPUTS))
def test_every_hop_sends_the_reference_codec_payload(ranks, kind, mode):
    """Hop for hop, each rank's payload equals the reference codec's on
    the reference's schedule: under int8 every q and every scale, under
    bf16 every value; and so does each rank's result."""
    inputs = [RING_INPUTS[kind](r) for r in range(worker.WORLD)]
    sent, results = _reference_hops(kind, inputs, mode)
    for r, out in enumerate(ranks):
        hops = out["hops/%s/%s" % (kind, mode)]
        # n - 1 reduce-scatter hops, and one encode for the allgather
        assert len(hops) == len(sent[r]) == worker.WORLD - (
            kind == "reduce_scatter")
        for got, want in zip(hops, sent[r]):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                if g.dtype == torch.bfloat16:
                    g, w = g.float(), w.astype(jnp.float32)
                assert _same(g.numpy().reshape(-1),
                             np.asarray(w).reshape(-1)), (kind, mode, r)
        assert _same(out["%s/%s" % (kind, mode)].numpy().reshape(-1),
                     results[r]), (kind, mode, r)


def test_non_f32_rides_none_exactly(ranks):
    x = _stack(worker.int_input)
    want = _jax_rings(lambda a: ring_allreduce(a, "hvd", compression="int8"),
                      x)
    for r, out in enumerate(ranks):
        assert out["int32"].dtype == torch.int32
        assert np.array_equal(out["int32"].numpy(), x.sum(axis=0))
        assert np.array_equal(out["int32"].numpy(), want[r])
        c = out["int32_rs"].numel()
        full = np.zeros(4 * c, np.int32)
        full[:64] = x.sum(axis=0)
        assert np.array_equal(out["int32_rs"].numpy(),
                              full[r * c:(r + 1) * c])
        assert np.array_equal(out["hvd.allreduce/int32"].numpy(),
                              x.sum(axis=0))


def test_cpu_ranks_launch_no_kernel(ranks):
    for out in ranks:
        assert out["kernel_launches"] == {"wire_encode": 0,
                                          "wire_decode_add": 0}


@pytest.mark.parametrize("mode", worker.MODES)
def test_allreduce_with_a_wire_mode_matches_the_jax_in_jit_plane(ranks,
                                                                 mode):
    """hvd.allreduce(average=True, compression=mode) against
    hvd_jax.allreduce in-jit: psum in mode none (another sum order), the
    same ring under bf16 and int8 (equal), and the exact mean within the
    reference's limits (test_jax_allreduce_compressed_in_jit)."""
    x = np.stack([torch_port_api_worker.rank_input(
        r, worker.COLLECTIVE_SHAPE) for r in range(4)])
    want = _jax_rings(lambda a: hvd_jax.allreduce(
        a, average=True, axis_name="hvd", compression=mode), x)
    mean = x.mean(axis=0)
    for r, out in enumerate(ranks):
        got = out["hvd.allreduce/" + mode].numpy()
        if mode == "none":
            np.testing.assert_allclose(got, want[r], rtol=F32_TOL,
                                       atol=F32_TOL)
        else:
            assert _matches_jax(got, want[r], mode), (mode, r)
        err = np.abs(got - mean).max() / np.abs(mean).max()
        assert err < SUM_TOL[mode], (mode, err)
    for out in ranks:
        assert torch.equal(out["hvd.allreduce/wire_int8"],
                           ranks[0]["hvd.allreduce/int8"])


@pytest.mark.parametrize("mode", worker.MODES)
def test_reduce_scatter_with_a_wire_mode(ranks, mode):
    """Under bf16 and int8, the ring's block-aligned chunk, equal to JAX's
    in-jit reduce_scatter; in mode none the shard_partition shard of the
    mean."""
    x = np.stack([torch_port_api_worker.rank_input(r, (worker.RS_COUNT,),
                                                   seed=30)
                  for r in range(4)])
    if mode == "none":
        counts, offsets = hvd.shard_partition(worker.RS_COUNT, 4)
        mean = x.mean(axis=0)
        for r, out in enumerate(ranks):
            np.testing.assert_allclose(
                out["hvd.reduce_scatter/none"].numpy(),
                mean[offsets[r]:offsets[r] + counts[r]], rtol=F32_TOL,
                atol=F32_TOL)
        return
    want = _jax_rings(lambda a: hvd_jax.reduce_scatter(
        a, average=True, axis_name="hvd", compression=mode), x)
    for r, out in enumerate(ranks):
        got = out["hvd.reduce_scatter/" + mode].numpy()
        assert got.shape == (256,)
        assert _matches_jax(got, want[r], mode), (mode, r)


def test_distributed_optimizer_reduces_buckets_through_the_ring(ranks):
    """Under the int8 wire the hooks still send every bucket in the
    backward, in order, and each bucket's gradients are the bucket summed
    by ring_allreduce and averaged, bit for bit; within the int8 limit of
    the exact mean."""
    for out in ranks:
        d = out["dopt_int8"]
        assert d["in_backward"] == list(range(d["buckets"]))
        for got, by_hand in zip(d["grads"], d["by_hand"]):
            assert torch.equal(got, by_hand)
        for got, other in zip(d["grads"], ranks[0]["dopt_int8"]["grads"]):
            assert torch.equal(got, other)
