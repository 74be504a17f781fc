"""The serve plane's swap, steadied: what a replica's host does in one.

A replica's swap shares its host, and its GIL, with the HTTP threads and
the batch loop. The port's watcher reads each shard of a candidate once,
with its CRC32C (``durable.load_leaves(verify=True)`` is the deep
validation), waits its stagger before the load, fingerprints the leaves
without copying them and uploads them from one host copy; a torn or
CRC-invalid candidate still falls back to the next-older one, as in
``horovod_tpu/serve/swap.py``. Held here against the reference's
watcher and fingerprint on the CPU."""

import builtins
import os
import time

import numpy as np
import pytest

from horovod_tpu.serve import model as ref_model
from horovod_tpu.serve.swap import SwapWatcher as RefWatcher
from horovod_tpu_torch.elastic import durable
from horovod_tpu_torch.serve import model as smodel
from horovod_tpu_torch.serve import replica as sreplica
from horovod_tpu_torch.serve.metrics import ServeMetrics
from horovod_tpu_torch.serve.swap import SwapWatcher, publish_leaves

DIM = 8


def _leaves(seed, name="mlp"):
    return smodel.init_leaves(name, DIM, seed=seed)


def _shards(ckpt, step):
    path = [p for s, g, p in durable.list_checkpoints(str(ckpt))
            if s == step][0]
    return [os.path.join(path, f) for f in sorted(os.listdir(path))
            if f != durable.MANIFEST_NAME]


@pytest.fixture
def reads(monkeypatch):
    """{shard path: times opened} and [bytes CRC'd by durable.crc32c]."""
    opened, crcd = {}, []
    real_open, real_crc = builtins.open, durable.crc32c

    def counting_open(path, *args, **kwargs):
        if not str(path).endswith(durable.MANIFEST_NAME):
            opened[str(path)] = opened.get(str(path), 0) + 1
        return real_open(path, *args, **kwargs)

    def counting_crc(data, crc=0):
        crcd.append(len(memoryview(data).cast("B")) if not isinstance(
            data, bytes) else len(data))
        return real_crc(data, crc)

    monkeypatch.setattr(durable, "open", counting_open, raising=False)
    monkeypatch.setattr(durable, "crc32c", counting_crc)
    return opened, crcd


def _watcher(ckpt, current, flips, cls=SwapWatcher, metrics=None,
             stagger=0.0):
    def flip(step, leaves, crc):
        current[0] = step
        flips.append((step, crc))

    return cls(str(ckpt), _leaves(0), current_step_fn=lambda: current[0],
               flip_fn=flip, metrics=metrics, stagger=stagger)


def test_each_shard_of_a_swap_is_read_and_crcd_once(tmp_path, reads):
    opened, crcd = reads
    new = _leaves(3)
    publish_leaves(str(tmp_path), 10, new)
    shard, = _shards(tmp_path, 10)
    opened.clear()
    del crcd[:]
    current, flips = [-1], []
    assert _watcher(tmp_path, current, flips).poll_once() == 10
    assert flips == [(10, ref_model.fingerprint(new))]
    assert opened == {shard: 1}
    # one CRC over the shard's bytes; the rest is the fingerprint's, one
    # a leaf name and one a leaf
    assert crcd.count(os.path.getsize(shard)) == 1
    assert sorted(crcd[1:]) == sorted(
        [len(k) for k in new] + [v.nbytes for v in new.values()])


def test_fall_back_past_a_crc_invalid_shard_reads_each_shard_once(
        tmp_path, reads):
    """The newest candidate's shard has a flipped bit: it is read once,
    rejected once, and the next-older candidate is served (the
    reference validates and then reads the good candidate twice)."""
    opened, _ = reads
    good = _leaves(4)
    publish_leaves(str(tmp_path), 10, good)
    publish_leaves(str(tmp_path), 20, _leaves(5))
    bad, = _shards(tmp_path, 20)
    blob = bytearray(open(bad, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(bad, "wb") as f:
        f.write(bytes(blob))
    ok, = _shards(tmp_path, 10)
    m, current, flips = ServeMetrics(), [-1], []
    w = _watcher(tmp_path, current, flips, metrics=m)
    opened.clear()
    assert w.poll_once() == 10
    assert opened == {bad: 1, ok: 1}
    assert flips == [(10, ref_model.fingerprint(good))]
    assert m.snapshot()["counters"]["serve_swap_rejects_total"] == 1
    # the rejected directory is not read again
    opened.clear()
    assert w.poll_once() is None and opened == {}
    assert m.snapshot()["counters"]["serve_swap_rejects_total"] == 1
    # the reference lands on the same step and weights
    ref_current, ref_flips = [-1], []
    ref = _watcher(tmp_path, ref_current, ref_flips, cls=RefWatcher)
    assert ref.poll_once() == 10 and ref_flips == flips


def test_torn_manifest_and_bad_shard_fall_back_as_the_reference(tmp_path):
    """Three steps, the newest with a torn manifest and the next with a
    flipped bit: both watchers serve the oldest and count two rejects."""
    for step, seed in ((10, 6), (20, 7), (30, 8)):
        publish_leaves(str(tmp_path), step, _leaves(seed))
    path30 = [p for s, g, p in durable.list_checkpoints(str(tmp_path))
              if s == 30][0]
    manifest = os.path.join(path30, durable.MANIFEST_NAME)
    raw = open(manifest, "rb").read()
    with open(manifest, "wb") as f:
        f.write(raw[:len(raw) // 2])
    bad, = _shards(tmp_path, 20)
    blob = bytearray(open(bad, "rb").read())
    blob[-1] ^= 0x01
    with open(bad, "wb") as f:
        f.write(bytes(blob))
    seen = []
    for cls in (SwapWatcher, RefWatcher):
        m, current, flips = ServeMetrics(), [-1], []
        w = _watcher(tmp_path, current, flips, cls=cls, metrics=m)
        assert w.poll_once() == 10 and w.poll_once() is None
        seen.append((flips, w.rejects,
                     m.snapshot()["counters"]["serve_swap_rejects_total"]))
    assert seen[0] == seen[1] == ([(10, smodel.fingerprint(_leaves(6)))],
                                  2, 2)


def test_a_manifest_renamed_in_after_a_poll_is_swapped_to(tmp_path):
    """A checkpoint directory seen before its writer renamed the manifest
    in: that poll rejects it (once), the next one, after the rename,
    swaps to it; as the reference's watcher does."""
    publish_leaves(str(tmp_path), 10, _leaves(14))
    new = _leaves(15)
    publish_leaves(str(tmp_path), 20, new)
    path20 = [p for s, g, p in durable.list_checkpoints(str(tmp_path))
              if s == 20][0]
    manifest = os.path.join(path20, durable.MANIFEST_NAME)
    seen = []
    for cls in (SwapWatcher, RefWatcher):
        os.replace(manifest, manifest + ".held")
        m, current, flips = ServeMetrics(), [10], []
        w = _watcher(tmp_path, current, flips, cls=cls, metrics=m)
        assert w.poll_once() is None and w.poll_once() is None
        os.replace(manifest + ".held", manifest)
        assert w.poll_once() == 20 and w.poll_once() is None
        seen.append((flips, w.rejects, w.swaps))
    assert seen[0] == seen[1] == ([(20, smodel.fingerprint(new))], 1, 1)


def test_the_stagger_is_waited_before_the_load(tmp_path, reads,
                                               monkeypatch):
    opened, _ = reads
    publish_leaves(str(tmp_path), 10, _leaves(9))
    times = []
    real_load = durable.load_leaves

    def load(*args, **kwargs):
        times.append(time.monotonic())
        return real_load(*args, **kwargs)

    monkeypatch.setattr(durable, "load_leaves", load)
    current, flips = [-1], []
    w = _watcher(tmp_path, current, flips, stagger=0.3)
    t0 = time.monotonic()
    assert w.poll_once() == 10
    assert times and times[0] - t0 >= 0.3
    prof = w.last_profile
    assert prof["stagger_s"] >= 0.3 and prof["step"] == 10
    assert {"scan_s", "validate_load_s", "extract_s",
            "fingerprint_s"} <= set(prof) and prof["t1"] >= prof["t0"]
    # nothing newer: no stagger, no read
    opened.clear()
    t0 = time.monotonic()
    assert w.poll_once() is None and time.monotonic() - t0 < 0.3
    assert opened == {}


@pytest.mark.parametrize("name", ["affine", "mlp"])
def test_fingerprint_and_extract_copy_nothing_and_equal_the_reference(
        name):
    leaves = _leaves(11, name)
    assert smodel.fingerprint(leaves) == ref_model.fingerprint(leaves)
    strided = {k: np.asfortranarray(v) for k, v in leaves.items()}
    assert smodel.fingerprint(strided) == ref_model.fingerprint(strided)
    raw = {".params." + k: v for k, v in leaves.items()}
    got = smodel.extract_leaves(raw, leaves)
    assert all(np.shares_memory(got[k], raw[".params." + k])
               for k in leaves)
    ref = ref_model.extract_leaves(raw, leaves)
    assert all(np.array_equal(got[k], ref[k]) for k in leaves)


def test_make_forward_uploads_without_a_host_copy_and_holds_its_leaves():
    """The CPU forward copies each leaf once (its own tensors), from the
    caller's float32 array, and answers as the reference's forward."""
    leaves = _leaves(12)
    fwd = smodel.make_forward("mlp", leaves, device="cpu")
    x = np.random.RandomState(0).standard_normal((3, DIM)).astype(
        np.float32)
    want = ref_model.forward("mlp", leaves, x)
    for v in leaves.values():
        v += 1.0
    assert np.allclose(fwd(x), want, atol=1e-5)
    frozen = {k: np.frombuffer(v.tobytes(), np.float32).reshape(v.shape)
              for k, v in _leaves(12).items()}
    assert not any(v.flags.writeable for v in frozen.values())
    assert np.allclose(smodel.make_forward("mlp", frozen, device="cpu")(x),
                       want, atol=1e-5)


def test_replica_swap_profile_reads_the_batch_loops_longest_gap(
        tmp_path, monkeypatch):
    """``Replica.swap_profile``: the stages of the last swap and the
    longest gap between batch starts from its start to a tail after its
    flip."""
    monkeypatch.setenv("HVD_TPU_WORKER_ID", "0")
    args = sreplica.make_parser().parse_args(
        ["--model", "mlp", "--dim", str(DIM), "--device", "cpu",
         "--ckpt-dir", str(tmp_path)])
    rep = sreplica.Replica(args)
    rep._load_initial()
    assert rep.swap_profile() is None
    rep.watcher = SwapWatcher(str(tmp_path), rep.template,
                              current_step_fn=lambda: rep.step,
                              flip_fn=rep._flip)
    publish_leaves(str(tmp_path), 10, _leaves(13))
    assert rep.watcher.poll_once() == 10
    out = rep.swap_profile()
    assert {"upload_s", "warmup_s", "flip_s", "fingerprint_s",
            "validate_load_s", "extract_s", "stagger_s"} <= set(out)
    assert "t0" not in out and out["step"] == 10
    assert rep.ctx.view()["swap_profile"]["step"] == 10
    # a swap from t = 100 to 100.5, batches before, in and after it: the
    # gaps counted run from the last batch before it to a second past
    # its flip
    rep.watcher.last_profile = dict(step=10, t0=100.0, t1=100.5)
    rep._batch_starts.clear()
    rep._batch_starts.extend([98.0, 99.5, 100.1, 100.3, 100.35, 101.2,
                              103.0])
    assert rep.swap_profile(tail=1.0)["max_gap_ms"] == pytest.approx(850.0)
    rep._batch_starts.extend([104.0])
    assert rep.swap_profile(tail=0.2)["max_gap_ms"] == pytest.approx(600.0)


def test_the_crc32c_of_the_swap_equals_the_plain_one_at_every_alignment():
    """The swap's two CRC passes (the shards, the fingerprint) run on the
    port's crc32c, which takes SSE4.2's instruction where the CPU has it:
    equal to the plain version at every length below 40 from every
    alignment, chained, and on a 64 KiB buffer."""
    from horovod_tpu.elastic import durable as ref_durable
    blob = np.random.default_rng(23).integers(0, 256, 1 << 16,
                                              dtype=np.uint8)
    for off in range(8):
        for n in range(40):
            part = blob[off:off + n]
            assert durable.crc32c(part, 0xDEADBEEF) == \
                ref_durable._py_crc32c(part.tobytes(), 0xDEADBEEF)
    assert durable.crc32c(blob[3:]) == durable._py_crc32c(blob[3:].tobytes())
