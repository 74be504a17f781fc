"""The port's durable checkpoints (``horovod_tpu_torch.elastic.durable``)
against the JAX package's (``horovod_tpu.elastic.durable``), on the CPU.

The native crc32c (``elastic/native/checksum.cc``, built with g++ at first
use) equals its plain version ``_py_crc32c`` (and the reference's) on
seeded bytes; a failed build raises. The fault-spec parser fires as the
reference's on the same specs. The unit layer mirrors ``test_durable.py``
(round trips, sharding, torn and bit-flipped fallbacks, ENOSPC, retention,
pruning) on tensors, bfloat16 included; the sticky-snapshot test, a thread
race in the reference, passes steadily here. A checkpoint written by the
reference's writer from the small reference LM's parameters is read by the
port leaf for leaf and gives the port's LM the reference's loss; a
bit-flipped shard is skipped. The e2e runs (gloo ranks, launched by
``python -m horovod_tpu_torch.run``): a 2-rank sharded-update job killed
whole, resumed at half and at double the world size bit for bit, and the
driver's restart below ``--min-np`` from the last durable step.
"""

import io
import os
import pickle
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, seed, strategies as st

from horovod_tpu.elastic import durable as ref_durable
from horovod_tpu.elastic.state import ElasticState as RefElasticState
from horovod_tpu_torch.elastic import durable
from horovod_tpu_torch.elastic.durable import (CkptFaultInjector,
                                               DurableCheckpointer,
                                               MANIFEST_NAME,
                                               apply_retention,
                                               last_durable_step,
                                               latest_valid_manifest,
                                               list_checkpoints,
                                               load_leaves, prune_stale_tmp,
                                               prune_unrestorable,
                                               validate_manifest)
from horovod_tpu_torch.elastic.state import ElasticState, TorchState
from horovod_tpu_torch.run import util

ROOT = Path(__file__).resolve().parent.parent
SEED = 20261018
PROC_TIMEOUT = 150


def make_state(value=0.0, step=0):
    return ElasticState(w=torch.full((8,), value, dtype=torch.float64),
                        h=torch.full((3,), value, dtype=torch.bfloat16),
                        step=step,
                        nested={"a": torch.arange(3.0), "b": [1, 2.5]})


def write_ckpt(directory, step, value=1.0, world_size=1):
    """Synchronously writes one complete checkpoint at `step` (all shards
    from this process) and returns the state that was saved."""
    state = make_state(value, step)
    ckpts = [DurableCheckpointer(directory, rank=r, world_size=world_size)
             for r in range(world_size)]
    state.save()
    for ck in ckpts:
        ck.maybe_enqueue(state._committed, step)
    for ck in ckpts:
        assert ck.flush(timeout=60)
    return state


def assert_state_equal(a, b):
    assert torch.equal(a.w, b.w) and torch.equal(a.h, b.h)
    assert a.step == b.step and a.nested["b"] == b.nested["b"]
    assert torch.equal(a.nested["a"], b.nested["a"])


# ---------------------------------------------------------------------------
# CRC32C: the native library against its plain version

@seed(SEED)
@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=300), st.integers(0, 2 ** 32 - 1))
def test_native_crc32c_equals_the_plain_version(blob, start):
    assert durable.crc32c(blob, start) == durable._py_crc32c(blob, start) \
        == ref_durable._py_crc32c(blob, start)


def test_crc32c_known_answer_chaining_and_buffers():
    assert durable._py_crc32c(b"123456789") == 0xE3069283
    assert durable.crc32c(b"123456789") == 0xE3069283
    assert durable.crc32c(b"6789", durable.crc32c(b"12345")) == 0xE3069283
    gen = np.random.default_rng(SEED)
    blob = gen.integers(0, 256, 1 << 16, dtype=np.uint8)
    want = durable._py_crc32c(blob.tobytes())
    for view in (blob.tobytes(), bytearray(blob.tobytes()), blob,
                 memoryview(blob.tobytes()), torch.from_numpy(blob.copy())):
        assert durable.crc32c(view) == want


def test_crc32c_build_failure_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises CrcBuildError naming it; nothing falls
    back to the Python loop."""
    bad = tmp_path / "native"
    bad.mkdir()
    (bad / "checksum.h").write_text("")
    (bad / "checksum.cc").write_text("this is not C++\n")
    monkeypatch.setattr(durable, "NATIVE_DIR", bad)
    monkeypatch.setattr(durable, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(durable, "_native", None)
    with pytest.raises(durable.CrcBuildError, match="checksum.cc"):
        durable.crc32c(b"x")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises((durable.CrcBuildError, OSError)):
        durable.crc32c(b"x")


# ---------------------------------------------------------------------------
# The fault-spec parser against the reference

fields_st = st.lists(st.sampled_from([
    "op=shard", "op=manifest", "op=any", "rank=0", "rank=1", "write=0",
    "write=2", "prob=0.5", "prob=0.25", "count=1", "count=-1",
    "action=torn", "action=bitflip", "action=enospc", "action=slowfsync",
    "delay_ms=5", "wat=1", "op=nope", "action=explode"]), max_size=5)


@seed(SEED)
@settings(max_examples=80, deadline=None)
@given(st.lists(fields_st, max_size=3), st.integers(0, 9),
       st.integers(0, 1),
       st.lists(st.sampled_from(["shard", "manifest"]), max_size=20))
def test_fault_spec_fires_as_the_reference(rules, seed_, rank, writes):
    spec = ";".join(["seed=%d" % seed_] + [",".join(r) for r in rules])
    try:
        ref = ref_durable.CkptFaultInjector(spec, rank=rank)
    except ValueError:
        with pytest.raises(ValueError):
            CkptFaultInjector(spec, rank=rank)
        return
    port = CkptFaultInjector(spec, rank=rank)
    assert [port.on_write(op) for op in writes] == \
        [ref.on_write(op) for op in writes]
    assert port.fires == ref.fires


# ---------------------------------------------------------------------------
# Manifest round trip, sharding, tensors

def test_roundtrip_single_rank_with_tensors_in_place(tmp_path):
    d = str(tmp_path)
    saved = write_ckpt(d, step=7, value=4.25)
    manifest, _ = latest_valid_manifest(d)
    assert (manifest["step"], manifest["world_size"],
            len(manifest["shards"])) == (7, 1, 1)
    fresh = make_state()
    w = fresh.w
    assert DurableCheckpointer(d, rank=0, world_size=1).restore_into(
        fresh) == 7
    assert fresh.w is w  # restored in place
    assert_state_equal(fresh, saved)


def test_tensor_leaves_keep_dtype_shape_and_bits(tmp_path):
    gen = torch.Generator().manual_seed(SEED)
    leaves = {"bf16": torch.randn(5, 3, generator=gen).bfloat16(),
              "f16": torch.randn(4, generator=gen).half(),
              "i64": torch.arange(6).reshape(2, 3),
              "b": torch.tensor([True, False]),
              "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}
    for name, t in leaves.items():
        buf = io.BytesIO()
        durable._ShardPickler(buf, durable._Stager(None, {})).dump(
            durable._tagged(t))
        back = durable.decode_leaf(pickle.loads(buf.getvalue()))
        assert back.dtype == t.dtype and back.shape == t.shape, name
        assert torch.equal(back.reshape(-1).view(torch.uint8),
                           t.reshape(-1).view(torch.uint8)), name


def test_writer_streams_tensor_bytes_into_the_shard(tmp_path, monkeypatch):
    """The writer pickles the shard straight into its file: a 1 MiB
    tensor's bytes reach the file in one write of a buffer over them (no
    bytes object of the shard), the shard's name carries the CRC32C and
    size of the file, and the shard's time is split into its parts."""
    writes = []
    write = durable._CrcWriter.write

    def spy(self, data):
        writes.append((type(data), memoryview(data).nbytes))
        return write(self, data)

    monkeypatch.setattr(durable._CrcWriter, "write", spy)
    big = torch.arange(2 ** 18, dtype=torch.float32)
    state = ElasticState(big=big, step=4)
    state.save()
    ck = DurableCheckpointer(str(tmp_path), rank=0, world_size=1)
    before = len(durable.METRICS["shards"])
    ck.maybe_enqueue(state._committed, 4)
    assert ck.flush(timeout=60)
    assert (pickle.PickleBuffer, 2 ** 20) in writes
    assert all(n < 2 ** 16 for t, n in writes if t is not pickle.PickleBuffer)
    manifest, path = latest_valid_manifest(str(tmp_path))
    (shard,) = manifest["shards"]
    with open(os.path.join(path, shard["file"]), "rb") as f:
        data = f.read()
    assert len(data) == shard["bytes"] == sum(n for _, n in writes)
    assert durable._py_crc32c(data) == shard["crc32c"]
    assert torch.equal(load_leaves(manifest, path)[".big"], big)
    (prof,) = durable.METRICS["shards"][before:]
    parts = ("stage_seconds", "crc_seconds", "write_seconds",
             "pickle_seconds", "fsync_seconds")
    assert prof["bytes"] == shard["bytes"]
    assert all(prof[k] >= -1e-6 for k in parts)
    assert sum(prof[k] for k in parts) <= prof["seconds"] + 1e-6


def test_sharded_write_and_resharded_restore(tmp_path):
    d = str(tmp_path)
    saved = write_ckpt(d, step=10, value=-2.5, world_size=2)
    manifest, path = latest_valid_manifest(d)
    assert manifest["world_size"] == 2 and len(manifest["shards"]) == 2
    leaves = load_leaves(manifest, path)
    for shard in manifest["shards"]:
        with open(os.path.join(path, shard["file"]), "rb") as f:
            part = pickle.loads(f.read())
        assert 0 < len(part) < len(leaves)
    fresh = make_state()
    assert DurableCheckpointer(d, rank=0, world_size=1).restore_into(
        fresh) == 10
    assert_state_equal(fresh, saved)


def test_structural_mismatch_falls_back_to_matching_older(tmp_path):
    d = str(tmp_path)
    saved = write_ckpt(d, step=3, value=7.0)
    foreign = ElasticState(qq=torch.ones(4), step=9)
    ck = DurableCheckpointer(d, rank=0, world_size=1)
    foreign.save()
    ck.maybe_enqueue(foreign._committed, 9)
    assert ck.flush(timeout=60)
    assert latest_valid_manifest(d)[0]["step"] == 9
    fresh = make_state()
    assert DurableCheckpointer(d, rank=0, world_size=1).restore_into(
        fresh) == 3
    assert_state_equal(fresh, saved)
    other = ElasticState(q=torch.zeros(2), step=0)
    assert DurableCheckpointer(d, rank=0, world_size=1).restore_into(
        other) is None
    assert torch.equal(other.q, torch.zeros(2))


def test_torch_state_restores_into_a_fresh_optimizer(tmp_path):
    """The checkpoint's own structure restores an Adam that has not
    stepped yet (a fresh process): the state grew since the fresh
    TorchState was built."""
    def model_and_adam():
        torch.manual_seed(0)
        m = torch.nn.Linear(3, 2)
        return m, torch.optim.Adam(m.parameters(), lr=0.1)

    model, opt = model_and_adam()
    for _ in range(2):
        opt.zero_grad()
        model(torch.ones(4, 3)).sum().backward()
        opt.step()
    state = TorchState(model, opt, step=2)
    ck = DurableCheckpointer(str(tmp_path), rank=0, world_size=1)
    state.save()
    ck.maybe_enqueue(state._committed, 2)
    assert ck.flush(timeout=60)
    fresh_model, fresh_opt = model_and_adam()
    fresh = TorchState(fresh_model, fresh_opt, step=0)
    assert DurableCheckpointer(str(tmp_path), rank=0,
                               world_size=1).restore_into(fresh) == 2
    assert fresh.step == 2
    for p, q in zip(model.parameters(), fresh_model.parameters()):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][key], fresh_opt.state[q][key])


# ---------------------------------------------------------------------------
# The writer's queue

@pytest.mark.parametrize("wake", ["immediately", "late"])
def test_sticky_snapshots_guarantee_durable_progress(tmp_path, monkeypatch,
                                                     wake):
    """The 1-in-K sticky slot under storage far slower than the commits
    (the reference's test): the first commit (sticky) stays durable, the
    newest lands, and a mid-run sticky anchor lands, whether the writer
    takes the first job before the next commits or after them (the
    reference's race: a writer that took job 0 first wrote four
    checkpoints, and retention dropped step 0)."""
    d = str(tmp_path)
    state = make_state()
    ck = DurableCheckpointer(
        d, rank=0, world_size=1,
        fault_spec="op=shard,prob=1.0,action=slowfsync,delay_ms=500,"
                   "count=-1")
    ck._sticky_every = 3  # due commits 0, 3, 6 are sticky
    state._durable = ck
    if wake == "late":  # the writer starts only after the last commit
        start = ck._start_locked
        monkeypatch.setattr(ck, "_start_locked", lambda: None)
    for step in range(9):
        state.step = step
        state.commit()  # never blocks
        if wake == "immediately" and step == 0:
            with ck._cv:  # the writer holds job 0 before commit 1
                while not ck._head_taken:
                    ck._cv.wait(0.01)
    if wake == "late":
        with ck._cv:
            start()
    assert ck.flush(timeout=60)
    steps = sorted(s for s, g, p in list_checkpoints(d))
    assert steps == [0, 6, 8], steps


def test_every_n_commits_and_off_stride_cadence(tmp_path):
    for every, commits, want in ((3, range(7), [0, 3, 6]),
                                 (10, (3, 8, 13, 18, 23), [3, 13, 23])):
        d = str(tmp_path / str(every))
        state = make_state()
        ck = DurableCheckpointer(d, every_n_commits=every, rank=0,
                                 world_size=1)
        state._durable = ck
        for step in commits:
            state.step = step
            state.commit()
            assert ck.flush(timeout=60)
        assert sorted(s for s, g, p in list_checkpoints(d)) == want


def test_storage_slower_than_commits_skips_to_newest(tmp_path):
    d = str(tmp_path)
    state = make_state()
    ck = DurableCheckpointer(
        d, rank=0, world_size=1,
        fault_spec="op=shard,prob=1.0,action=slowfsync,delay_ms=200,"
                   "count=-1")
    state._durable = ck
    for step in range(5):
        state.step = step
        state.commit()
    assert ck.flush(timeout=60)
    steps = sorted(s for s, g, p in list_checkpoints(d))
    assert steps[-1] == 4 and len(steps) < 5


# ---------------------------------------------------------------------------
# Torn writes, bit flips, ENOSPC

@pytest.mark.parametrize("damage", ["torn_shard", "bitflip_shard",
                                    "torn_manifest", "no_manifest"])
def test_fallback_skips_damaged_checkpoints(tmp_path, damage):
    d = str(tmp_path)
    good = write_ckpt(d, step=5, value=1.0)
    write_ckpt(d, step=9, value=9.0)
    step9 = [p for s, g, p in list_checkpoints(d) if s == 9][0]
    shard = os.path.join(step9, [n for n in os.listdir(step9)
                                 if n.startswith("shard-")][0])
    if damage == "torn_shard":
        data = open(shard, "rb").read()
        open(shard, "wb").write(data[:len(data) // 2])
    elif damage == "bitflip_shard":
        data = bytearray(open(shard, "rb").read())
        data[len(data) // 3] ^= 0x01
        open(shard, "wb").write(bytes(data))
    elif damage == "torn_manifest":
        mpath = os.path.join(step9, MANIFEST_NAME)
        raw = open(mpath, "rb").read()
        open(mpath, "wb").write(raw[:len(raw) // 2])
    else:
        os.remove(os.path.join(step9, MANIFEST_NAME))
    assert validate_manifest(step9) is None
    assert latest_valid_manifest(d)[0]["step"] == 5
    fresh = make_state()
    assert DurableCheckpointer(d, rank=0, world_size=1).restore_into(
        fresh) == 5
    assert_state_equal(fresh, good)


def test_injected_faults_produce_invalid_checkpoints(tmp_path):
    d = str(tmp_path)
    state = make_state(1.0, 0)
    state.save()
    for step, spec in ((1, "op=shard,write=0,action=bitflip"),
                       (2, "op=shard,write=0,action=torn"),
                       (3, "op=manifest,write=0,action=torn")):
        ck = DurableCheckpointer(d, rank=0, world_size=1, fault_spec=spec)
        ck.maybe_enqueue(state._committed, step)
        assert ck.flush(timeout=60)
        assert ck._injector.fires == 1
    assert all(validate_manifest(p) is None
               for _, _, p in list_checkpoints(d))
    assert latest_valid_manifest(d) == (None, None)
    write_ckpt(d, step=4, value=4.0)
    assert latest_valid_manifest(d)[0]["step"] == 4


def test_enospc_degrades_to_warning_never_raises(tmp_path, capsys):
    d = str(tmp_path)
    state = make_state(1.0, 0)
    ck = DurableCheckpointer(d, rank=0, world_size=1,
                             fault_spec="op=shard,prob=1.0,action=enospc,"
                                        "count=-1")
    ck._retries = 2
    state.save()
    ck.maybe_enqueue(state._committed, 1)
    assert ck.flush(timeout=60)
    assert latest_valid_manifest(d) == (None, None)
    assert ck.last_durable_step == -1
    assert "FAILED after 3 attempts" in capsys.readouterr().err
    ck2 = DurableCheckpointer(d, rank=0, world_size=1)
    ck2.maybe_enqueue(state._committed, 2)
    assert ck2.flush(timeout=60)
    assert latest_valid_manifest(d)[0]["step"] == 2


class _Unpicklable:
    def __deepcopy__(self, memo):
        return self

    def __reduce__(self):
        raise TypeError("deliberately unpicklable")


def test_unpicklable_state_degrades_and_writer_survives(tmp_path, capsys):
    d = str(tmp_path)
    bad = ElasticState(w=torch.zeros(2), step=0, extra=_Unpicklable())
    ck = DurableCheckpointer(d, rank=0, world_size=1)
    bad._durable = ck
    bad.commit()
    assert ck.flush(timeout=60)
    assert latest_valid_manifest(d) == (None, None)
    assert "FAILED" in capsys.readouterr().err
    good = make_state(3.0, 4)
    good.save()
    ck.maybe_enqueue(good._committed, 4)
    assert ck.flush(timeout=60)
    assert latest_valid_manifest(d)[0]["step"] == 4


def test_abandoned_publish_does_not_claim_durability(tmp_path, capsys):
    d = str(tmp_path)
    state = make_state(1.0, 5)
    state.save()
    ck = DurableCheckpointer(d, rank=0, world_size=2, publish_timeout=0.3)
    ck.maybe_enqueue(state._committed, 5)
    assert ck.flush(timeout=60)
    assert "abandoning manifest" in capsys.readouterr().err
    assert ck.last_durable_step == -1
    assert last_durable_step(d) == (None, None)


def test_publisher_refuses_ambiguous_duplicate_shards(tmp_path, capsys):
    d = str(tmp_path)
    ckdir = os.path.join(d, durable._ckpt_dirname(5, 0))
    os.makedirs(ckdir)
    stale = pickle.dumps({"stale": True})
    name = durable._shard_name(0, 1, durable.crc32c(stale), len(stale))
    open(os.path.join(ckdir, name), "wb").write(stale)
    state = make_state(1.0, 5)
    ck = DurableCheckpointer(d, rank=0, world_size=1)
    state.save()
    ck.maybe_enqueue(state._committed, 5)
    assert ck.flush(timeout=60)
    assert "ambiguous duplicate shard" in capsys.readouterr().err
    assert validate_manifest(ckdir) is None


# ---------------------------------------------------------------------------
# Hygiene: tmp pruning, retention, the operator's summary

def test_prune_stale_tmp_and_unrestorable(tmp_path):
    d = str(tmp_path)
    write_ckpt(d, step=3)
    ckpt_dir = list_checkpoints(d)[0][2]
    for name in ("shard-00001-of-00002.deadbeef.12.bin.tmp",
                 MANIFEST_NAME + ".tmp"):
        open(os.path.join(ckpt_dir, name), "w").write("partial")
    assert prune_stale_tmp(d) == 2
    orphan = os.path.join(d, "ckpt-%012d-g0" % 7)
    os.makedirs(orphan)
    payload = b"stale trajectory"
    open(os.path.join(orphan, "shard-00000-of-00001.%08x.%d.bin" % (
        durable.crc32c(payload), len(payload))), "wb").write(payload)
    assert prune_unrestorable(d) == ["ckpt-000000000007-g0"]
    assert latest_valid_manifest(d)[0]["step"] == 3


def test_retention(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_CKPT_KEEP", "3")
    d = str(tmp_path)
    for step in range(5):
        write_ckpt(d, step=step, value=float(step))
    assert sorted(s for s, g, p in list_checkpoints(d)) == [2, 3, 4]
    monkeypatch.setenv("HVD_TPU_CKPT_KEEP", "2")
    os.makedirs(os.path.join(d, "ckpt-%012d-g0" % 1))
    removed = apply_retention(d)
    assert sorted(s for s, g, p in list_checkpoints(d)) == [3, 4]
    assert len(removed) == 2
    assert last_durable_step(d)[0] == 4


def test_auto_resume_in_run_wrapper(tmp_path, monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    d = str(tmp_path)
    saved = write_ckpt(d, step=5, value=2.5)
    monkeypatch.setenv("HVD_TPU_CKPT_DIR", d)
    hvd.init(device="cpu")
    try:
        state = make_state()

        @elastic.run
        def train(st):
            return st.step

        assert train(state) == 5
        assert_state_equal(state, saved)
        assert state.durable is not None
    finally:
        hvd.shutdown()


def test_launcher_failure_summary_names_last_durable_step(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    write_ckpt(ckpt_dir, step=12)
    env = util.cpu_worker_env(repo_root=str(ROOT),
                              extra_env={"HVD_TPU_CKPT_DIR": ckpt_dir})
    result = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1", "--",
         sys.executable, "-c", "import sys; sys.exit(3)"],
        env=env, cwd=str(ROOT), timeout=PROC_TIMEOUT, capture_output=True,
        text=True)
    assert result.returncode == 3
    assert "last durable checkpoint: step 12" in result.stderr


# ---------------------------------------------------------------------------
# Weights carried across: the reference's checkpoint in the port

def test_reference_checkpoint_of_the_lm_restores_in_the_port(tmp_path):
    """The reference's writer saves the small reference LM's parameters
    (two shards); the port reads every leaf equal, and through
    convert.py they give the port's LM the reference's loss. A newer
    checkpoint whose shard the reference's fault injector bit-flipped is
    skipped, as the reference skips it."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu import models as jax_models
    from horovod_tpu_torch.convert import transformer_state_dict_from_jax
    from horovod_tpu_torch.elastic.state import (_tree_flatten,
                                                 _tree_map_leaves)
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.parallel import lm_loss

    small = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64,
                 mlp_dim=256, max_seq_len=256)
    cfg_j = jax_models.TransformerConfig(attention="dense",
                                         dtype=jnp.float32, **small)
    model_j = jax_models.Transformer(cfg_j)
    tokens = np.random.default_rng(SEED).integers(0, 128, (2, 32))
    x = jnp.asarray(tokens)
    params = jax.tree_util.tree_map(np.asarray, model_j.init(
        jax.random.PRNGKey(0), x[:1])["params"])

    def loss_fn(p):
        logp = jax.nn.log_softmax(model_j.apply({"params": p}, x).astype(
            jnp.float32))
        tgt = jnp.roll(x, -1, axis=1)
        return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], -1))

    with jax.default_matmul_precision("highest"):
        loss_j = float(loss_fn(params))

    d = str(tmp_path)
    ref_state = RefElasticState(params=params, step=5)
    writers = [ref_durable.DurableCheckpointer(d, rank=r, world_size=2)
               for r in range(2)]
    ref_state.save()
    for w in writers:
        w.maybe_enqueue(ref_state._committed, 5)
    for w in writers:
        assert w.flush(timeout=60)
    # a newer checkpoint whose rank-1 shard the injector bit-flips
    flipped = [ref_durable.DurableCheckpointer(
        d, rank=r, world_size=2, fault_spec="rank=1,op=shard,write=0,"
                                            "action=bitflip")
        for r in range(2)]
    for w in flipped:
        w.maybe_enqueue(ref_state._committed, 8)
    for w in flipped:
        assert w.flush(timeout=60)
    assert ref_durable.latest_valid_manifest(d)[0]["step"] == 5

    manifest, path = latest_valid_manifest(d)
    assert manifest["step"] == 5 and manifest["world_size"] == 2
    leaves = load_leaves(manifest, path, verify=True)
    flat = _tree_flatten(ref_state._committed)
    assert sorted(leaves) == sorted(p for p, _ in flat)
    for p, leaf in flat:
        assert type(leaves[p]) is type(leaf)
        if isinstance(leaf, np.ndarray):
            assert leaves[p].dtype == leaf.dtype
            assert np.array_equal(leaves[p], leaf), p
        else:
            assert leaves[p] == leaf, p
    carried = _tree_map_leaves(ref_state._committed,
                               iter([leaves[p] for p, _ in flat]))
    cfg = TransformerConfig(attention="dense", dtype=torch.float32, **small)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(transformer_state_dict_from_jax(
        carried["params"], cfg))
    with torch.no_grad():
        loss = lm_loss(model, torch.from_numpy(tokens))
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-6)
    # the port's restore skips the flipped checkpoint too
    fresh = ElasticState(params=jax.tree_util.tree_map(np.zeros_like,
                                                       params), step=0)
    assert DurableCheckpointer(d, rank=0, world_size=1).restore_into(
        fresh) == 5
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(fresh.params),
        jax.tree_util.tree_leaves(params)))


# ---------------------------------------------------------------------------
# E2E: kill everything, relaunch at half and double the world size

START = re.compile(r"worker (\S+) start step (\d+) crc ([0-9a-f]{8}) "
                   r"size (\d+)")
COMMIT = re.compile(r"worker (\S+) commit step (\d+) crc ([0-9a-f]{8})")
DONE = re.compile(r"worker (\S+) done step (\d+) crc ([0-9a-f]{8})")
WORKER = str(ROOT / "tests" / "torch_port_durable_worker.py")


def _env(extra):
    return util.cpu_worker_env(repo_root=str(ROOT), extra_env=dict({
        "HVD_TPU_ELASTIC_COOLDOWN": "2",
        "HVD_TPU_ELASTIC_DISCOVERY_INTERVAL": "0.3",
        "HVD_TPU_START_TIMEOUT": "30"}, **extra))


def _cmd(ckpt_dir, np_, extra_args=()):
    return [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
            "--min-np", "1", "--ckpt-dir", ckpt_dir] + list(extra_args) + \
        ["--", sys.executable, WORKER]


def _commit_crcs(out):
    crcs = {}
    for _, step, crc in COMMIT.findall(out):
        assert crcs.setdefault(int(step), crc) == crc, (step, out)
    return crcs


@pytest.fixture(scope="module")
def reference_crcs():
    """The trajectory's CRC after 6, 16 and 24 steps, computed in this
    process at world size 1."""
    import horovod_tpu_torch as hvd
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        import torch_port_durable_worker as worker
    finally:
        sys.path.remove(str(ROOT / "tests"))
    hvd.init(device="cpu")
    try:
        return {n: "%08x" % worker.run_steps(n) for n in (6, 16, 24)}
    finally:
        hvd.shutdown()


def test_kill_everything_then_relaunch_at_half_and_double_world(
        tmp_path, reference_crcs):
    """A 2-rank sharded-update job holds after step 6's durable commit
    and is SIGKILLed whole (driver and workers); a relaunch at half the
    world size (1) resumes at step 6 bit for bit and runs to 16, and one
    at double (4) resumes there and ends at step 24 on the CRC of one
    process's 24 steps (the port's counterpart of the reference's
    test_kill_everything_then_relaunch_resumes_bitwise and
    test_sharded_update_kill_restore_half_and_double_world)."""
    ckpt = str(tmp_path / "ckpt")
    pid_dir = tmp_path / "pids"
    pid_dir.mkdir()
    proc = subprocess.Popen(
        _cmd(ckpt, 2), env=_env({"DURABLE_TEST_TOTAL_STEPS": "200",
                                 "DURABLE_TEST_HOLD_STEP": "6",
                                 "DURABLE_TEST_PID_DIR": str(pid_dir)}),
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, start_new_session=True)
    lines = []
    try:
        deadline = time.monotonic() + PROC_TIMEOUT
        while sum("holding" in line for line in lines) < 2:
            line = proc.stdout.readline()
            assert line and time.monotonic() < deadline, lines
            lines.append(line)
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        for pidfile in pid_dir.iterdir():
            try:
                os.killpg(os.getpgid(int(pidfile.read_text())),
                          signal.SIGKILL)
            except (ProcessLookupError, PermissionError, ValueError):
                pass
        lines += proc.stdout.readlines()
        proc.wait(timeout=30)
    crcs = _commit_crcs("".join(lines))
    assert crcs[6] == reference_crcs[6], crcs
    assert latest_valid_manifest(ckpt)[0]["step"] == 6

    def relaunch(np_, total):
        result = subprocess.run(
            _cmd(ckpt, np_), env=_env({"DURABLE_TEST_TOTAL_STEPS":
                                       str(total)}),
            cwd=str(ROOT), timeout=PROC_TIMEOUT, capture_output=True,
            text=True)
        assert result.returncode == 0, (result.stdout, result.stderr)
        starts = START.findall(result.stdout)
        assert len(starts) == np_
        done = DONE.findall(result.stdout)
        assert len(done) == np_ and all(int(s) == total for _, s, _ in done)
        return starts, done

    starts, done = relaunch(1, 16)
    assert [(int(s), c, int(n)) for _, s, c, n in starts] == \
        [(6, crcs[6], 1)]
    assert done[0][2] == reference_crcs[16]
    starts, done = relaunch(4, 24)
    assert {(int(s), c, int(n)) for _, s, c, n in starts} == \
        {(16, reference_crcs[16], 4)}
    assert {c for _, _, c in done} == {reference_crcs[24]}


def test_driver_restart_from_ckpt_below_min_np(tmp_path, reference_crcs):
    """Both workers die at step 7 of generation 0 (after flushing their
    writers), the host is blacklisted for 600 s, so the world cannot reach
    --min-np=2: the driver restarts the whole job, whose fresh cohort
    resumes from the step-6 durable commit bit for bit and finishes."""
    result = subprocess.run(
        _cmd(str(tmp_path / "ckpt"), 2,
             ["--min-np", "2", "--restart-from-ckpt"]),
        env=_env({"DURABLE_TEST_CRASH_STEP": "7",
                  "DURABLE_TEST_CRASH_WIDS": "0,1",
                  "HVD_TPU_ELASTIC_COOLDOWN": "600",
                  "HVD_TPU_START_TIMEOUT": "15"}),
        cwd=str(ROOT), timeout=PROC_TIMEOUT, capture_output=True, text=True)
    out, err = result.stdout, result.stderr
    assert result.returncode == 0, (out, err)
    assert out.count("crashing now") == 2, out
    assert err.count("full-job restart 1/") == 1, err
    resumed = [(int(s), c) for _, s, c, _ in START.findall(out)
               if int(s) > 0]
    assert resumed == [(6, reference_crcs[6])] * 2
    assert _commit_crcs(out)[6] == reference_crcs[6]
    done = DONE.findall(out)
    assert len(done) == 2 and {c for _, _, c in done} == \
        {reference_crcs[24]}
