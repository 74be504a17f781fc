"""The port's sharded weight update against the JAX package's.

One module fixture spawns 4 gloo ranks, then 2
(tests/torch_port_zero_worker.py):

- ``make_train_step(zero1=True)`` on tests/test_zero1.py's problem, 3 Adam
  steps, against ``horovod_tpu.parallel.make_train_step(zero1=True)`` on
  4 CPU devices; each rank's Adam moments hold its ``shard_partition``
  slice of the 101-element flat vector (26, 25, 25, 25); under the int8
  wire 5 steps whose losses stay within 5e-2 of the plain path
  (test_zero1_with_wire_compression_matches_plain), the moments in the
  ring's block-aligned chunks;
- ``sharded_state_full`` and ``sharded_state_shard`` with their guards at
  4 ranks, and the full state loaded at 2 ranks: its shards there, and the
  next step equal to the 4-rank one's; loaded at 2 ranks under the int8
  wire, its shards are the ring's chunks of the same moments;
- ``make_fsdp_train_step`` on tests/test_fsdp.py's problem, 3 Adam steps,
  against JAX's ``make_fsdp_train_step`` on 4 CPU devices; the rule shards
  w1 and w2 (their Adam state is 1/4) and replicates b;
- the world-scope guard under ``init(model_parallel=2)``.

The one-rank cases of the reference's tests/test_sharded_update.py (world-1
parity, params required, the env default, the state_dict round trip, an LR
scheduler, legacy codecs) run in this process on a one-rank gloo group.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu_torch as hvd
import torch_port_zero_worker as worker
from horovod_tpu_torch import compression as port_comp
from horovod_tpu.parallel import (data_parallel_mesh, make_fsdp_train_step,
                                  make_train_step)
from horovod_tpu_torch.parallel import make_train_step as port_train_step

jax.config.update("jax_default_matmul_precision", "highest")

# Three Adam steps: the same formula, rounded apart (torch computes
# sqrt(v) / sqrt(bias correction), optax sqrt(v / correction)), and the
# gradients summed in another order
OPT_TOL = 1e-5
# test_zero1_with_wire_compression_matches_plain: int8's losses against
# the exact path's, relative
INT8_LOSS_TOL = 5e-2
# the same step at 2 ranks and at 4: the gradient summed in another order
RESHARD_TOL = 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.spawn_zero(tmp_path_factory.mktemp("zero"),
                             tmp_path_factory.mktemp("reshard"))


def _mesh():
    return data_parallel_mesh(devices=jax.devices("cpu")[:worker.WORLD])


def _jax_zero1(steps, zero1, compression=None):
    params, x, y = worker.zero1_problem()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    def loss_fn(p, b):
        pred = b["x"] @ p["w"] + p["b"] + jnp.sum(p["scalarish"] ** 2)
        return jnp.mean((pred - b["y"]) ** 2)

    opt = optax.adam(worker.LR)
    step = make_train_step(loss_fn, opt, _mesh(), donate=False, zero1=zero1,
                           compression=compression)
    p, s, b = step.place(params, None if zero1 else opt.init(params), batch)
    losses = []
    for _ in range(steps):
        p, s, loss = step(p, s, b)
        losses.append(float(loss))
    return {k: np.asarray(v) for k, v in p.items()}, losses


def test_zero1_matches_the_jax_zero1_step(ranks):
    four, _ = ranks
    want, want_losses = _jax_zero1(worker.ZERO1_STEPS, zero1=True)
    for out in four:
        res = out["zero1/none"]
        for k, v in want.items():
            np.testing.assert_allclose(res["params"][k].numpy(), v,
                                       rtol=OPT_TOL, atol=OPT_TOL,
                                       err_msg=k)
        np.testing.assert_allclose(res["losses"][:worker.ZERO1_STEPS],
                                   want_losses, rtol=OPT_TOL)
        for k in want:
            assert torch.equal(res["params"][k], four[0]["zero1/none"][
                "params"][k])


def test_zero1_state_is_sharded(ranks):
    """Each rank's Adam moments are its shard_partition slice of the flat
    101 elements (13 x 7 + 7 + 3): 1/4, the first rank one longer; under
    the int8 wire the ring's 256-element chunk."""
    four, _ = ranks
    counts, _ = hvd.shard_partition(101, worker.WORLD)
    assert counts == [26, 25, 25, 25]
    for r, out in enumerate(four):
        res = out["zero1/none"]
        assert res["layout"] == "partition"
        assert res["moments"] == [(counts[r],)] * 2
        # 2 moments of f32 and the step count
        assert res["opt_state_bytes"] == 2 * 4 * counts[r] + 4
        res = out["zero1/int8"]
        assert res["layout"] == "ring" and res["moments"] == [(256,)] * 2


def test_zero1_with_the_int8_wire_follows_the_plain_path(ranks):
    four, _ = ranks
    _, plain = _jax_zero1(worker.INT8_STEPS, zero1=False)
    for out in four:
        np.testing.assert_allclose(out["zero1/plain"]["losses"], plain,
                                   rtol=OPT_TOL)
        losses = np.asarray(out["zero1/int8"]["losses"])
        rel = np.abs(losses - plain) / (np.abs(plain) + 1e-8)
        assert rel.max() < INT8_LOSS_TOL, (losses, plain)
        assert out["zero1/int8"]["losses"] == four[0]["zero1/int8"]["losses"]


def test_sharded_state_full_and_its_guards(ranks):
    four, _ = ranks
    full = four[0]["zero1/none"]["full"]
    assert full["world"] == -1 and full["rank"] == -1
    # the full form is free of the layout it was saved in
    assert full["totals"] == [101] and "layout" not in full
    counts, offsets = hvd.shard_partition(101, worker.WORLD)
    for r, out in enumerate(four):
        res = out["zero1/none"]
        assert res["full_is_idempotent"] and res["shard_passes_through"]
        # every rank gathers the same full state; its slices are the shards
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(res["full"]["inner"]["state"][0][key],
                               full["inner"]["state"][0][key])
            mine = full["inner"]["state"][0][key][
                offsets[r]:offsets[r] + counts[r]]
            assert torch.equal(res["sd"]["inner"]["state"][0][key], mine)
            assert torch.equal(res["back"]["inner"]["state"][0][key], mine)
        assert torch.equal(res["back"]["shards"][0], res["sd"]["shards"][0])
        assert res["shard_foreign"][0] == "ValueError"
        assert "rank 3 of 7" in res["shard_foreign"][1]
        assert res["full_foreign"][0] == "RuntimeError"
        assert "rank 3 of 7" in res["full_foreign"][1]
        assert "rank 3 of 7" in res["load_foreign"]
    # the full parameter vector is the model's flattened parameters
    params = four[0]["zero1/none"]["params"]
    flat = torch.cat([params[k].reshape(-1) for k in ("w", "b",
                                                      "scalarish")])
    assert torch.equal(full["shards"][0], flat)


def test_the_full_state_reshards_at_two_ranks(ranks):
    """Loaded at 2 ranks, each holds its shard_partition(101, 2) slice of
    the full moments, and the next step equals the 4-rank run's."""
    four, two = ranks
    full = four[0]["zero1/none"]["full"]
    counts, offsets = hvd.shard_partition(101, 2)
    for r, out in enumerate(two):
        sd = out["sd"]
        assert (sd["world"], sd["rank"]) == (2, r)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sd["inner"]["state"][0][key],
                               full["inner"]["state"][0][key][
                                   offsets[r]:offsets[r] + counts[r]])
        for k, v in four[0]["zero1/none"]["params_last"].items():
            np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(),
                                       rtol=RESHARD_TOL, atol=RESHARD_TOL,
                                       err_msg=k)


def test_a_full_state_saved_in_mode_none_restores_under_int8(ranks):
    """The full form saved by the 4-rank mode-none run, loaded at 2 ranks
    by a sharded optimizer under the int8 wire: each rank holds its
    256-element ring chunk of the full moments and parameters (rank 0 the
    101 elements and zeros, rank 1 zeros), and its step starts from the
    same parameters as mode none's, so the losses agree."""
    four, two = ranks
    full = four[0]["zero1/none"]["full"]
    c = port_comp.chunk_length(101, 2)
    assert c == 256
    for r, out in enumerate(two):
        sd8 = out["sd8"]
        assert sd8["layout"] == "ring" and (sd8["world"], sd8["rank"]) == (
            2, r)
        for key, want in (
                ("exp_avg", full["inner"]["state"][0]["exp_avg"]),
                ("exp_avg_sq", full["inner"]["state"][0]["exp_avg_sq"]),
                (None, full["shards"][0])):
            padded = torch.zeros(2 * c)
            padded[:101] = want
            got = (sd8["inner"]["state"][0][key] if key else
                   sd8["shards"][0])
            assert torch.equal(got, padded[r * c:(r + 1) * c]), key
        np.testing.assert_allclose(out["loss8"], out["loss"], rtol=OPT_TOL)
        for v in out["params8"].values():
            assert torch.isfinite(v).all()


def _jax_fsdp():
    params, x, y = worker.fsdp_problem()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    def loss_fn(p, b):
        h = jnp.tanh(b["x"] @ p["w1"])
        return jnp.mean((h @ p["w2"] + p["b"] - b["y"]) ** 2)

    step = make_fsdp_train_step(loss_fn, optax.adam(worker.LR), _mesh(),
                                donate=False, min_size=worker.FSDP_MIN_SIZE)
    p, s, b = step.place(params, batch=batch)
    losses = []
    for _ in range(worker.ZERO1_STEPS):
        p, s, loss = step(p, s, b)
        losses.append(float(loss))
    return {k: np.asarray(v) for k, v in p.items()}, losses


def test_fsdp_matches_the_jax_fsdp_step(ranks):
    four, _ = ranks
    want, want_losses = _jax_fsdp()
    for out in four:
        res = out["fsdp"]
        np.testing.assert_allclose(res["losses"], want_losses, rtol=OPT_TOL)
        for k, v in want.items():
            np.testing.assert_allclose(res["params"][k].numpy(), v,
                                       rtol=OPT_TOL, atol=OPT_TOL,
                                       err_msg=k)


def test_fsdp_shards_what_the_rule_picks(ranks):
    """w1 (16 x 64) and w2 (64 x 16) have dim 0 divisible by 4 and at least
    min_size = 64 elements: held as dim-0 shards, with Adam state of 1/4;
    b (16 elements) is replicated."""
    four, _ = ranks
    for out in four:
        res = out["fsdp"]
        assert res["sharded"] == ["w1", "w2"]
        assert sorted(res["names"]) == [
            "b", "parametrizations.w1.original",
            "parametrizations.w2.original"]
        assert res["state"] == {"b": (16,),
                                "parametrizations.w1.original": (4, 64),
                                "parametrizations.w2.original": (16, 16)}
        assert res["opt_state_bytes"] == 2 * 4 * (16 + 256 + 256) + 3 * 4


def test_the_sharded_update_is_world_scoped(ranks):
    four, _ = ranks
    for out in four:
        for key in ("group", "mesh_new", "mesh_step"):
            assert "composes with the world group only" in \
                out["scope"][key], key


# ------------------------------------------------------- one rank


@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _grads(model, step):
    g = np.random.RandomState(step)
    for p in model.parameters():
        p.grad = torch.from_numpy(g.randn(*p.shape).astype(np.float32))


def test_sharded_optimizer_world1_matches_the_replicated(one_rank):
    runs = []
    for sharded in (False, True):
        torch.manual_seed(3)
        model = torch.nn.Linear(4, 3)
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2),
            model.named_parameters(), sharded_update=sharded)
        assert isinstance(opt, hvd.ShardedDistributedOptimizer) == sharded
        for step in range(3):
            _grads(model, step)
            opt.step()
        runs.append((model, opt))
    for a, b in zip(runs[0][0].parameters(), runs[1][0].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
    sd = runs[1][1].state_dict()
    full = hvd.sharded_state_full(sd)
    back = hvd.sharded_state_shard(full)
    for key in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(back["inner"]["state"][0][key],
                           sd["inner"]["state"][0][key])


def test_sharded_update_requires_params(one_rank):
    frozen = torch.nn.Linear(2, 2).requires_grad_(False)
    with pytest.raises(ValueError, match="params"):
        hvd.DistributedOptimizer(torch.optim.SGD(frozen.parameters(),
                                                 lr=0.1),
                                 sharded_update=True)


def test_env_default_engages_the_sharded_update(one_rank, monkeypatch):
    model = torch.nn.Linear(2, 2)
    for value, sharded in (("1", True), ("0", False), ("2", True),
                           ("no", False)):
        monkeypatch.setenv("HVD_TPU_SHARDED_UPDATE", value)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        assert isinstance(opt, hvd.ShardedDistributedOptimizer) == sharded
    # an explicit argument wins over the env
    assert not isinstance(hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), sharded_update=False),
        hvd.ShardedDistributedOptimizer)


def test_sharded_state_dict_roundtrip(one_rank):
    def build():
        torch.manual_seed(7)
        model = torch.nn.Linear(5, 3)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            model.named_parameters(), sharded_update=True)
        return model, opt

    model1, opt1 = build()
    _grads(model1, 0)
    opt1.step()
    saved = opt1.state_dict()
    model2, opt2 = build()
    _grads(model2, 0)
    opt2.step()
    opt2.load_state_dict(saved)
    for model, opt in ((model1, opt1), (model2, opt2)):
        _grads(model, 1)
        opt.step()
    for a, b in zip(model1.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="sharded"):
        opt2.load_state_dict({"state": {}, "param_groups": []})
    with pytest.raises(RuntimeError, match="rank 2 of 4"):
        opt2.load_state_dict(dict(saved, world=4, rank=2))


def test_the_full_form_restores_under_another_wire_mode(one_rank):
    """A state saved under int8 (layout "ring") goes through the full form
    into an optimizer in mode none (layout "partition"), and back; at one
    rank the ring applies no codec, so the next steps agree bit for bit. A
    sharded state in the other layout is refused."""
    def build(compression):
        torch.manual_seed(5)
        model = torch.nn.Linear(6, 4)
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2),
            sharded_update=True, compression=compression)
        return model, opt

    for saved_in, loaded_in in (("int8", "none"), ("none", "int8")):
        src_model, src = build(saved_in)
        _grads(src_model, 0)
        src.step()
        full = hvd.sharded_state_full(src.state_dict())
        dst_model, dst = build(loaded_in)
        assert dst.layout != src.layout
        with pytest.raises(ValueError, match="layout"):
            dst.load_state_dict(src.state_dict())
        dst.load_state_dict(full)
        with torch.no_grad():
            for a, b in zip(dst_model.parameters(), src_model.parameters()):
                a.copy_(b)
        for model, opt in ((src_model, src), (dst_model, dst)):
            _grads(model, 1)
            opt.step()
        for a, b in zip(src_model.parameters(), dst_model.parameters()):
            assert torch.equal(a, b), (saved_in, loaded_in)


def test_sharded_lr_scheduler_propagates(one_rank):
    def run(sharded):
        torch.manual_seed(3)
        model = torch.nn.Linear(4, 2)
        sgd = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        opt = hvd.DistributedOptimizer(sgd, model.named_parameters(),
                                       sharded_update=sharded)
        sched = torch.optim.lr_scheduler.StepLR(sgd, step_size=2, gamma=0.1)
        for i in range(5):
            _grads(model, 11 + i)
            opt.step()
            sched.step()
        return model, opt

    m_rep, _ = run(False)
    m_shd, o_shd = run(True)
    assert o_shd.param_groups[0]["lr"] == pytest.approx(
        o_shd.inner.param_groups[0]["lr"])
    assert o_shd.param_groups[0]["lr"] < 0.1
    for a, b in zip(m_rep.parameters(), m_shd.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6)


def test_sharded_update_rejects_legacy_codecs_and_agc(one_rank):
    model = torch.nn.Linear(3, 2)

    def sgd():
        return torch.optim.SGD(model.parameters(), lr=0.1)

    with pytest.raises(ValueError, match="wire compression"):
        hvd.DistributedOptimizer(sgd(), sharded_update=True,
                                 compression=hvd.Compression.fp16)
    opt = hvd.DistributedOptimizer(sgd(), sharded_update=True,
                                   compression=hvd.Compression.none)
    assert opt.layout == "partition"
    with pytest.raises(ValueError, match="agc"):
        hvd.DistributedOptimizer(sgd(), sharded_update=True, agc=0.01)
    with pytest.raises(ValueError, match="legacy"):
        port_train_step(model, lambda m, b: m(b).sum(), sgd(), device="cpu",
                        zero1=True, compression=hvd.Compression.fp16)
    with pytest.raises(ValueError, match="agc"):
        port_train_step(model, lambda m, b: m(b).sum(), sgd(), device="cpu",
                        zero1=True, agc=0.01)
    step = port_train_step(model, lambda m, b: m(b).sum(), sgd(),
                           device="cpu", zero1=True,
                           compression=hvd.Compression.none)
    assert isinstance(step.optimizer, hvd.ShardedDistributedOptimizer)
    with pytest.raises(ValueError, match="sharded update"):
        port_train_step(model, lambda m, b: m(b).sum(),
                        hvd.DistributedOptimizer(sgd()), device="cpu",
                        zero1=True)
