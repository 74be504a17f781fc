"""The port's checkpoint (``horovod_tpu_torch.checkpoint``) against the
JAX package's protocol (``horovod_tpu/jax/checkpoint.py``), on the CPU.

- 2 gloo ranks run tests/checkpoint_worker.py's checks on the port
  (tests/torch_port_zoo_worker.py ``run_checkpoint``): rank 1 passes a
  path that does not exist and receives rank 0's values; a bf16 leaf
  restored into an f32 template; a namedtuple's non-alphabetical field
  order kept; a model's and an SGD optimizer's state dicts; a root write
  failure and a missing checkpoint raising the named error on both ranks
  within 30 s; a template of another structure refused on both;
- the sharded update's full state (``sharded_state_full``) saved at 2
  ranks and restored there bit for bit, then restored at 4 ranks, sharded
  for them and stepped: the step equals the 2-rank run's (as
  tests/test_checkpoint_sharded.py round-trips sharded parameters);
- one process: save and restore without a process group of more than one
  rank, and the JAX package's own checkpoint of the same tree read back
  by nothing but the port (the formats differ: orbax there, torch.save
  here), so only values are compared.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
import torch_port_zoo_worker as worker
from horovod_tpu_torch import checkpoint

# the 4-rank step after the reshard against the 2-rank one: the gradient
# summed in another order (tests/test_torch_port_zero.py's RESHARD_TOL)
RESHARD_TOL = 1e-6


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return worker.spawn(worker.run_checkpoint,
                        tmp_path_factory.mktemp("ckpt"), size=2)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    save_dir = tmp_path_factory.mktemp("ckpt_save")
    saved = worker.spawn(worker.run_ckpt_save, save_dir, size=2)
    reshard_dir = tmp_path_factory.mktemp("ckpt_reshard")
    shutil.copytree(os.path.join(save_dir, "ckpt"),
                    os.path.join(reshard_dir, "ckpt"))
    four = worker.spawn(worker.run_ckpt_reshard, reshard_dir, size=4)
    return saved, four


def test_restore_gives_every_rank_the_roots_values(two):
    for r, out in enumerate(two):
        got = out["restored"]
        assert torch.equal(got["w"], torch.full((2, 2), 10.0))
        assert got["step"].dtype == torch.int32 and int(got["step"]) == 5
        assert got["mu"].dtype == torch.float32
        assert torch.equal(got["mu"], torch.full((3,), 0.5))
        assert out["counters_type"] == "Counters"
        assert out["counters_fields"] == ("zz_mini", "aa_grad")
        assert [int(c) for c in got["counters"]] == [111, 222]
        assert not out["rank1_path_exists"]
        assert out["saved_to"].endswith(os.path.join("ckpt", "1")) or r == 1


def test_model_and_optimizer_state_dicts_round_trip(two):
    root = two[0]
    for out in two:
        for k, v in root["model_root"].items():
            assert torch.equal(out["model"][k], v), k
        want, got = root["opt_root"], out["opt"]
        assert got["param_groups"] == want["param_groups"]
        for i, st in want["state"].items():
            for k, v in st.items():
                assert torch.equal(got["state"][i][k], v), (i, k)
    # the ranks held different weights before the restore
    assert not torch.equal(two[0]["model_root"]["weight"],
                           two[1]["model_root"]["weight"])


def test_root_failures_raise_the_named_error_on_every_rank(two):
    for out in two:
        save, restore = out["errors"]["save"], out["errors"]["restore"]
        assert save[0] == "CheckpointSaveError" and save[2]
        assert restore[0] == "CheckpointRestoreError" and restore[2]
        assert "root rank 0" in save[1] and "root rank 0" in restore[1]
        assert out["error_seconds"] < 30, out["error_seconds"]
        assert out["mismatch"] and "root rank 0" in out["mismatch"]
    assert "differs from the template" in two[0]["mismatch"]


def test_sharded_full_state_round_trips_at_two_ranks(sharded):
    saved, _ = sharded
    for out in saved:
        tree, back = out["tree"], out["back"]
        full, bfull = tree["full"], back["full"]
        for k, v in tree["params"].items():
            assert torch.equal(back["params"][k], v), k
        for a, b in zip(full["shards"], bfull["shards"]):
            assert torch.equal(a, b)
        for i, st in full["inner"]["state"].items():
            for k, v in st.items():
                assert torch.equal(bfull["inner"]["state"][i][k], v), k
        assert bfull["totals"] == full["totals"]
        assert (bfull["world"], bfull["rank"]) == (-1, -1)
        assert bfull["inner"]["param_groups"] == \
            full["inner"]["param_groups"]


def test_the_restored_full_state_reshards_at_four_ranks(sharded):
    """Restored at 4 ranks (rank 0 reads the 2-rank checkpoint), sharded
    there: each holds its shard_partition slice of the moments, and the
    next step equals the 2-rank run's."""
    saved, four = sharded
    full = saved[0]["tree"]["full"]
    counts, offsets = hvd.shard_partition(101, 4)
    for r, out in enumerate(four):
        sd = out["sd"]
        assert (sd["world"], sd["rank"]) == (4, r)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sd["inner"]["state"][0][key],
                               full["inner"]["state"][0][key][
                                   offsets[r]:offsets[r] + counts[r]])
        for k, v in saved[0]["params_next"].items():
            np.testing.assert_allclose(out["params_next"][k].numpy(),
                                       v.numpy(), rtol=RESHARD_TOL,
                                       atol=RESHARD_TOL, err_msg=k)
        np.testing.assert_allclose(out["loss"], saved[0]["loss"],
                                   rtol=RESHARD_TOL)


def test_one_rank_round_trip_and_the_jax_checkpoint_values(tmp_path):
    """At one rank no flag is broadcast: the root's errors are raised as
    they are named. The JAX package's checkpoint of the same numpy tree
    holds the same values the port restores."""
    import jax.numpy as jnp
    import horovod_tpu as jhvd
    from horovod_tpu.jax import checkpoint as jckpt
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(3, 4).astype(np.float32),
            "b": [rng.randn(5).astype(np.float32), np.int32(7)]}
    jhvd.init()
    jax_tree = {"a": jnp.asarray(tree["a"]),
                "b": [jnp.asarray(tree["b"][0]), jnp.int32(7)]}
    jckpt.save(str(tmp_path / "jax"), jax_tree)
    jback = jckpt.restore(str(tmp_path / "jax"), jax_tree)
    hvd.init(device="cpu")
    try:
        ttree = {"a": torch.from_numpy(tree["a"]),
                 "b": [torch.from_numpy(tree["b"][0]),
                       torch.tensor(7, dtype=torch.int32)]}
        target = checkpoint.save(tmp_path / "port", ttree, step=4)
        assert target == str(tmp_path / "port" / "4")

        def template(a_shape):
            return {"a": torch.zeros(a_shape),
                    "b": [torch.zeros(5), torch.zeros((), dtype=torch.int32)]}
        back = checkpoint.restore(tmp_path / "port", template((3, 4)), step=4)
        np.testing.assert_array_equal(back["a"].numpy(),
                                      np.asarray(jback["a"]))
        np.testing.assert_array_equal(back["b"][0].numpy(),
                                      np.asarray(jback["b"][0]))
        assert int(back["b"][1]) == int(jback["b"][1]) == 7
        with pytest.raises(checkpoint.CheckpointRestoreError,
                           match="failed: .*shape"):
            checkpoint.restore(tmp_path / "port", template((4, 3)), step=4)
        with pytest.raises(checkpoint.CheckpointSaveError):
            checkpoint.save("/proc/nonexistent/unwritable", ttree)
    finally:
        hvd.shutdown()
        jhvd.shutdown()
