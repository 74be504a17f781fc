"""The port's data-parallel API on 4 gloo ranks against the JAX package's.

One module fixture spawns 4 ranks once (tests/torch_port_api_worker.py)
under ``init(model_parallel=2)``: a (2, 2) (batch, model) mesh. Each
assertion below is its own test case over what the ranks saved:

- the mesh layout at k = 2, and a group's non-members (``rank() == -1``);
- ``allreduce`` with the codecs and scale factors, over the world and
  over ``batch_group()``, against ``horovod_tpu.jax.allreduce`` in-jit
  under ``shard_map`` on 4 CPU devices (the batch group: the "batch" axis
  of a (2, 2) mesh, whose columns are the port's batch groups);
- ``reduce_scatter`` against JAX's in-jit one where 4 divides the size,
  and against numpy and ``shard_partition`` where it does not;
- ``allgather``, ``broadcast`` (a WORLD root under a group; a dict);
- ``DistributedOptimizer`` over the batch group, three Adam steps,
  against JAX ``DistributedOptimizer(optax.adam)`` under ``shard_map`` on
  the (2, 2) mesh;
- the overlapped reduction against the fused ``allreduce_gradients``: bit
  for bit over 2 ranks; within 1e-6 over 4, where gloo's ring adds each
  element in an order set by its chunk, which the bucket layout moves;
- ``make_train_step(accum_steps=2)``, a parameter without a gradient;
- ``assert_synchronized`` (passing, then ``DivergenceError`` naming the
  rank with an extra call), the digest against a copy of ``FoldCall``
  written here, ``metric_average``.

The worker's own timeout (240 s) keeps a hung rank from eating the
suite's limit.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu.jax as hvd_jax
import horovod_tpu_torch as hvd
import torch_port_api_worker as worker

jax.config.update("jax_default_matmul_precision", "highest")

# The same f32 (or fp16, bf16) arithmetic in another order: the JAX psum
# and gloo add the four values in their own orders.
F32_TOL = 1e-6
NARROW_TOL = {"fp16": 2e-3, "bf16": 2e-2}
# Three Adam steps of the MLP: the same formula, rounded apart (torch
# computes sqrt(v) / sqrt(bias correction), optax sqrt(v / correction)).
OPT_TOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.spawn_api(tmp_path_factory.mktemp("api"))


def _inputs(shape=(3, 5), seed=10):
    return np.stack([worker.rank_input(r, shape, seed)
                     for r in range(worker.WORLD)])


def _mesh_2x2():
    return Mesh(np.array(jax.devices("cpu")[:4]).reshape(2, 2),
                ("batch", "model"))


def _jax_per_rank(fn, x, group):
    """``fn`` on every rank's slice of x ([4, ...]) under shard_map: over a
    1-D mesh for the world, over the "batch" axis of the (2, 2) mesh for the
    batch group; returns [4, ...] in world-rank order."""
    if group == "world":
        mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("hvd",))
        out = jax.jit(jax.shard_map(
            lambda a: fn(a[0], "hvd")[None], mesh=mesh, in_specs=P("hvd"),
            out_specs=P("hvd"), check_vma=False))(x)
        return np.asarray(out)
    grid = x.reshape((2, 2) + x.shape[1:])
    out = jax.jit(jax.shard_map(
        lambda a: fn(a[0, 0], "batch")[None, None], mesh=_mesh_2x2(),
        in_specs=P("batch", "model"), out_specs=P("batch", "model"),
        check_vma=False))(grid)
    return np.asarray(out).reshape(x.shape[:1] + out.shape[2:])


def test_mesh_layout_at_k2(ranks):
    """Batch groups are the strided columns, created first (ids 1, 2);
    model groups the rows of 2 consecutive ranks (ids 3, 4)."""
    for r, out in enumerate(ranks):
        mesh = out["mesh"]
        assert mesh["k"] == 2 and mesh["env"] == "2"
        assert mesh["batch"] == (1 + r % 2, (r % 2, r % 2 + 2), r // 2)
        assert mesh["model"] == (3 + r // 2, (r - r % 2, r - r % 2 + 1),
                                 r % 2)


def test_non_members_rank_is_minus_one(ranks):
    """new_group([0, 2]) and new_group([1, 3]) after the mesh: ids 5 and 6,
    rank() -1 on the ranks outside, each group's sum on its members; a
    collective over the group a rank is not in raises there."""
    x = _inputs()
    for r, out in enumerate(ranks):
        for g, (gid, members, rank, size, member) in enumerate(
                out["pair_groups"]):
            assert (gid, members, size) == (5 + g, (g, g + 2), 2)
            assert member == (r % 2 == g)
            assert rank == (r // 2 if member else -1)
        torch.testing.assert_close(out["allreduce/pair"],
                                   torch.from_numpy(x[r % 2] + x[r % 2 + 2]))
        assert "not a member of ProcessGroup(id=%d" % (6 - r % 2) in \
            out["non_member"]


@pytest.mark.parametrize("group", ["world", "batch"])
@pytest.mark.parametrize("case", sorted(worker.ALLREDUCE_CASES))
def test_allreduce_matches_the_jax_in_jit_plane(ranks, case, group):
    average, codec, pre, post = worker.ALLREDUCE_CASES[case]
    compression = {"none": None, "fp16": hvd_jax.Compression.fp16,
                   "bf16": hvd_jax.Compression.bf16}[codec]
    x = _inputs()
    want = _jax_per_rank(lambda a, axis: hvd_jax.allreduce(
        a, average=average, axis_name=axis, compression=compression,
        prescale_factor=pre, postscale_factor=post), x, group)
    tol = NARROW_TOL.get(codec, F32_TOL)
    for r, out in enumerate(ranks):
        got = out["allreduce/%s/%s" % (case, group)]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want[r], rtol=tol,
                                   atol=tol * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(worker.REDUCE_SCATTER_CASES))
def test_reduce_scatter(ranks, case):
    """Each rank's shard of the sum under shard_partition; for 4 chunks of
    256 also JAX's in-jit reduce_scatter (whose chunks are padded to 256
    elements, where the host plane's are not)."""
    count, group = worker.REDUCE_SCATTER_CASES[case]
    x = _inputs((count,), seed=30)
    members = {r: [q for q in range(4) if q % 2 == r % 2]
               for r in range(4)} if group == "batch" else \
        {r: list(range(4)) for r in range(4)}
    for r, out in enumerate(ranks):
        total = x[members[r]].sum(0)
        counts, offsets = hvd.shard_partition(count, len(members[r]))
        me = members[r].index(r)
        want = total[offsets[me]:offsets[me] + counts[me]]
        assert out["reduce_scatter/" + case].shape == (counts[me],)
        np.testing.assert_allclose(out["reduce_scatter/" + case].numpy(),
                                   want, rtol=F32_TOL, atol=F32_TOL)
    if count % 1024 == 0 and group == "world":
        jax_shards = _jax_per_rank(lambda a, axis: hvd_jax.reduce_scatter(
            a, average=False, axis_name=axis), x, "world")
        for r, out in enumerate(ranks):
            np.testing.assert_allclose(out["reduce_scatter/" + case].numpy(),
                                       jax_shards[r], rtol=F32_TOL,
                                       atol=F32_TOL)


def test_uneven_partition_gives_the_first_ranks_one_more():
    assert hvd.shard_partition(10, 4) == ([3, 3, 2, 2], [0, 3, 6, 8])
    assert hvd.shard_partition(7, 2) == ([4, 3], [0, 4])
    assert hvd.shard_partition(2, 4) == ([1, 1, 0, 0], [0, 1, 2, 2])


def test_allgather_and_broadcast_over_the_model_group(ranks):
    """allgather of uneven rows over each model row; broadcast from the
    row's last member, named by its world rank."""
    x = _inputs()
    for r, out in enumerate(ranks):
        row = [r - r % 2, r - r % 2 + 1]
        want = np.concatenate([x[q][:q % 2 + 1] for q in row])
        np.testing.assert_array_equal(out["allgather/model"].numpy(), want)
        np.testing.assert_array_equal(out["broadcast/model"].numpy(),
                                      x[row[-1]])


def test_broadcast_of_a_dict_keeps_its_structure(ranks):
    x = torch.from_numpy(_inputs()[1])
    for out in ranks:
        tree = out["broadcast/dict"]
        assert list(tree) == ["b", "a"] and isinstance(tree["a"], tuple)
        assert torch.equal(tree["b"], x)
        assert torch.equal(tree["a"][0], x * 2)
        assert torch.equal(tree["a"][1], x[0])


def _jax_distributed_adam():
    """JAX DistributedOptimizer(optax.adam) over the "batch" axis of the
    (2, 2) mesh, three steps on each rank's batch: {param: [4, ...]} in
    world-rank order."""
    opt = hvd_jax.DistributedOptimizer(optax.adam(worker.LR),
                                       axis_name="batch",
                                       sharded_update=False)

    def loss(params, x, y):
        h = jax.nn.relu(x @ params["w1"] + params["b1"])
        return jnp.mean((h @ params["w2"] - y) ** 2)

    def step(params, state, x, y):
        sq = lambda t: jax.tree_util.tree_map(lambda a: a[0, 0], t)
        params, state, x, y = sq(params), sq(state), x[0, 0], y[0, 0]
        updates, state = opt.update(jax.grad(loss)(params, x, y), state,
                                    params)
        params = optax.apply_updates(params, updates)
        ex = lambda t: jax.tree_util.tree_map(lambda a: a[None, None], t)
        return ex(params), ex(state)

    spec = P("batch", "model")
    fn = jax.jit(jax.shard_map(step, mesh=_mesh_2x2(),
                               in_specs=(spec, spec, spec, spec),
                               out_specs=(spec, spec), check_vma=False))
    grid = lambda a: jnp.broadcast_to(a, (2, 2) + a.shape)
    params = {k: grid(jnp.asarray(v)) for k, v in worker.mlp_params().items()}
    state = jax.tree_util.tree_map(grid, opt.init(
        {k: jnp.asarray(v) for k, v in worker.mlp_params().items()}))
    batches = [worker.mlp_batch(r) for r in range(4)]
    x = jnp.asarray(np.stack([b[0] for b in batches]).reshape(2, 2, 4, -1))
    y = jnp.asarray(np.stack([b[1] for b in batches]).reshape(2, 2, 4, -1))
    for _ in range(worker.STEPS):
        params, state = fn(params, state, x, y)
    return {k: np.asarray(v).reshape((4,) + v.shape[2:])
            for k, v in params.items()}


@pytest.mark.parametrize("group", ["explicit", "default"])
def test_distributed_optimizer_over_the_batch_group_matches_jax(ranks, group):
    """group=batch_group(), and group=None (the batch group under the
    mesh): the columns {0, 2} and {1, 3} each train on their own mean
    gradient."""
    want = _jax_distributed_adam()
    for r, out in enumerate(ranks):
        for name, got in out["dopt/" + group].items():
            np.testing.assert_allclose(got.numpy(), want[name][r],
                                       rtol=OPT_TOL, atol=OPT_TOL,
                                       err_msg="%s rank %d" % (name, r))
    assert not np.allclose(want["w1"][0], want["w1"][1])  # columns differ
    np.testing.assert_allclose(want["w1"][0], want["w1"][2], rtol=1e-6)


@pytest.mark.parametrize("group", ["batch", "world"])
def test_overlapped_reduction_equals_the_fused_one(ranks, group):
    """Every bucket went out during the backward, in bucket order; the
    gradients equal allreduce_gradients' on the same local gradients: bit
    for bit over the 2-rank batch group, within 1e-6 over 4 ranks."""
    for out in ranks:
        o = out["overlap/" + group]
        assert o["buckets"] > 3
        assert o["in_backward"] == list(range(o["buckets"]))
        assert o["launch_order"] == o["in_backward"]
        for a, b in zip(o["overlapped"], o["fused"]):
            if group == "batch":
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL)


def test_accumulation_reduces_on_the_last_microbatch_only(ranks):
    """accum_steps=2 makes the same update as accum_steps=1 on the same
    shard, with the same collectives: one a bucket and the loss's."""
    for out in ranks:
        one, two = out["accum/1"], out["accum/2"]
        for acc in (one, two):
            assert acc["calls"] == acc["buckets"] + 1
            assert acc["launch_order"] == list(range(acc["buckets"]))
        torch.testing.assert_close(two["loss"], one["loss"], rtol=F32_TOL,
                                   atol=F32_TOL)
        for name, p in one["params"].items():
            torch.testing.assert_close(two["params"][name], p, rtol=1e-5,
                                       atol=1e-6)


def test_a_parameter_without_a_gradient_is_skipped(ranks):
    """Its bucket never fills in the backward, so no bucket goes out there
    (the later ones wait their turn); synchronize() sends all three in
    order, the parameter keeps no gradient and is not moved, and the rest
    equal the fused reduction bit for bit (2 ranks)."""
    for out in ranks:
        u = out["unused"]
        assert u["buckets"] == [["w2", "unused", "head"], ["b1"], ["w1"]]
        assert u["in_backward"] == [] and u["launch_order"] == [0, 1, 2]
        assert u["grads"][3] is None and u["fused"][3] is None
        assert torch.equal(u["params"]["unused"], torch.ones(3))
        for i, (a, b) in enumerate(zip(u["grads"], u["fused"])):
            if i != 3:
                assert torch.equal(a, b), i


def test_assert_synchronized_names_the_diverged_rank(ranks):
    """Passes while every rank made the same calls; after rank 1 alone
    makes one more, raises on every rank with each rank's row."""
    assert len({out["synchronized"] for out in ranks}) == 1
    for out in ranks:
        msg = out["diverged"]
        assert msg is not None and "diverged" in msg
        seqs = {r: int(msg.split("rank %d: seq=" % r)[1].split()[0])
                for r in range(4)}
        assert seqs[1] == seqs[0] + 1 and seqs[0] == seqs[2] == seqs[3]


def _fold(digest, op, dtype, ndim, name):
    """native/divergence.cc FoldCall."""
    def byte(h, b):
        return ((h ^ b) * 1099511628211) % (1 << 64)
    for b in [op, dtype, ndim] + list(name.encode()) + [0xFF]:
        digest = byte(digest, b)
    return digest


def test_digest_folds_op_dtype_ndim_and_name(ranks):
    """The four named calls folded here with the op and dtype codes of
    native/message.h (allreduce 0 f32 7, allgather 1 int64 5, broadcast 2
    f16 6, reduce_scatter 3)."""
    calls = [(0, 7, 1, "a"), (1, 5, 2, "bc"), (2, 6, 1, "d"),
             (3, 7, 2, "e")]
    for out in ranks:
        seq, digest = out["digest_before"]
        for call in calls:
            digest = _fold(digest, *call)
        assert out["digest_after"] == (seq + 4, digest)
    assert _fold(14695981039346656037, 0, 7, 1, "ab") != \
        _fold(_fold(14695981039346656037, 0, 7, 1, "a"), 0, 7, 1, "b")


def test_metric_average(ranks):
    for out in ranks:
        assert out["metric"] == 1.75 and isinstance(out["metric"], float)
