"""The port's sparse gradient plane against the JAX package's, on the CPU.

One module fixture spawns 4 gloo ranks (tests/torch_port_zoo_worker.py):

- ``allreduce_sparse`` (averaged and summed), ``apply_sparse`` and
  ``densify`` on every rank's (indices, values), with indices repeated
  within and across ranks, against ``horovod_tpu.jax.sparse``'s functions
  under ``shard_map`` over 4 CPU devices (equal row counts: the in-jit
  allgather is tiled); a ragged case (rank r sends r + 1 rows) against
  the concatenation in rank order;
- 3 SkipGram steps on the sparse plane (``make_sparse_step``) and on the
  dense one (``make_dense_step``) from the same tables, each against
  bench.py's ``w2v_make_step`` (sparse and dense) under ``shard_map``, and
  against each other (tests/test_jax_api.py's check).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import torch_port_zoo_worker as worker
from horovod_tpu.jax.sparse import allreduce_sparse, apply_sparse, densify

jax.config.update("jax_default_matmul_precision", "highest")

# tests/test_jax_api.py's limits for the sparse and dense w2v steps
W2V_RTOL, W2V_ATOL = 2e-5, 2e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.spawn(worker.run_sparse, tmp_path_factory.mktemp("sparse"),
                        size=worker.SPARSE_WORLD)


def _mesh():
    return Mesh(np.array(jax.devices("cpu")[:worker.SPARSE_WORLD]), ("dp",))


def _jax_sparse(average):
    idx, vals, param = worker.sparse_inputs()

    def body(i, v, p):
        ai, av = allreduce_sparse(i[0], v[0], average=average,
                                  axis_name="dp")
        return ai, av, apply_sparse(p, ai, av, scale=-0.5), \
            densify(ai, av, worker.V_SPARSE)

    fn = jax.jit(jax.shard_map(body, mesh=_mesh(),
                               in_specs=(P("dp"), P("dp"), P()),
                               out_specs=(P(), P(), P(), P()),
                               check_vma=False))
    return [np.asarray(a) for a in fn(jnp.asarray(idx), jnp.asarray(vals),
                                      jnp.asarray(param))]


@pytest.mark.parametrize("average", [True, False])
def test_allreduce_sparse_apply_and_densify_match_jax(ranks, average):
    ai, av, applied, dense = _jax_sparse(average)
    idx, _, _ = worker.sparse_inputs()
    assert len(set(idx.reshape(-1).tolist())) < idx.size  # repeats
    for out in ranks:
        got = out["avg" if average else "sum"]
        np.testing.assert_array_equal(got["indices"].numpy(), ai)
        np.testing.assert_allclose(got["values"].numpy(), av, rtol=1e-7)
        # repeated rows accumulate (in another order than XLA's scatter)
        np.testing.assert_allclose(got["applied"].numpy(), applied,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["dense"].numpy(), dense, rtol=1e-6,
                                   atol=1e-6)
        if average:
            np.testing.assert_allclose(out["applied_inplace"].numpy(),
                                       applied, rtol=1e-6, atol=1e-6)


def test_ragged_rows_gather_in_rank_order(ranks):
    n = worker.SPARSE_WORLD
    want_i = np.concatenate([np.full(r + 1, r) for r in range(n)])
    want_v = np.concatenate([np.full((r + 1, 2), (r + 1) / n)
                             for r in range(n)])
    for out in ranks:
        np.testing.assert_array_equal(out["ragged"]["indices"].numpy(),
                                      want_i)
        np.testing.assert_allclose(out["ragged"]["values"].numpy(), want_v)


def _jax_w2v(sparse):
    from bench import w2v_make_step
    center, context, neg, tables = worker.w2v_inputs()
    step = w2v_make_step(_mesh(), worker.SPARSE_WORLD, sparse,
                         lr=worker.W2V["lr"], num_iters=worker.W2V["steps"],
                         donate=False)
    out = step(*(jnp.asarray(t) for t in tables), jnp.asarray(center),
               jnp.asarray(context), jnp.asarray(neg))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("sparse", [True, False])
def test_w2v_steps_match_the_jax_steps(ranks, sparse):
    emb, nce_w, nce_b, loss = _jax_w2v(sparse)
    for out in ranks:
        got = out["w2v_sparse" if sparse else "w2v_dense"]
        for name, want in (("emb", emb), ("nce_w", nce_w),
                           ("nce_b", nce_b)):
            np.testing.assert_allclose(got[name].numpy(), want,
                                       rtol=W2V_RTOL, atol=W2V_ATOL,
                                       err_msg=name)
        np.testing.assert_allclose(got["losses"][-1], float(loss),
                                   rtol=W2V_RTOL)


def test_sparse_and_dense_w2v_steps_agree(ranks):
    """After 3 steps from the same tables the two planes hold the same
    tables, on every rank alike; the losses fall."""
    first = ranks[0]["w2v_sparse"]
    for out in ranks:
        s, d = out["w2v_sparse"], out["w2v_dense"]
        for name in ("emb", "nce_w", "nce_b"):
            np.testing.assert_allclose(s[name].numpy(), d[name].numpy(),
                                       rtol=W2V_RTOL, atol=W2V_ATOL,
                                       err_msg=name)
            assert torch.equal(s[name], first[name])
        assert s["losses"][-1] < s["losses"][0]
