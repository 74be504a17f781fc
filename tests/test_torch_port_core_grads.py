"""The negotiated gradient route (ROADMAP A8c2): ``allreduce_gradients``
and ``DistributedOptimizer`` with ``negotiated=True`` send the gradients
through the port's negotiation core, as the reference's host plane does
(``horovod_tpu/jax/__init__.py:380-412``).

On 2 CPU ranks the small test LM's gradients (seeded weights, each rank's
own tokens) go through the core's device op
(``tests/torch_port_core_worker.py grads``, CPU tensors tagged as device
0); the reference's ``horovod_tpu.jax.allreduce_gradients`` averages the
same local gradients on its own core and TCP ring
(``tests/torch_port_core_ref_worker.py``). Both within 1e-6
norm-relative, and against the port's ``torch.distributed`` route.

In process, at one gloo rank: without ``negotiated`` the two entry points
issue the ``torch.distributed`` calls they always did and start no core,
and under ``@elastic.run`` the negotiated route raises its named error.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import async_ops, core
from horovod_tpu_torch.run import util

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(ROOT / "tests" / "torch_port_core_worker.py")
REF_WORKER = str(ROOT / "tests" / "torch_port_core_ref_worker.py")
TIMEOUT_S = 240
NP = 2
TOL = 1e-6  # norm-relative


def _run(cmd, extra_env=None):
    env = util.cpu_worker_env(repo_root=str(ROOT), extra_env=extra_env)
    try:
        proc = subprocess.run(cmd, env=env, cwd=str(ROOT),
                              capture_output=True, text=True,
                              timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        pytest.fail("%s ran past %d s:\n%s" % (cmd[-3:], TIMEOUT_S,
                                               e.stdout))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    """{kind: [rank 0's {name: tensor}, rank 1's]} for the port's local,
    negotiated, direct and optimizer gradients and the reference's."""
    out = tmp_path_factory.mktemp("grads")
    _run([sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(NP),
          sys.executable, WORKER, "grads", str(out), "cpu"])
    _run([sys.executable, "-m", "horovod_tpu.run.run", "-np", str(NP), "--",
          sys.executable, REF_WORKER, str(out)], {"JAX_PLATFORMS": "cpu"})
    found = {kind: [torch.load(out / ("%s_%d.pt" % (kind, r)))
                    for r in range(NP)]
             for kind in ("local", "negotiated", "direct", "optimizer",
                          "overlap")}
    found["reference"] = [
        {k: torch.from_numpy(v) for k, v in
         np.load(out / ("reference_%d.npz" % r)).items()}
        for r in range(NP)]
    return found


def _gap(a, b):
    """Worst ||a - b||_2 / ||b||_2 over the parameters."""
    assert a.keys() == b.keys()
    return max(float((a[k].double() - b[k].double()).norm() /
                     b[k].double().norm().clamp_min(1e-30)) for k in a)


def test_the_ranks_gradients_differ(grads):
    """Each rank's tokens give it its own gradients: the average is not
    any rank's own."""
    assert _gap(grads["local"][0], grads["local"][1]) > 1e-2


@pytest.mark.parametrize("kind", ["negotiated", "optimizer"])
def test_negotiated_gradients_match_the_reference_host_plane(grads, kind):
    for r in range(NP):
        assert _gap(grads[kind][r], grads["reference"][r]) <= TOL, (kind, r)


def test_negotiated_gradients_match_the_direct_route(grads):
    for r in range(NP):
        assert _gap(grads["negotiated"][r], grads["direct"][r]) <= TOL
        want = {k: sum(g[k] for g in grads["local"]) / NP
                for k in grads["local"][0]}
        assert _gap(grads["negotiated"][r], want) <= TOL


def test_optimizer_hooks_equal_allreduce_gradients(grads):
    """The optimizer's buckets, sent from its hooks, give
    ``allreduce_gradients(negotiated=True)``'s gradients bit for bit, on
    every rank the same."""
    for r in range(NP):
        for k, v in grads["negotiated"][r].items():
            assert torch.equal(grads["optimizer"][r][k], v), (r, k)
            assert torch.equal(grads["optimizer"][0][k], v), (r, k)


def test_sync_collectives_overlapping_the_negotiated_backward(grads):
    """The synchronous API on ``init()``'s group, issued while the
    negotiated buckets run on the executor's own group (the worker checks
    each result), leaves the gradients the optimizer's, bit for bit."""
    for r in range(NP):
        for k, v in grads["optimizer"][r].items():
            assert torch.equal(grads["overlap"][r][k], v), (r, k)


@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


def test_no_default_moves(one_rank, monkeypatch):
    """Without ``negotiated``, ``allreduce_gradients`` and
    ``DistributedOptimizer`` issue the ``torch.distributed`` calls of the
    route before the negotiated one existed: one asynchronous
    ``all_reduce`` of a flat buffer a dtype, and one a bucket in bucket
    order, on the world group; the core does not start."""
    import torch.distributed as dist
    calls = []
    real = dist.all_reduce

    def recording(tensor, *args, **kwargs):
        calls.append((tensor.numel(), tensor.dtype,
                      kwargs.get("async_op"), kwargs.get("group")))
        return real(tensor, *args, **kwargs)

    monkeypatch.setattr(dist, "all_reduce", recording)
    starts = core.starts()
    monkeypatch.setenv("HVD_TPU_FUSION_THRESHOLD", "1024")
    model = torch.nn.Sequential(torch.nn.Linear(16, 32),
                                torch.nn.Linear(32, 8))
    model(torch.randn(4, 16)).sum().backward()
    params = list(model.parameters())
    hvd.allreduce_gradients(params)
    world = hvd.process_group()
    assert calls == [(sum(p.numel() for p in params), torch.float32, True,
                      world)]
    calls.clear()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1))
    model(torch.randn(4, 16)).sum().backward()
    opt.synchronize()
    assert len(opt.buckets) > 1
    assert calls == [(sum(p.numel() for p in b), torch.float32, True, world)
                     for b in opt.buckets]
    assert opt.launch_order == list(range(len(opt.buckets)))
    assert core.starts() == starts and async_ops._handle_map == {}


def test_negotiated_under_elastic_run_raises_the_named_error(one_rank):
    from horovod_tpu_torch import elastic
    model = torch.nn.Linear(2, 2)
    model(torch.ones(1, 2)).sum().backward()

    @elastic.run
    def build(state):
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                 lr=0.1), negotiated=True)

    @elastic.run
    def reduce(state):
        hvd.allreduce_gradients(model.parameters(), negotiated=True)

    for fn in (build, reduce):  # nothing is enqueued
        with pytest.raises(hvd.NegotiatedElasticError, match="A8c4"):
            fn(elastic.ElasticState(step=0))
    # outside @elastic.run the negotiated optimizer builds
    starts = core.starts()
    hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                             negotiated=True)
    assert core.starts() == starts
