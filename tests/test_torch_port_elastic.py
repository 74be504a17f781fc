"""The port's elastic training (``horovod_tpu_torch.elastic``) against the
JAX package's (``horovod_tpu.elastic``), on the CPU.

Pure functions (``plan_spawns``, ``HostManager``'s backoff and blacklist,
the discovery script's parsing, the state's tree order) run on both
packages with the same inputs, drawn by hypothesis from a fixed seed. The
state commits and restores tensors in place (``ElasticState``,
``TorchState``); ``@elastic.run`` rolls back on ``HorovodInternalError``,
which the port's collectives raise for a lost peer's torch.distributed
error and for nothing else. The e2e run mirrors
``test_elastic.py``'s shrink, rollback and regrow with a small torch model
in ``DistributedOptimizer`` on gloo ranks, launched by
``python -m horovod_tpu_torch.run``, and holds the survivors' final
parameters to one process's computation of the same steps, bit for bit.
"""

import collections
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, seed, strategies as st

from horovod_tpu.elastic import discovery as ref_discovery
from horovod_tpu.elastic.state import _tree_flatten as ref_tree_flatten
from horovod_tpu_torch.elastic import discovery, state as state_mod
from horovod_tpu_torch.elastic.discovery import (FixedHosts,
                                                 HostDiscoveryScript,
                                                 HostManager)
from horovod_tpu_torch.elastic.state import ElasticState, TorchState
from horovod_tpu_torch.run import util

ROOT = Path(__file__).resolve().parent.parent
SEED = 20261018


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# Pure functions against the reference

@seed(SEED)
@settings(max_examples=100, deadline=None)
@given(st.dictionaries(st.sampled_from(["a", "b", "c", "d"]),
                       st.integers(0, 4)),
       st.dictionaries(st.sampled_from(["a", "b", "c", "e"]),
                       st.integers(0, 3)),
       st.integers(-1, 8), st.sampled_from(["pack", "spread"]))
def test_plan_spawns_matches_the_reference(available, live, room,
                                           placement):
    assert discovery.plan_spawns(available, live, room, placement) == \
        ref_discovery.plan_spawns(available, live, room, placement)


@seed(SEED)
@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["fail", "success", "release",
                                           "reset", "tick"]),
                          st.sampled_from(["a", "b"]),
                          st.floats(0.0, 50.0)), max_size=25),
       st.floats(1.0, 20.0), st.floats(5.0, 200.0))
def test_host_manager_backoff_matches_the_reference(ops, cooldown,
                                                    max_backoff):
    """The same sequence of failures, successes, releases, resets and
    clock ticks on both HostManagers: the same blacklist deadlines and
    available hosts after every operation."""
    clocks = [_FakeClock(), _FakeClock()]
    mgrs = [cls(FixedHosts({"a": 2, "b": 1}), cooldown=cooldown,
                max_backoff=max_backoff, clock=clock)
            for cls, clock in zip((HostManager, ref_discovery.HostManager),
                                  clocks)]
    for m in mgrs:
        m.refresh()
    for op, host, dt in ops:
        for m, clock in zip(mgrs, clocks):
            if op == "fail":
                m.record_failure(host)
            elif op == "success":
                m.record_success(host, started_at=clock.t - dt)
            elif op == "release":
                m.record_release(host)
            elif op == "reset":
                m.reset()
            else:
                clock.t += dt
        port, ref = mgrs
        for h in ("a", "b"):
            assert port.blacklisted_until(h) == ref.blacklisted_until(h)
            assert port.is_blacklisted(h) == ref.is_blacklisted(h)
        assert port.available_hosts_and_slots() == \
            ref.available_hosts_and_slots()


def test_blacklist_backoff_doubles_and_is_capped():
    clock = _FakeClock()
    mgr = HostManager(FixedHosts({"a": 1}), cooldown=10.0, max_backoff=25.0,
                      clock=clock)
    mgr.refresh()
    mgr.record_failure("a")
    assert mgr.blacklisted_until("a") == pytest.approx(10.0)
    clock.t = 20.0
    mgr.record_failure("a")
    assert mgr.blacklisted_until("a") == pytest.approx(40.0)
    mgr.record_failure("a")
    assert mgr.blacklisted_until("a") == pytest.approx(45.0)  # capped
    assert mgr.available_hosts_and_slots() == {}


def test_host_discovery_script_matches_the_reference(tmp_path):
    flag = tmp_path / "fail"
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\nif [ -e %s ]; then exit 3; fi\n"
                      "echo hosta:4\necho '# comment'\necho hostb\n"
                      "echo bad:x\n" % flag)
    script.chmod(0o755)
    port = HostDiscoveryScript(str(script), default_slots=2)
    ref = ref_discovery.HostDiscoveryScript(str(script), default_slots=2)
    assert port.find_available_hosts_and_slots() == \
        ref.find_available_hosts_and_slots() == {"hosta": 4, "hostb": 2}
    flag.write_text("")  # the script fails: the last host set is kept
    assert port.find_available_hosts_and_slots() == \
        ref.find_available_hosts_and_slots() == {"hosta": 4, "hostb": 2}


def test_fixed_hosts_parses_the_launcher_string():
    assert FixedHosts("a:2,b").find_available_hosts_and_slots() == \
        ref_discovery.FixedHosts("a:2,b").find_available_hosts_and_slots()


def test_tree_flatten_order_matches_the_reference():
    tree = {"b": [np.zeros(1), 2], "a": {"y": 1, "x": 0}, 3: (4, 5)}
    assert [p for p, _ in state_mod._tree_flatten(tree)] == \
        [p for p, _ in ref_tree_flatten(tree)] == \
        [".3.0", ".3.1", ".a.x", ".a.y", ".b.0", ".b.1"]


# ---------------------------------------------------------------------------
# State commit and restore

def test_state_commits_tensors_and_restores_them_in_place():
    w = torch.arange(4.0)
    h = torch.ones(3, dtype=torch.bfloat16)
    state = ElasticState(w=w, step=3, nested={"h": h, "b": [1, 2.5]},
                         arr=np.arange(2.0))
    state.save()
    assert torch.is_tensor(state._committed["w"])
    assert state._committed["nested"]["h"].dtype == torch.bfloat16
    w.add_(100.0)
    h.mul_(3)
    state.step = 9
    state.nested["b"][1] = 7.0
    state.arr[0] = -1.0
    state.restore()
    assert state.w is w and state.nested["h"] is h  # in place
    assert torch.equal(w, torch.arange(4.0))
    assert torch.equal(h, torch.ones(3, dtype=torch.bfloat16))
    assert state.step == 3 and state.nested["b"] == [1, 2.5]
    assert np.array_equal(state.arr, np.arange(2.0))
    # the snapshot is a copy: restoring did not alias it
    w.add_(1.0)
    assert torch.equal(state._committed["w"], torch.arange(4.0))


def test_state_namedtuple_roundtrip_and_restore_without_commit():
    NT = collections.namedtuple("ScaleState", ["mu", "nu"])
    state = ElasticState(opt=NT(mu=torch.zeros(2), nu=torch.ones(2)), step=1)
    state.restore()  # nothing committed: a no-op
    assert state.step == 1
    state.save()
    state.opt = NT(mu=state.opt.mu + 5.0, nu=state.opt.nu * 3.0)
    state.restore()
    assert isinstance(state.opt, NT)
    assert torch.equal(state.opt.mu, torch.zeros(2))
    assert torch.equal(state.opt.nu, torch.ones(2))
    with pytest.raises(ValueError):
        ElasticState(_committed=1)


def _model_and_adam():
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    return model, torch.optim.Adam(model.parameters(), lr=0.1)


def _adam_step(model, opt):
    opt.zero_grad()
    model(torch.ones(4, 3)).pow(2).sum().backward()
    opt.step()


def test_torch_state_restores_the_model_and_optimizer_in_place():
    model, opt = _model_and_adam()
    params = list(model.parameters())
    _adam_step(model, opt)
    state = TorchState(model, opt, step=1)
    state.save()
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    moments = [opt.state[p]["exp_avg"] for p in params]
    expected = [m.clone() for m in moments]
    for _ in range(2):
        _adam_step(model, opt)
    opt.param_groups[0]["lr"] = 0.5
    state.step = 3
    state.restore()
    assert list(model.parameters()) == params  # the same objects
    assert all(torch.equal(v, saved[k])
               for k, v in model.state_dict().items())
    assert [opt.state[p]["exp_avg"] for p in params] == moments  # in place
    assert all(torch.equal(m, e) for m, e in zip(moments, expected))
    assert float(opt.state[params[0]]["step"]) == 1.0
    assert opt.param_groups[0]["lr"] == 0.1 and state.step == 1


def test_torch_state_gives_a_fresh_optimizer_its_state():
    """An optimizer that has not stepped (a fresh process after a durable
    restore) takes the saved state: 'step' on the CPU, the moments on the
    parameters' device in their dtype."""
    model, opt = _model_and_adam()
    _adam_step(model, opt)
    saved = TorchState(model, opt, step=1)
    saved.save()
    fresh_model, fresh_opt = _model_and_adam()
    fresh = TorchState(fresh_model, fresh_opt, step=0)
    for k, v in saved._committed.items():
        fresh._assign(k, v)
    for p, q in zip(model.parameters(), fresh_model.parameters()):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][key], fresh_opt.state[q][key])
        assert fresh_opt.state[q]["step"].device.type == "cpu"
    _adam_step(model, opt)
    _adam_step(fresh_model, fresh_opt)
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 fresh_model.parameters()))


def test_torch_state_refuses_the_sharded_update(one_rank):
    """The sharded update's state is rank-local: TorchState says to commit
    its full form instead of committing the empty wrapped optimizer."""
    model, opt = _model_and_adam()
    sharded = one_rank.DistributedOptimizer(opt, sharded_update=True)
    with pytest.raises(ValueError, match="sharded_state_full"):
        TorchState(model, sharded)


# ---------------------------------------------------------------------------
# @elastic.run at one rank (a real shutdown and re-init of the group)

@pytest.fixture
def one_rank():
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _raising(message):
    def collective(*args, **kwargs):
        raise RuntimeError(message)
    return collective


GLOO_LOST = ("[gloo/transport/tcp/pair.cc:553] Connection closed by peer "
             "[127.0.0.1]:1234")
NCCL_INVALID_USAGE = (
    "NCCL error in: ProcessGroupNCCL.cpp:1970, invalid usage (run with "
    "NCCL_DEBUG=WARN for details), NCCL version 2.21.5")


@pytest.mark.parametrize("error", ["internal", "gloo"])
def test_run_decorator_rolls_back_to_last_commit(one_rank, error,
                                                 monkeypatch):
    """A HorovodInternalError, or gloo's raw error for a lost peer inside
    the port's allreduce, at step 3: the wrapper restores the step-2
    commit, re-initializes (on the CPU, as the first init) and calls the
    function again."""
    import torch.distributed as dist
    from horovod_tpu_torch import HorovodInternalError, elastic
    from horovod_tpu_torch.common import basics
    hvd = one_rank
    state = elastic.ElasticState(w=torch.zeros(2), step=0)
    w = state.w
    attempts, inits = [], []

    def on_init():
        inits.append(hvd.rank())

    hvd.register_init_callback(on_init)

    @elastic.run
    def train(st):
        attempts.append(st.step)
        while st.step < 4:
            st.w.add_(1.0)
            st.step += 1
            if st.step == 2:
                st.commit()
            if st.step == 3 and len(attempts) == 1:
                if error == "internal":
                    raise HorovodInternalError("simulated peer loss")
                monkeypatch.setattr(dist, "all_reduce", _raising(GLOO_LOST))
                try:
                    hvd.allreduce(st.w)
                finally:
                    monkeypatch.undo()
        return st.step

    try:
        assert train(state) == 4
    finally:
        basics._init_callbacks.remove(on_init)
    assert attempts == [0, 2]
    assert state.w is w and torch.equal(w, torch.full((2,), 4.0))
    assert hvd.is_initialized() and hvd.device().type == "cpu"
    assert inits == [0]  # the callback ran at the re-init


def test_run_decorator_does_not_retry_other_errors(one_rank):
    from horovod_tpu_torch import elastic
    state = elastic.ElasticState(step=0)

    @elastic.run
    def train(st):
        raise RuntimeError("shape mismatch in the model")

    with pytest.raises(RuntimeError, match="shape mismatch"):
        train(state)


@pytest.mark.parametrize("where", ["func", "collective"])
def test_run_decorator_does_not_retry_a_deterministic_nccl_error(
        one_rank, where, monkeypatch):
    """NCCL's invalid usage names NCCL but is a bug, not a lost peer: raised
    by the function itself or inside the port's allreduce, it propagates
    from the first attempt, which is not retried."""
    import torch.distributed as dist
    from horovod_tpu_torch import elastic
    hvd = one_rank
    state = elastic.ElasticState(w=torch.zeros(2), step=0)
    attempts = []

    @elastic.run
    def train(st):
        attempts.append(st.step)
        if where == "func":
            raise RuntimeError(NCCL_INVALID_USAGE)
        monkeypatch.setattr(dist, "all_reduce",
                            _raising(NCCL_INVALID_USAGE))
        hvd.allreduce(st.w)

    with pytest.raises(RuntimeError, match="invalid usage") as info:
        train(state)
    assert type(info.value) is RuntimeError
    assert attempts == [0]


def test_peer_loss_maps_torch_distributed_errors():
    import torch.distributed as dist
    from horovod_tpu_torch.common.ops import HorovodInternalError, peer_loss
    for msg in (GLOO_LOST,
                "[gloo/transport/tcp/pair.cc:589] Read error "
                "[10.0.0.2]:41623: Connection reset by peer",
                "[gloo/transport/tcp/unbound_buffer.cc:81] Timed out "
                "waiting 30000ms for recv operation to complete",
                "NCCL error in: ProcessGroupNCCL.cpp:1970, remote process "
                "exited or there was a network error, NCCL version 2.21.5",
                "[Rank 0] Watchdog caught collective operation timeout: "
                "WorkNCCL(SeqNum=7, OpType=ALLREDUCE) ran for 30000 "
                "milliseconds before timing out.",
                "NCCL communicator was aborted on rank 0."):
        assert isinstance(peer_loss(RuntimeError(msg)), HorovodInternalError)
        assert isinstance(peer_loss(dist.DistBackendError(msg)),
                          HorovodInternalError)
    assert isinstance(peer_loss(dist.DistNetworkError("recv failed")),
                      HorovodInternalError)
    for msg in ("size mismatch", NCCL_INVALID_USAGE,
                "NCCL error in: ProcessGroupNCCL.cpp:1970, unhandled cuda "
                "error (run with NCCL_DEBUG=INFO for details)",
                "DataLoader timed out after 5 seconds",
                "socket: too many open files"):
        assert peer_loss(RuntimeError(msg)) is None
        assert peer_loss(dist.DistBackendError(msg)) is None
    assert peer_loss(ValueError("Connection closed by peer")) is None


# ---------------------------------------------------------------------------
# E2E: launcher-driven shrink, rollback and regrow

LINE = re.compile(r"worker (\d+) gen (\d+) step (\d+) size (\d+) "
                  r"loss ([0-9.]+)")
DONE = re.compile(r"worker (\d+) train done step (\d+) loss ([0-9.]+) "
                  r"params (\S+)")


def test_elastic_shrink_rollback_and_regrow():
    """Worker 1 dies at step 7 of generation 0: the survivors roll back to
    the step-5 commit and go on at size 2 (generation 1); after the
    blacklist's backoff the driver spawns a replacement, and a later
    generation runs at size 3 with it, to step 20. Every worker ends on
    the parameters of one process's 20 steps, bit for bit."""
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        import torch_port_elastic_worker as worker
    finally:
        sys.path.remove(str(ROOT / "tests"))
    env = util.cpu_worker_env(repo_root=str(ROOT), extra_env={
        "HVD_TPU_ELASTIC_COOLDOWN": "2",
        "HVD_TPU_ELASTIC_DISCOVERY_INTERVAL": "0.3",
        "HVD_TPU_ELASTIC_CHECK_INTERVAL": "0.1",
        "HVD_TPU_START_TIMEOUT": "30"})
    t0 = time.monotonic()
    result = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "3",
         "--min-np", "1", "--", sys.executable,
         str(ROOT / "tests" / "torch_port_elastic_worker.py")],
        env=env, cwd=str(ROOT), timeout=150, capture_output=True, text=True)
    elapsed = time.monotonic() - t0
    out = result.stdout
    assert result.returncode == 0, (out, result.stderr)
    assert "worker 1 crashing now" in out
    rows = [(int(w), int(g), int(s), int(n), float(l))
            for w, g, s, n, l in LINE.findall(out)]
    gen0 = [r for r in rows if r[1] == 0]
    gen1 = [r for r in rows if r[1] == 1]
    grown = [r for r in rows if r[1] >= 2]
    assert gen0 and gen1 and grown, rows
    # shrink: generation 1 at size 2 resumes from the step-5 commit
    assert all(r[3] == 2 for r in gen1)
    assert min(r[2] for r in gen1) == 6
    assert max(r[2] for r in gen0) >= 7
    # grow: a later generation at size 3 with the replacement worker
    assert any(r[3] == 3 for r in grown)
    assert any(r[0] > 2 for r in grown), "replacement worker not absorbed"
    done = DONE.findall(out)
    assert sorted(int(w) for w, _, _, _ in done) == [0, 2, 3], out
    assert all(int(s) == worker.TOTAL_STEPS for _, s, _, _ in done)
    want = worker.params_hex(worker.run_steps(worker.TOTAL_STEPS))
    assert all(p == want for _, _, _, p in done)
    assert float(done[0][2]) < min(r[4] for r in gen0)
    assert elapsed < 120, "elastic recovery took %.0fs" % elapsed
