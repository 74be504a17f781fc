"""Durable-checkpoint e2e worker of the port (gloo, CPU), the counterpart of
``tests/sharded_durable_worker.py`` and ``tests/durable_worker.py``:
deterministic training through ``DistributedOptimizer(Adam,
sharded_update=True)`` with elastic commits, run under
``python -m horovod_tpu_torch.run --min-np 1 --ckpt-dir D``.

The Adam state lives sharded (1/N of the moments a rank); at every commit
it is gathered into its world-size-independent full form
(``sharded_state_full``) so that it rides the durable checkpoint and
re-shards to any world size at generation entry (the optimizer's
``load_state_dict`` takes the full form). The gradients are
``2 (w - 3)`` rounded to a 1/1024 grid, identical on every rank, so the
reduce-scatter's sum and the averaging are exact and the trajectory does
not depend on the world size: ``run_steps`` computes it in one process.

Prints ``worker W start step S crc C size N gen G local L`` when it
enters a generation (L its local rank, the GPU it would take),
``worker W commit step S crc C`` after every commit and ``worker W done
step S crc C`` at the end, C the CRC32C of the parameters, the full
optimizer state and the step.

Knobs (env):
  DURABLE_TEST_TOTAL_STEPS  total optimization steps      (default 24)
  DURABLE_TEST_COMMIT_EVERY commit cadence in steps       (default 2)
  DURABLE_TEST_CRASH_STEP   step at which crashers exit   (-1 = never)
  DURABLE_TEST_CRASH_WIDS   csv of worker ids that crash (generation 0
                            only; they flush the durable writer first)
  DURABLE_TEST_PID_DIR      write pid.<wid> files here
  DURABLE_TEST_HOLD_STEP    after committing this step, wait until the
                            job is killed (-1 = never)
  DURABLE_TEST_STEP_SLEEP   seconds each step sleeps, so that a
                            respawned worker joins mid-run (default 0)

Imports torch and the port only.
"""

import os
import sys
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic
from horovod_tpu_torch.elastic import durable

TOTAL_STEPS = int(os.environ.get("DURABLE_TEST_TOTAL_STEPS", "24"))
COMMIT_EVERY = int(os.environ.get("DURABLE_TEST_COMMIT_EVERY", "2"))
CRASH_STEP = int(os.environ.get("DURABLE_TEST_CRASH_STEP", "-1"))
CRASH_WIDS = set(
    w for w in os.environ.get("DURABLE_TEST_CRASH_WIDS", "").split(",")
    if w)
HOLD_STEP = int(os.environ.get("DURABLE_TEST_HOLD_STEP", "-1"))
STEP_SLEEP = float(os.environ.get("DURABLE_TEST_STEP_SLEEP", "0"))
LR = 0.05
TARGET = 3.0
SHAPES = {"w": (19,), "b": (6,)}  # 25 elements: uneven at 2 and 4 ranks

WID = os.environ.get("HVD_TPU_WORKER_ID", "?")


def initial_params():
    gen = torch.Generator().manual_seed(0)
    return {k: torch.randn(shape, generator=gen) * 0.25
            for k, shape in sorted(SHAPES.items())}


def state_crc(params, opt_full, step):
    """CRC32C over the parameters, the full-form optimizer state's
    tensors and the step: bitwise identity across restarts and world
    sizes."""
    crc = 0
    for k in sorted(params):
        crc = durable.crc32c(params[k].detach().contiguous(), crc)
    if opt_full is not None:
        for st in opt_full["inner"]["state"].values():
            for key in sorted(st):
                if torch.is_tensor(st[key]):
                    crc = durable.crc32c(st[key].contiguous(), crc)
        for t in opt_full["shards"]:
            crc = durable.crc32c(t.contiguous(), crc)
    return durable.crc32c(("step=%d" % step).encode(), crc)


def quantized_grads(params):
    """2 (w - target) rounded to a 1/1024 grid: identical on every rank
    and exactly summable and averageable at world sizes 1, 2 and 4."""
    return {k: torch.round(2.0 * (v.detach() - TARGET) * 1024.0) / 1024.0
            for k, v in params.items()}


def make_optimizer(params, opt_full):
    # every rank starts from the same seeded parameters and @elastic.run's
    # state.sync() broadcasts rank 0's state at every generation entry
    opt = hvd.DistributedOptimizer(  # hvd-lint: disable=missing-initial-broadcast
        torch.optim.Adam([params[k] for k in sorted(params)], lr=LR),
        sharded_update=True)
    if opt_full is not None:
        opt.load_state_dict(opt_full)  # the full form: re-shards
    return opt


def one_step(params, opt):
    for k, g in quantized_grads(params).items():
        params[k].grad = g
    opt.step()


def run_steps(n):
    """The trajectory in this process (at its world size, one when it is
    initialized for the purpose): the CRC after n steps."""
    params = {k: torch.nn.Parameter(v) for k, v in initial_params().items()}
    opt = make_optimizer(params, None)
    for _ in range(n):
        one_step(params, opt)
    return state_crc(params, hvd.sharded_state_full(opt.state_dict()), n)


@elastic.run
def train(state):
    # Generation entry: parameters from the state, the optimizer re-sharded
    # for this rank and world size from the committed full form.
    params = {k: torch.nn.Parameter(v.detach().clone())
              for k, v in state.params.items()}
    opt = make_optimizer(params, state.opt_full)
    gen = int(os.environ.get("HVD_TPU_GENERATION", "0") or 0)
    print("worker %s start step %d crc %08x size %d gen %d local %d"
          % (WID, state.step, state_crc(params, state.opt_full, state.step),
             hvd.size(), gen, hvd.local_rank()), flush=True)
    while state.step < TOTAL_STEPS:
        if STEP_SLEEP:
            time.sleep(STEP_SLEEP)
        one_step(params, opt)
        state.step += 1
        if WID in CRASH_WIDS and gen == 0 and state.step == CRASH_STEP:
            # Drain the writer first, so the last durable commit is
            # deterministic for the restart test's exact-step assertion.
            if state.durable is not None:
                state.durable.flush(timeout=60)
            print("worker %s crashing now" % WID, flush=True)
            os._exit(31)
        if state.step % COMMIT_EVERY == 0:
            state.params = {k: v.detach().clone() for k, v in params.items()}
            # a collective: every rank gathers the full optimizer state
            state.opt_full = hvd.sharded_state_full(opt.state_dict())
            state.commit()
            print("worker %s commit step %d crc %08x"
                  % (WID, state.step, state_crc(state.params, state.opt_full,
                                                state.step)), flush=True)
            if state.step == HOLD_STEP:
                state.durable.flush(timeout=60)
                print("worker %s holding" % WID, flush=True)
                while True:  # until the test kills the job
                    time.sleep(1)
    state.params = {k: v.detach().clone() for k, v in params.items()}
    state.opt_full = hvd.sharded_state_full(opt.state_dict())
    return state_crc(state.params, state.opt_full, state.step)


def main():
    pid_dir = os.environ.get("DURABLE_TEST_PID_DIR")
    if pid_dir:
        with open(os.path.join(pid_dir, "pid.%s" % WID), "w") as f:
            f.write(str(os.getpid()))
    hvd.init(device="cpu")
    state = elastic.ElasticState(params=initial_params(), opt_full=None,
                                 step=0)
    crc = train(state)
    if crc is None:  # the job finished before this worker joined
        print("worker %s superseded (job already complete)" % WID,
              flush=True)
        return 0
    print("worker %s done step %d crc %08x" % (WID, state.step, crc),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
