"""Fleet e2e worker of the port: the counterpart of ``tests/fleet_worker.py``
(deterministic quadratic training with durable commits), shared by the
fleet's drain-durability, preemption and co-tenancy tests.

Runs under a fleet-controller-owned elastic driver (or plain ``python -m
horovod_tpu_torch.run``). The state is a ``TorchState`` of a module that
holds the float64 vector ``w`` (4 elements, from zero), and the step; the
update is the reference worker's, ``w - 0.05 * mean(2 (w - 3))`` over the
ranks. Every commit prints a CRC32C fingerprint of the state, computed as
the reference worker computes it (``w``'s bytes, then ``step=S``), and the
first line inside ``train()`` prints the state the (re)entry STARTED from,
so tests can assert that a preempted or killed job resumes bit for bit
from a state it committed earlier (the checkpoint-lineage invariant).

It runs on the GPU by default (``hvd.init()``); ``--device cpu`` (or
``FLEET_TEST_DEVICE=cpu``) runs it on gloo, as the CPU tests do. Without a
GPU and without that option ``hvd.init()`` raises
``CudaUnavailableError``.

Knobs (env):
  FLEET_TEST_JOB          job name echoed in every line   (default "?")
  FLEET_TEST_TOTAL_STEPS  total optimization steps        (default 30)
  FLEET_TEST_COMMIT_EVERY commit cadence in steps         (default 1)
  FLEET_TEST_STEP_SLEEP   per-step sleep seconds          (default 0.1)
  FLEET_TEST_DEVICE       the device (default: the GPU)

Imports torch and the port only.
"""

import argparse
import os
import sys
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic
from horovod_tpu_torch.elastic import durable

JOB = os.environ.get("FLEET_TEST_JOB", "?")
TOTAL_STEPS = int(os.environ.get("FLEET_TEST_TOTAL_STEPS", "30"))
COMMIT_EVERY = int(os.environ.get("FLEET_TEST_COMMIT_EVERY", "1"))
STEP_SLEEP = float(os.environ.get("FLEET_TEST_STEP_SLEEP", "0.1"))
LR = 0.05
TARGET = 3.0

WID = os.environ.get("HVD_TPU_WORKER_ID", "?")


class Quadratic(torch.nn.Module):
    def __init__(self, device):
        super().__init__()
        self.w = torch.nn.Parameter(
            torch.zeros(4, dtype=torch.float64, device=device),
            requires_grad=False)


def state_crc(state):
    w = state.model.w.detach().cpu().contiguous()
    crc = durable.crc32c(w)
    return durable.crc32c(("step=%d" % state.step).encode(), crc)


@elastic.run
def train(state):
    w = state.model.w
    print("job %s worker %s start step %d crc %08x size %d"
          % (JOB, WID, state.step, state_crc(state), hvd.size()),
          flush=True)
    while state.step < TOTAL_STEPS:
        grad_local = 2.0 * (w - TARGET)
        grad = hvd.allreduce(grad_local, average=True, name="grad")
        with torch.no_grad():
            w.copy_(w - LR * grad)
        state.step += 1
        if state.step % COMMIT_EVERY == 0:
            # Print BEFORE commit(): commit saves the snapshot first and
            # only then checks for drain/membership interrupts, so the
            # printed crc is exactly the state any rollback, durable
            # force-write, or resume must reproduce — even when commit()
            # raises and the line after it would never run.
            print("job %s worker %s commit step %d crc %08x"
                  % (JOB, WID, state.step, state_crc(state)), flush=True)
            state.commit()
        time.sleep(STEP_SLEEP)
    return float(((w - TARGET) ** 2).sum())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=os.environ.get("FLEET_TEST_DEVICE"),
                    help="cpu for gloo ranks (default: the GPU)")
    args = ap.parse_args(argv)
    hvd.init(device=args.device)
    state = elastic.TorchState(Quadratic(hvd.device()), step=0)
    final_loss = train(state)
    if final_loss is None:  # job finished before this worker could join
        print("job %s worker %s superseded (job already complete)"
              % (JOB, WID), flush=True)
        return 0
    print("job %s worker %s done step %d crc %08x loss %.6f"
          % (JOB, WID, state.step, state_crc(state), final_loss),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
