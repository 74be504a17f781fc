"""Elastic e2e worker of the port (gloo, CPU): a small torch model trained
through ``DistributedOptimizer`` inside ``@elastic.run`` with a
``TorchState``, under ``python -m horovod_tpu_torch.run -np 3 --min-np 1``
(the port's counterpart of ``tests/elastic_worker.py``).

Worker id 1 kills itself at step CRASH_STEP of generation 0; the survivors
roll back to the last commit and go on at size 2. At step HOLD_STEP they
hold, committing (which polls the driver's generation), until the driver
has respawned a worker and published a generation of size 3 again; the
grown job runs to TOTAL_STEPS.

Every rank computes the same loss on the same data, and the gradients are
rounded to a 1/1024 grid by a tensor hook before DistributedOptimizer's
reduction sees them, so the averaged gradient is exact at any world size
and the trajectory is that of one process (``run_steps``), which the test
computes to compare the final parameters bit for bit.

Imports torch and the port only.
"""

import os
import sys
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic

TOTAL_STEPS = int(os.environ.get("ELASTIC_TEST_TOTAL_STEPS", "20"))
COMMIT_EVERY = int(os.environ.get("ELASTIC_TEST_COMMIT_EVERY", "5"))
CRASH_STEP = int(os.environ.get("ELASTIC_TEST_CRASH_STEP", "7"))
HOLD_STEP = int(os.environ.get("ELASTIC_TEST_HOLD_STEP", "12"))
INITIAL_SIZE = 3
LR = 0.05

WID = os.environ.get("HVD_TPU_WORKER_ID", "?")


def quantize(g):
    return torch.round(g * 1024.0) / 1024.0


def build():
    """The model, its data and the SGD optimizer, the same on every rank."""
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Linear(4, 3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(quantize(torch.randn(p.shape, generator=gen) * 0.5))
    for p in model.parameters():
        p.register_hook(quantize)
    x = quantize(torch.randn(8, 4, generator=gen))
    y = quantize(torch.randn(8, 3, generator=gen))
    return model, x, y, torch.optim.SGD(model.parameters(), lr=LR)


def loss_of(model, x, y):
    return ((model(x) - y) ** 2).mean()


def step(model, x, y, opt):
    opt.zero_grad()
    loss = loss_of(model, x, y)
    loss.backward()
    opt.step()
    return loss.item()


def run_steps(n):
    """The trajectory of one process: n steps, the final parameters."""
    model, x, y, opt = build()
    for _ in range(n):
        step(model, x, y, opt)
    return [p.detach().clone() for p in model.parameters()]


def params_hex(params):
    return ",".join(float(v).hex() for p in params for v in p.reshape(-1))


@elastic.run
def train(state, x, y):
    while state.step < TOTAL_STEPS:
        gen = int(os.environ.get("HVD_TPU_GENERATION", "0") or 0)
        if WID in ("0", "2") and hvd.size() < INITIAL_SIZE and \
                state.step >= HOLD_STEP:
            state.commit()  # raises once the grown generation is out
            time.sleep(0.02)
            continue
        loss = step(state.model, x, y, state.optimizer)
        state.step += 1
        print("worker %s gen %d step %d size %d loss %.6f"
              % (WID, gen, state.step, hvd.size(), loss), flush=True)
        if WID == "1" and gen == 0 and state.step == CRASH_STEP:
            print("worker 1 crashing now", flush=True)
            os._exit(23)
        if state.step % COMMIT_EVERY == 0:
            state.commit()
    with torch.no_grad():
        return loss_of(state.model, x, y).item()


def main():
    hvd.init(device="cpu")
    model, x, y, sgd = build()
    # @elastic.run's state.sync() broadcasts rank 0's model and optimizer
    opt = hvd.DistributedOptimizer(sgd, model.named_parameters())  # hvd-lint: disable=missing-initial-broadcast
    state = elastic.TorchState(model, opt, step=0)
    final_loss = train(state, x, y)
    if final_loss is None:  # the job finished before this worker joined
        print("worker %s superseded (job already complete)" % WID,
              flush=True)
        return 0
    print("worker %s train done step %d loss %.6f params %s"
          % (WID, state.step, final_loss,
             params_hex(model.parameters())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
