"""The worker of chip_smoke.py's ``launch`` phase: the train phase's LM
started by the port's launcher, on the card.

    python -m horovod_tpu_torch.run -np 1 -H localhost:1 \\
        python tests/torch_port_launch_worker.py --steps 6 --out DIR
    python -m horovod_tpu_torch.run -np 1 --min-np 1 --max-np 1 \\
        --ckpt-dir CKPT --restart-from-ckpt -H localhost:1 \\
        python tests/torch_port_launch_worker.py --steps 6 --out DIR \\
        --kill-after 3

It asserts that the launcher started it and that ``hvd.init()`` (on the
GPU) read no ``MASTER_ADDR``, builds the GPT-2-small flash LM of the train
phase from seed 0 with its batch of 8 x 2048 tokens from seed 1, Adam 1e-4
in the overlapped ``DistributedOptimizer``, and trains to ``--steps`` inside
``@elastic.run`` with a ``TorchState(model, optimizer, step=0)`` that it
commits every step (durably every commit under ``--ckpt-dir``). Every step
must launch K1, K2 and K3 12 times each. With ``--kill-after N`` a process
that started at step 0 waits, after step N's commit, until the durable
writer has published step N's manifest, and kills itself with SIGKILL; the
elastic driver restarts the job, and the new process resumes at step N
from the checkpoint's CRC-checked shards.

Under the fleet controller (chip_smoke.py's ``fleet`` phase) it runs as a
job: ``--job NAME`` prints ``job NAME worker W start step S crc C size N
pid P`` when it enters training, ``job NAME worker W commit step S crc C``
before every commit and ``job NAME worker W done step S crc C`` at the end,
the lines of ``tests/torch_port_fleet_worker.py``, C the CRC32C of the
state (``state_crc``); with ``--hold-after N`` a process that started at
step 0 waits, after step N's commit, until a drain request covering it is
published (the preemption then lands at one of the next commits, strictly
inside the run), and fails after ``HOLD_TIMEOUT_S``. A drained process
prints its report (``drained``: true) before it exits ``EXIT_DRAINED``.

With ``--profile-step N`` step N runs under torch.profiler (its kernels'
device time beside its wall time). Each process prints one line
``LAUNCH_REPORT {json}`` (before it kills itself, or at its end: the step,
commit and host enqueue times, their medians over the warm steps (not the
process's first, nor the profiled one), the profiled step, the launch counts, the
durable writer's times with each shard's split into staging, pickling,
CRC, writing and fsync, and the peak device memory) and the one that finishes saves the parameters and
Adam's moments to ``DIR/final.pt``.

Imports torch and the port only.
"""

import argparse
import json
import os
import signal
import statistics
import struct
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic
from horovod_tpu_torch.elastic import durable
from horovod_tpu_torch.elastic.state import EXIT_DRAINED
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.ops.flash_attention import (launch_counts,
                                                   reset_launch_counts)
from horovod_tpu_torch.parallel import lm_loss, make_train_step

# chip_smoke.py's MODEL and BATCH: bench.py --model transformer
MODEL = dict(vocab_size=32000, num_layers=12, num_heads=12, embed_dim=768,
             mlp_dim=3072)
BATCH = (8, 2048)
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
HOLD_TIMEOUT_S = 300  # --hold-after's wait for a drain request

WID = os.environ.get("HVD_TPU_WORKER_ID", "?")


def report(**fields):
    print("LAUNCH_REPORT " + json.dumps(fields), flush=True)


def median(values):
    values = list(values)
    return statistics.median(values) if values else None


_HOST = {}  # the pinned host buffer state_crc copies into, by size


def state_crc(model, opt, step):
    """CRC32C of the state a commit saves: the CRC32C of each parameter
    and of each of its Adam moments (copied into one reused pinned host
    buffer, the CRCs in a pool of threads), then the CRC32C of those CRCs
    in order, chained with ``step=S adam=...`` (Adam's step counts)."""
    inner = opt.optimizer
    tensors, adam = [], []
    for _, p in model.named_parameters():
        tensors.append(p)
        st = inner.state.get(p, {})
        tensors += [st[k] for k in ("exp_avg", "exp_avg_sq") if k in st]
        if "step" in st:
            adam.append(float(st["step"]))
    flat = [t.detach().contiguous().view(-1).view(torch.uint8)
            for t in tensors]
    total = sum(f.numel() for f in flat)
    if total not in _HOST:
        _HOST.clear()
        _HOST[total] = torch.empty(total, dtype=torch.uint8,
                                   pin_memory=torch.cuda.is_available())
    buf, host, off = _HOST[total], [], 0
    for f in flat:
        host.append(buf[off:off + f.numel()])
        host[-1].copy_(f, non_blocking=True)
        off += f.numel()
    torch.cuda.synchronize()
    with ThreadPoolExecutor(8) as pool:
        crcs = list(pool.map(durable.crc32c, host))
    crc = durable.crc32c(struct.pack("<%dI" % len(crcs), *crcs))
    return durable.crc32c(("step=%d adam=%s" % (step, sorted(set(adam)))
                           ).encode(), crc)


def profiled_step(step, tokens):
    """One step under torch.profiler: (loss, {wall_ms, kernel_ms: the
    device's kernel time, copy_ms: its copies and sets (the durable
    writer's staging included), launch_ms: the host's time in
    cudaLaunchKernel, and the count of those calls})."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = step(tokens).item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = dict(wall_ms=wall_ms, kernel_ms=0.0, copy_ms=0.0, launch_ms=0.0,
               launches=0)
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and str(e.device_type).endswith("CUDA") and \
                not getattr(e, "is_user_annotation", False):
            copy = "memcpy" in e.key.lower() or "memset" in e.key.lower()
            out["copy_ms" if copy else "kernel_ms"] += dev_us / 1e3
        elif e.key == "cudaLaunchKernel":
            out["launch_ms"] += e.cpu_time_total / 1e3
            out["launches"] += e.count
    return loss, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", required=True)
    ap.add_argument("--kill-after", type=int, default=-1)
    ap.add_argument("--profile-step", type=int, default=-1,
                    help="run this step under torch.profiler")
    ap.add_argument("--job", help="print the fleet's lineage lines under "
                    "this job name")
    ap.add_argument("--hold-after", type=int, default=-1,
                    help="after this step's commit wait for a drain request")
    args = ap.parse_args()
    assert "HVD_TPU_RANK" in os.environ or (
        os.environ.get("HVD_TPU_ELASTIC") == "1" and
        "HVD_TPU_WORKER_ID" in os.environ), "not started by the launcher"
    assert "MASTER_ADDR" not in os.environ, os.environ["MASTER_ADDR"]
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    assert "MASTER_ADDR" not in os.environ
    dev = hvd.device()

    cfg = TransformerConfig(attention="flash", dtype=torch.bfloat16,
                            max_seq_len=8192, **MODEL)
    B, L = BATCH
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, L), device=dev,
                           generator=torch.Generator(device=dev
                                                     ).manual_seed(1))
    # @elastic.run's state.sync() broadcasts rank 0's model and optimizer
    opt = hvd.DistributedOptimizer(  # hvd-lint: disable=missing-initial-broadcast
        torch.optim.Adam(model.parameters(), lr=1e-4),
        model.named_parameters())
    step = make_train_step(model, lm_loss, opt)
    state = elastic.TorchState(model, opt, step=0)
    if os.environ.get("HVD_TPU_CKPT_DIR"):
        state.enable_durable(every_n_commits=1)
    log = dict(start_step=None, steps=[], losses=[], step_ms=[],
               commit_ms=[], enqueue_ms=[], crc_ms=[],
               launches={n: 0 for n in FLASH}, bad_launches=[], profile=None,
               held_s=None)

    def lineage(what, step, extra=""):
        """One of the fleet's lineage lines (with ``--job``)."""
        print("job %s worker %s %s step %d crc %08x%s" % (
            args.job, WID, what, step, state_crc(model, opt, step), extra),
            flush=True)

    @elastic.run
    def train(state):
        log["start_step"] = state.step
        if args.job:
            lineage("start", state.step, " size %d pid %d" % (
                hvd.size(), os.getpid()))
        while state.step < args.steps:
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if state.step == args.profile_step:
                loss, log["profile"] = profiled_step(step, tokens)
                t_enqueued = t0
            else:
                out = step(tokens)
                t_enqueued = time.perf_counter()
                loss = out.item()
            t1 = time.perf_counter()
            counts = launch_counts()
            for name in FLASH:
                log["launches"][name] += counts[name]
                if counts[name] != cfg.num_layers:
                    log["bad_launches"].append((state.step, name,
                                                counts[name]))
            state.step += 1
            log["steps"].append(state.step - 1)
            log["losses"].append(loss)
            log["step_ms"].append((t1 - t0) * 1e3)
            log["enqueue_ms"].append((t_enqueued - t0) * 1e3)
            if args.job:
                # before commit(): the drain that a commit may raise lands
                # on exactly this state
                lineage("commit", state.step)
                t_crc, t1 = t1, time.perf_counter()
                log["crc_ms"].append((t1 - t_crc) * 1e3)
            state.commit()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            log["commit_ms"].append((t2 - t1) * 1e3)
            if state.step == args.hold_after and log["start_step"] == 0:
                from horovod_tpu_torch.elastic.run import drain_requested
                print("worker %s holding after step %d until a drain "
                      "request" % (WID, state.step), flush=True)
                t_hold = time.perf_counter()
                while not drain_requested():
                    if time.perf_counter() - t_hold > HOLD_TIMEOUT_S:
                        raise RuntimeError(
                            "no drain request within %d s of step %d" %
                            (HOLD_TIMEOUT_S, state.step))
                    time.sleep(0.05)
                log["held_s"] = time.perf_counter() - t_hold
            if state.step == args.kill_after and log["start_step"] == 0:
                assert state.durable.flush(timeout=600)
                manifest, _ = durable.latest_valid_manifest(
                    state.durable.directory, deep=False)
                assert manifest["step"] == state.step, manifest
                finish(state, killed=True)
                os.kill(os.getpid(), signal.SIGKILL)

    def finish(state, killed=False, drained=False):
        m = durable.METRICS
        # warm steps: not the process's first, nor the profiled one
        warm = [i for i, n in enumerate(log["steps"])
                if i > 0 and n != args.profile_step]
        report(killed=killed, drained=drained, start_step=log["start_step"],
               step=state.step, held_s=log["held_s"], crc_ms=log["crc_ms"],
               pid=os.getpid(),
               device=str(dev), gpu=torch.cuda.get_device_name(dev),
               launches=log["launches"], bad_launches=log["bad_launches"],
               losses=log["losses"], step_ms=log["step_ms"],
               commit_ms=log["commit_ms"], enqueue_ms=log["enqueue_ms"],
               profile=log["profile"],
               steps=log["steps"],
               median_step_ms=median(log["step_ms"][i] for i in warm),
               median_commit_ms=median(log["commit_ms"][i] for i in warm
                                       if i < len(log["commit_ms"])),
               restores=m["restores"], durable_writes=m["writes"],
               durable_bytes=m["bytes"],
               write_s=m["write_seconds"], crc_s=m["crc_seconds"],
               crc_bytes=m["crc_bytes"], shards=m["shards"],
               peak_device_bytes=torch.cuda.max_memory_allocated(dev),
               params=sum(p.numel() for p in model.parameters()))

    try:
        train(state)
    except SystemExit as e:  # @elastic.run's exit after a drain
        if e.code == EXIT_DRAINED:
            finish(state, drained=True)
        raise
    finish(state)
    if args.job:
        lineage("done", state.step)
    inner = opt.optimizer
    params = dict(model.named_parameters())
    torch.save({
        "step": state.step,
        "params": {n: p.detach().cpu() for n, p in params.items()},
        "exp_avg": {n: inner.state[p]["exp_avg"].cpu()
                    for n, p in params.items()},
        "exp_avg_sq": {n: inner.state[p]["exp_avg_sq"].cpu()
                       for n, p in params.items()},
        "adam_step": {n: float(inner.state[p]["step"])
                      for n, p in params.items()},
    }, os.path.join(args.out, "final.pt"))
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
