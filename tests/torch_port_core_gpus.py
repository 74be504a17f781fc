"""The negotiation core's device op across GPUs: the core worker's
``device`` and ``grads`` modes at N NCCL ranks, one GPU a rank (ROADMAP
A8c2). Needs N cards; ``chip_smoke.py`` needs one and so cannot run NCCL
across ranks.

    python3 tests/torch_port_core_gpus.py [--np 4] [--out DIR]

``device``: every section of ``tests/torch_port_core_worker.py``'s device
mode on CUDA tensors (the collective matrix, the out-of-order enqueue,
the mixed host/GPU, sharded/replicated and compression rejections, the
fusion counters, the groups, ``hvd.shutdown()`` with a handle
outstanding). ``grads``: the small test LM's gradients through
``allreduce_gradients(negotiated=True)``, the direct route,
``DistributedOptimizer(negotiated=True)``'s hooks, and those hooks again
with the synchronous API on ``init()``'s group issued while the buckets
run on the executor's group. Each kind must be the same on every rank;
the negotiated gradients must equal the direct route's bit for bit, the
optimizer's (its buckets fused otherwise, so NCCL sums them in other
chunks) be within 1e-6 norm-relative of them, and the overlapped ones
equal the optimizer's bit for bit. Prints one JSON line and exits 1 if
anything failed. ``--compare DIR`` only compares the gradients a run
wrote to ``DIR/grads`` (no GPU needed).
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(ROOT / "tests" / "torch_port_core_worker.py")
KINDS = ("local", "negotiated", "direct", "optimizer", "overlap")
TOL = 1e-6  # norm-relative, the optimizer's buckets against one a tensor
SECTIONS = ("ops", "fuzz", "mixed_device", "mixed_sharded",
            "mixed_compression", "fusion", "groups", "shutdown")


def _launch(np_, args, timeout):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
         sys.executable, WORKER] + args, cwd=str(ROOT),
        capture_output=True, text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


def _gap(a, b):
    """Worst ||a - b||_2 / ||b||_2 over the parameters."""
    return max(float((a[k].double() - b[k].double()).norm() /
                     b[k].double().norm().clamp_min(1e-30)) for k in a)


def compare(grads_dir, np_):
    """(result, faults) of the gradients in ``grads_dir``."""
    import torch
    grads = {kind: [torch.load(Path(grads_dir) / ("%s_%d.pt" % (kind, r)))
                    for r in range(np_)]
             for kind in KINDS}
    result, bad = {}, []
    for kind in KINDS[1:]:
        same = all(torch.equal(g[k], grads[kind][0][k])
                   for g in grads[kind] for k in g)
        result["%s_same_on_every_rank" % kind] = same
        if not same:
            bad.append("%s differs across ranks" % kind)
    for kind, want in (("negotiated", "direct"), ("overlap", "optimizer")):
        equal = all(torch.equal(grads[kind][r][k], grads[want][r][k])
                    for r in range(np_) for k in grads[want][r])
        result["%s_equal_%s" % (kind, want)] = equal
        if not equal:
            bad.append("%s != %s" % (kind, want))
    mean = {k: sum(g[k].double() for g in grads["local"]) / np_
            for k in grads["local"][0]}
    result["optimizer_gap_negotiated"] = max(
        _gap(grads["optimizer"][r], grads["negotiated"][r])
        for r in range(np_))
    result["negotiated_gap_mean"] = max(
        _gap(grads["negotiated"][r], mean) for r in range(np_))
    if result["optimizer_gap_negotiated"] > TOL:
        bad.append("optimizer %.3g from negotiated"
                   % result["optimizer_gap_negotiated"])
    return result, bad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--np", type=int, default=4)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "gpus"))
    ap.add_argument("--timeout", type=float, default=300)
    ap.add_argument("--compare", metavar="DIR",
                    help="only compare the gradients of DIR/grads")
    args = ap.parse_args()
    if args.compare:
        result, bad = compare(Path(args.compare) / "grads", args.np)
        result.update(np=args.np, ok=not bad)
        print(json.dumps(result), flush=True)
        sys.exit(1 if bad else 0)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < args.np:
        sys.exit("needs %d GPUs" % args.np)
    out = Path(args.out)
    (out / "grads").mkdir(parents=True, exist_ok=True)
    result, bad = {"np": args.np}, []

    proc, seconds = _launch(args.np, ["device"], args.timeout)
    (out / "device.log").write_text(proc.stdout + proc.stderr)
    held = {name: proc.stdout.count("device %s ok" % name)
            for name in SECTIONS}
    result["device"] = dict(rc=proc.returncode, seconds=seconds, held=held)
    if proc.returncode != 0 or any(v != args.np for v in held.values()):
        bad.append("device")

    proc, seconds = _launch(args.np, ["grads", str(out / "grads")],
                            args.timeout)
    (out / "grads.log").write_text(proc.stdout + proc.stderr)
    result["grads"] = dict(rc=proc.returncode, seconds=seconds)
    if proc.returncode != 0:
        bad.append("grads")
    else:
        found, faults = compare(out / "grads", args.np)
        result["grads"].update(found)
        bad += faults
    result["ok"] = not bad
    print(json.dumps(result), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
