#!/usr/bin/env python3
"""Measures how many requests a second serve replicas of the port carry on
one GPU, under the load of ``chip_smoke.py``'s serve phase.

    python3 tests/torch_port_serve_capacity.py

Starts replicas of ``python -m horovod_tpu_torch.serve.replica`` on the
GPU over a lineage at step 10 (no supervisor: fixed worker ids and
ports) and drives each configuration below for 3 s at each rate with
``chip_smoke``'s open-loop load (4 processes, one schedule, every answer
checked). Prints one ``CAPACITY {...}`` JSON line a rate: offered, sent
and achieved rps, p50 and p99 from the scheduled time, and the CPU cores
each replica and the load used (from ``/proc/<pid>/stat``); a rate the
replicas could not answer at 0.9 of offered is printed with
``"kept_up": false``. Then the card's name and power limit.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# (model, dim, replicas, rates): the step's mlp on one and on two
# replicas, and the curve's affine model on one
CONFIGS = (("mlp", 2048, 1, (150, 200, 250, 300)),
           ("mlp", 2048, 2, (280, 400)),
           ("affine", 16, 1, (200, 400)))
SECONDS = 3.0


def _cpu_seconds(pids):
    tick = os.sysconf("SC_CLK_TCK")
    out = []
    for pid in pids:
        stat = Path("/proc/%d/stat" % pid).read_text()
        fields = stat.rsplit(")", 1)[1].split()
        out.append((int(fields[11]) + int(fields[12])) / tick)
    return out


def run(model, dim, replicas, rates, load, tmp):
    from horovod_tpu_torch.serve import model as smodel
    from horovod_tpu_torch.serve.swap import publish_leaves
    leaves = smodel.init_leaves(model, dim, seed=1)
    crc = smodel.fingerprint(leaves)
    ckpt = tmp / ("%s_%d_%d" % (model, dim, replicas))
    publish_leaves(str(ckpt), 10, leaves)
    base = cs._free_port_block(replicas)
    procs = []
    try:
        for wid in range(replicas):
            env = cs._serve_env(model, dim, base, ckpt)
            env["HVD_TPU_WORKER_ID"] = str(wid)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "horovod_tpu_torch.serve.replica"],
                env=env, cwd=str(ROOT)))
        eps = ["127.0.0.1:%d" % (base + wid) for wid in range(replicas)]
        cs._wait_replicas(lambda: eps, replicas, "capacity")
        load.set_endpoints(eps)
        loaders = [p.pid for p in load.pool._pool]
        for i, rate in enumerate(rates):
            c0, l0 = _cpu_seconds([p.pid for p in procs]), \
                _cpu_seconds(loaders)
            t0 = time.monotonic()
            w = load.run(rate, SECONDS, dim, 5, rid_base=i * 100000,
                         deadline=30.0)
            dt = time.monotonic() - t0
            c1, l1 = _cpu_seconds([p.pid for p in procs]), \
                _cpu_seconds(loaders)
            row = cs._check_window(w, model, {crc: leaves}, "capacity",
                                   bar=None)
            row.pop("by_crc")
            row.update(
                model=model, dim=dim, replicas=replicas,
                kept_up=row["achieved_rps"] >= cs.SERVE_MIN_SHARE * rate,
                replica_cores=[(b - a) / dt for a, b in zip(c0, c1)],
                load_cores=sum(b - a for a, b in zip(l0, l1)) / dt)
            print("CAPACITY " + json.dumps(row), flush=True)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait()


def main():
    card = cs.phase_device()
    tmp = Path(tempfile.mkdtemp(prefix="serve_capacity_"))
    load = cs._ServeLoad(tmp)
    try:
        for model, dim, replicas, rates in CONFIGS:
            run(model, dim, replicas, rates, load, tmp)
    finally:
        load.close()
        shutil.rmtree(tmp, ignore_errors=True)
    print("card: %s" % card, flush=True)


if __name__ == "__main__":
    main()
