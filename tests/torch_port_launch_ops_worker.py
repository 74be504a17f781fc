"""A worker of the port's launcher tests (gloo, CPU): started by
``python -m horovod_tpu_torch.run``, it calls ``hvd.init(device="cpu")``,
runs an allreduce, an allgather and a broadcast, checks their results and
prints one line ``TOPOLOGY {json}`` with what init() resolved; with
``--subset 1,3`` it then shuts down and does the same after
``hvd.init(device="cpu", ranks=[1, 3])``. It asserts that the launcher
started it and that no ``MASTER_ADDR`` was read.

Imports torch and the port only.
"""

import argparse
import json
import os
import sys

import torch

import horovod_tpu_torch as hvd


def check(world_rank, subset):
    """Collectives over the group init() formed, and its topology."""
    member = not subset or world_rank in subset
    n, r = hvd.size(), hvd.rank()
    if subset:
        assert (n, r) == ((len(subset), subset.index(world_rank)) if member
                          else (1, 0)), (n, r)
        ranks = subset if member else [world_rank]
    else:
        assert r == world_rank, (r, world_rank)
        ranks = list(range(n))
    x = torch.full((8,), float(world_rank))
    total = hvd.allreduce(x, average=False, name="launch_sum")
    assert torch.equal(total, torch.full((8,), float(sum(ranks)))), total
    gathered = hvd.allgather(torch.full((2,), world_rank, dtype=torch.int64),
                             name="launch_ag")
    assert gathered.tolist() == [w for w in ranks for _ in range(2)], \
        gathered
    root = hvd.broadcast(torch.full((4,), world_rank, dtype=torch.int32), 0,
                         name="launch_bc")
    assert torch.equal(root, torch.full((4,), ranks[0], dtype=torch.int32))
    print("TOPOLOGY " + json.dumps({
        "init": "subset" if subset else "world", "world_rank": world_rank,
        "rank": r, "size": n,
        "local_rank": hvd.local_rank(), "local_size": hvd.local_size(),
        "cross_rank": hvd.cross_rank(), "cross_size": hvd.cross_size(),
        "homogeneous": hvd.is_homogeneous(),
        "addrs": os.environ.get("HVD_TPU_ADDRS")}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subset", default="")
    args = ap.parse_args()
    assert "HVD_TPU_RANK" in os.environ, "not started by the launcher"
    assert "MASTER_ADDR" not in os.environ, os.environ.get("MASTER_ADDR")
    world_rank = int(os.environ["HVD_TPU_RANK"])
    hvd.init(device="cpu")
    check(world_rank, [])
    hvd.shutdown()
    subset = [int(r) for r in args.subset.split(",") if r]
    if subset:
        hvd.init(device="cpu", ranks=subset)
        check(world_rank, subset)
        hvd.shutdown()
    assert "MASTER_ADDR" not in os.environ
    return 0


if __name__ == "__main__":
    sys.exit(main())
