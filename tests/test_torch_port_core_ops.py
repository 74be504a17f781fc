"""The asynchronous API on CPU tensors through the port's negotiation
core, at 2 and 4 ranks under ``python -m horovod_tpu_torch.run``: the
mirrors of the reference's ``tests/test_distributed.py`` (the collective
matrix, ``HVD_TPU_CYCLE_TIME`` and ``HVD_TPU_CACHE_CAPACITY=0``) and the
core beside a ``torch.distributed`` group, started in either order. The
worker is ``tests/torch_port_core_worker.py``; the numbers it checks are
the reference worker's."""

import subprocess
import sys
from pathlib import Path

import pytest

from horovod_tpu_torch.run import util

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(ROOT / "tests" / "torch_port_core_worker.py")

pytestmark = pytest.mark.e2e


def run_core(np_, mode, extra_env=None, timeout=240):
    """``python -m horovod_tpu_torch.run -np N`` of the core worker in
    ``mode`` on CPU ranks."""
    env = util.cpu_worker_env(repo_root=str(ROOT), extra_env=extra_env)
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
         sys.executable, WORKER, mode], env=env, cwd=str(ROOT),
        capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("np_", [2, 4])
def test_distributed_ops(np_):
    proc = run_core(np_, "ops")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for r in range(np_):
        assert ("rank %d: all distributed op tests passed" % r) in \
            proc.stdout, proc.stdout + proc.stderr


def test_cycle_time_env():
    proc = run_core(2, "ops", {"HVD_TPU_CYCLE_TIME": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("all distributed op tests passed") == 2


def test_cache_disabled():
    proc = run_core(2, "ops", {"HVD_TPU_CACHE_CAPACITY": "0"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("all distributed op tests passed") == 2


@pytest.mark.parametrize("core_first", ["0", "1"])
def test_core_beside_a_process_group(core_first):
    """The core on the launcher's table and a gloo group formed after it
    (its store on a port rank 0 broadcasts through the core), or the
    group first and the core on ports exchanged through its store: both
    sum, and ranks and sizes agree."""
    proc = run_core(2, "order", {"HVD_CORE_FIRST": core_first})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("core and process group OK") == 2
