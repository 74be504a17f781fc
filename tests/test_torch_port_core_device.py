"""CUDA tensors under the port's negotiation core (ROADMAP A8c2), reached on
CPU ranks: ``tests/torch_port_core_worker.py device cpu`` replaces the one
function that maps a tensor to its request's device
(``async_ops.device_id``) so that its CPU tensors are tagged as device 0.
Negotiation then takes the core's device op, and the executor of
``common/device_plane.py`` runs every response on a gloo group with the
code that runs NCCL on the card. The worker runs once a world size (2 and
4 ranks, under ``python -m horovod_tpu_torch.run``); each test reads its
section's lines. The mirrors, and the reference tests they hold the port
to:

* ``ops``: ``tests/test_distributed.py``'s collective matrix (every
  dtype, the average and scales, bool, fusion, uneven allgather,
  broadcast from every root, reduce-scatter, the wire modes, the
  mismatch and duplicate-name errors, the cache's steady state, poll);
* ``fuzz``: ``tests/test_negotiation_fuzz.py``'s out-of-order enqueue;
* ``fusion``: the counters of ``tests/test_fusion_knobs.py``;
* ``groups``: ``tests/test_groups.py::test_group_collectives_all_kinds``
  (4 ranks), ``::test_group_rejections_by_name`` and
  ``::test_unregistered_group_errors_not_hangs`` (2 ranks);
* ``mixed_sharded``: ``tests/test_sharded_update.py::
  test_mixed_mode_ranks_rejected_naming_both``, raw and optimizer level;
* ``mixed_compression``: ``tests/test_compression.py::
  test_mixed_mode_rejected_at_negotiation``;
* ``mixed_device``: a host tensor meeting a device tensor of the same
  name, rejected on every rank with both ranks named within 30 s;
* ``shutdown``: ``hvd.shutdown()`` with a device handle outstanding,
  which then fails within 30 s.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from horovod_tpu_torch.run import util

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(ROOT / "tests" / "torch_port_core_worker.py")
TIMEOUT_S = 240

pytestmark = pytest.mark.e2e

BATCHES, PER_BATCH = 8, 4
TENSORS = BATCHES * PER_BATCH  # 32 x 1 KB tensors


@pytest.fixture(scope="module", params=[2, 4], ids=["np2", "np4"])
def job(request):
    """(world size, the worker's output) of one run of the device mode;
    a hang fails the tests of its world size after TIMEOUT_S."""
    np_ = request.param
    env = util.cpu_worker_env(repo_root=str(ROOT))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
             sys.executable, WORKER, "device", "cpu"], env=env,
            cwd=str(ROOT), capture_output=True, text=True, timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        return np_, None, "the %d-rank worker ran past %d s:\n%s" % (
            np_, TIMEOUT_S, e.stdout)
    return np_, proc, proc.stdout + proc.stderr


def _section(job, name):
    np_, proc, out = job
    assert proc is not None, out
    assert out.count("device %s ok" % name) == np_, out[-6000:]
    return np_, out


def test_device_ops_matrix(job):
    _section(job, "ops")


def test_device_out_of_order_enqueue(job):
    _section(job, "fuzz")


def test_device_fusion_counters(job):
    np_, out = _section(job, "fusion")
    m = re.search(r"DEVICE_FUSION (\{.*\})", out)
    assert m, out[-3000:]
    found = json.loads(m.group(1))
    responses, tensors, threshold = found["off"]
    assert tensors == TENSORS and responses == tensors and threshold == 0
    responses, tensors, _ = found["default"]
    assert tensors == TENSORS and responses <= 2 * BATCHES, found
    responses, tensors, threshold = found["split"]
    assert tensors == TENSORS and threshold == 2048
    assert TENSORS // 2 <= responses < TENSORS, found
    assert found["unpaced"][1] == TENSORS


def test_device_groups(job):
    np_, out = _section(job, "groups")
    if np_ == 2:
        assert "never registered that group" in out, out[-3000:]


def test_device_mixed_host_and_gpu_rejected(job):
    _section(job, "mixed_device")


def test_device_mixed_sharded_and_replicated_rejected(job):
    _section(job, "mixed_sharded")


def test_device_mixed_compression_rejected(job):
    _section(job, "mixed_compression")


def test_device_shutdown_fails_outstanding_handles(job):
    _section(job, "shutdown")


def test_device_job_exits_cleanly(job):
    np_, proc, out = job
    assert proc is not None, out
    assert proc.returncode == 0, out[-6000:]
