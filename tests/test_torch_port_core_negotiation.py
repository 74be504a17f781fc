"""The port's negotiation core under load on CPU ranks: the mirrors of the
reference's ``tests/test_negotiation_fuzz.py`` (out-of-order enqueue at 2
and 4 ranks), ``tests/test_fusion_knobs.py`` (fusion off, the default,
a forced split, an unpaced cycle; the response and tensor counters and
the timeline's fusion-buffer markers) and
``tests/test_negotiation_scaling.py`` (zero-element allreduces at 4, 16
and, with the response cache off, 8 ranks, numpy only). The worker is
``tests/torch_port_core_worker.py``; the limits are the reference's."""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from horovod_tpu_torch.run import util

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(ROOT / "tests" / "torch_port_core_worker.py")

pytestmark = pytest.mark.e2e


def run_core(np_, mode, extra_env=None, timeout=240):
    env = util.cpu_worker_env(repo_root=str(ROOT), extra_env=extra_env)
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
         sys.executable, WORKER, mode], env=env, cwd=str(ROOT),
        capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("np_", [2, 4])
def test_negotiation_out_of_order(np_):
    proc = run_core(np_, "fuzz")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("negotiation fuzz passed") == np_


BATCHES, PER_BATCH = 8, 4
TENSORS = BATCHES * PER_BATCH  # 32 x 1 KB tensors


def _fusion(tmp_path, threshold=None, extra=None):
    env = {"HVD_TPU_CYCLE_TIME": "50",
           "HVD_TPU_TIMELINE": str(tmp_path / "tl.json")}
    if threshold is not None:
        env["HVD_TPU_FUSION_THRESHOLD"] = str(threshold)
    env.update(extra or {})
    proc = run_core(2, "fusion", env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MISMATCH" not in proc.stdout, proc.stdout
    m = re.search(r"FUSION_COUNTERS responses=(\d+) tensors=(\d+) "
                  r"threshold=(-?\d+)", proc.stdout)
    assert m, proc.stdout + proc.stderr
    return ((int(m.group(1)), int(m.group(2)), int(m.group(3))),
            (tmp_path / "tl.json").read_text())


def test_fusion_off_threshold_zero(tmp_path):
    (responses, tensors, threshold), timeline = _fusion(tmp_path, 0)
    assert tensors == TENSORS and responses == tensors
    assert threshold == 0
    assert "MEMCPY_IN_FUSION_BUFFER" not in timeline


def test_fusion_default_groups_batches(tmp_path):
    (responses, tensors, _), timeline = _fusion(tmp_path)
    assert tensors == TENSORS
    assert responses <= 2 * BATCHES, (responses, tensors)
    assert "MEMCPY_IN_FUSION_BUFFER" in timeline


def test_fusion_tiny_threshold_forces_split(tmp_path):
    (responses, tensors, threshold), timeline = _fusion(tmp_path, 2048)
    assert tensors == TENSORS and threshold == 2048
    assert TENSORS // 2 <= responses < TENSORS, (responses, tensors)
    assert "MEMCPY_IN_FUSION_BUFFER" in timeline


def test_cycle_time_zero_vs_paced(tmp_path):
    (responses, tensors, _), _ = _fusion(
        tmp_path, extra={"HVD_TPU_CYCLE_TIME": "0"})
    assert tensors == TENSORS


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def run_bench(n, extra_env=None, timeout=180):
    """n bench ranks on a static table (the reference's harness): rank
    0's microseconds a negotiated op."""
    addrs = ",".join("127.0.0.1:%d" % p for p in _free_ports(n))
    procs = []
    for r in range(n):
        env = util.cpu_worker_env(repo_root=str(ROOT), extra_env={
            "HVD_TPU_RANK": str(r), "HVD_TPU_SIZE": str(n),
            "HVD_TPU_LOCAL_RANK": str(r), "HVD_TPU_LOCAL_SIZE": str(n),
            "HVD_TPU_CROSS_RANK": "0", "HVD_TPU_CROSS_SIZE": "1",
            "HVD_TPU_ADDRS": addrs, "HVD_TPU_CYCLE_TIME": "0"})
        env.pop("HVD_TPU_RENDEZVOUS_ADDR", None)
        env.update(extra_env or {})
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, "bench"], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    us = None
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, "rank %d:\n%s" % (r, out)
        m = re.search(r"NEGOTIATION_US_PER_OP ([\d.]+)", out)
        if m:
            us = float(m.group(1))
    assert us is not None
    return us


def test_negotiation_latency_flat_vs_ranks():
    us4 = run_bench(4)
    us16 = run_bench(16)
    assert us16 < 30000, (us4, us16)
    if (os.cpu_count() or 1) >= 16:
        assert us16 < 4.0 * us4 + 500, (us4, us16)


def test_negotiation_uncached_path():
    us8 = run_bench(8, {"HVD_TPU_CACHE_CAPACITY": "0"})
    assert us8 < 50000, us8
