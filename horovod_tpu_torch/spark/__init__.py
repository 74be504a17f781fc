"""Spark integration — ``horovod_tpu_torch.spark.run(fn, ...)``.

A copy of ``horovod_tpu/spark/__init__.py`` for the port. Capability
parity with the reference (`horovod/spark/__init__.py:35-233`):
run `fn` as a data-parallel horovod job on `num_proc` Spark tasks and
return the per-rank results. The reference tunnels `mpirun`'s remote shell
through Spark task RPC (mpirun_rsh); the TPU-native build needs no MPI —
Spark's **barrier execution mode** gives every task a rendezvous
(`BarrierTaskContext.allGather`), so each task exchanges its
host:port, computes the same rank/local/cross topology the launcher
would inject (`run/util.py`'s ``topology_env``), sets the ``HVD_TPU_*``
env, and calls ``hvd.init()`` directly: rank 0 binds the process group's
store on the port it published. ``hvd.init()`` takes the device the
caller passes to ``run(..., device=)`` (the GPU by default, ``"cpu"`` for
gloo ranks).

The barrier-task body is factored framework-free (``_task_topology_env``)
so it is unit-testable without a Spark cluster (the reference mocks its
shell layer the same way, test/test_spark.py:51-91).
"""

import os
import socket


def _importable(mod):
    import importlib.util
    return importlib.util.find_spec(mod) is not None


def _task_topology_env(rank, host_ports):
    """Shared topology computation; see `run.util.topology_env`."""
    from horovod_tpu_torch.run.util import topology_env
    return topology_env(rank, host_ports)


def _free_port():
    from horovod_tpu_torch.run.rendezvous import reserve_port
    return reserve_port()


def _barrier_task(fn, args, kwargs, extra_env, context=None, device=None):
    """Runs inside one barrier task; `context` injectable for tests."""
    if context is None:
        from pyspark import BarrierTaskContext
        context = BarrierTaskContext.get()
    rank = context.partitionId()
    addr = "%s:%d" % (socket.gethostname(), _free_port())
    host_ports = [m.strip() for m in context.allGather(addr)]
    env = _task_topology_env(rank, host_ports)
    if extra_env:
        env.update(extra_env)
    # The task does not own this process (Spark reuses python workers,
    # and tests run the barrier body in-process): restore every mutated
    # key afterwards so stale topology can't leak into a later init().
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)

    import horovod_tpu_torch as hvd
    try:
        hvd.init(device=device)
        try:
            result = fn(*args, **kwargs)
        finally:
            hvd.shutdown()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rank, result


def run(fn, args=(), kwargs=None, num_proc=None, extra_env=None,
        verbose=1, device=None):
    """Runs `fn` on `num_proc` Spark barrier tasks with horovod_tpu_torch
    initialized (on ``device``: the GPU by default); returns results
    ordered by rank (reference semantics: spark/__init__.py:98-233)."""
    if not _importable("pyspark"):
        raise ImportError(
            "horovod_tpu_torch.spark.run requires pyspark, which is not "
            "installed in this environment.")
    from pyspark.sql import SparkSession

    spark = SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    if num_proc is None:
        num_proc = max(int(sc.defaultParallelism), 1)
    if verbose:
        print("Running %d processes (Spark barrier mode)..." % num_proc)
    kwargs = kwargs or {}

    def _mapper(_):
        yield _barrier_task(fn, args, kwargs, extra_env, device=device)

    results = (sc.parallelize(range(num_proc), num_proc)
               .barrier()
               .mapPartitions(_mapper)
               .collect())
    return [r for _, r in sorted(results)]
