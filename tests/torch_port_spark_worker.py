"""Orchestrator of the port's Spark e2e test: in a clean interpreter, puts
the fake pyspark (``tests/fake_pyspark``) on sys.path and drives the port's
``horovod_tpu_torch.spark.run`` through it — SparkSession.builder ->
parallelize -> barrier -> mapPartitions -> collect — each barrier task a
forked process that publishes its host:port, calls
``hvd.init(device="cpu")`` on that static table and allreduces (gloo).

Imports torch and the port only.
"""

import pathlib
import sys

_HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(_HERE / "fake_pyspark"))
sys.path.insert(0, str(_HERE.parent))


def train(scale):
    """Runs inside each barrier task after hvd.init(): a real allreduce
    proves that the table the tasks exchanged formed the group."""
    import torch

    import horovod_tpu_torch as hvd

    out = hvd.allreduce(torch.ones(4) * (hvd.rank() + 1), average=False,
                        name="spark_e2e_ar")
    return (float(out[0]) * scale, hvd.rank(), hvd.size(), hvd.local_rank())


def main():
    import horovod_tpu_torch.spark as hvd_spark

    results = hvd_spark.run(train, args=(10,), num_proc=2, verbose=1,
                            device="cpu")
    assert len(results) == 2, results
    for r, (val, rank_, size_, local) in enumerate(results):
        assert val == (1 + 2) * 10.0, results
        assert (rank_, size_, local) == (r, 2, r), results
    print("spark run ok: %s" % (results,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
