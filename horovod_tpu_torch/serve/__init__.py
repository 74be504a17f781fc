"""The inference serving plane (docs/SERVE.md), the port's counterpart
of ``horovod_tpu/serve/``.

Everything this package moves is a REQUEST, not a gradient — but every
structural part is a training part reused:

* a **replica** (``replica.py``) is one worker process spawned by the
  elastic driver (``python -m horovod_tpu_torch.serve``). It loads
  weights from a durable checkpoint lineage (``elastic/durable.py``),
  runs its forward on the GPU (``model.make_forward``; ``--device cpu``
  for tests), and fronts it with a stdlib-only HTTP/JSON server.
  Replicas are INDEPENDENT — no collective ever runs on the request
  path;
* **continuous micro-batching** (``batcher.py``): a bounded admission
  queue feeds a size/deadline-bounded batcher that pads each batch up
  to a power-of-two bucket, then splits the outputs back to their
  requests, each row CRC-checked between admission and the forward;
* **rolling weight swap** (``swap.py``): a background watcher on the
  checkpoint lineage loads a newer VALID manifest into a shadow forward
  (its leaves uploaded to the device) and flips the serving forward
  between batches — never mid-batch, so a swap drops zero requests;
  torn/CRC-invalid manifests are rejected
  (``serve_swap_rejects_total``) and the replica keeps serving the
  current weights;
* **drain-native**: replicas poll the driver's drain record
  (``elastic/run.py::drain_requested``), stop admitting (clients are
  told the cause and re-queue to a surviving replica via
  ``client.py``), finish the queue, and exit ``EXIT_DRAINED``.

The HTTP documents, the environment variables and the lineage format are
the reference's, so a reference client or load generator drives a port
replica and the reverse. Only the replica and ``model.make_forward``
import torch: the supervisor, the client and the load generator start
without it.
"""

from .batcher import MicroBatcher, QueueFull, Ticket  # noqa: F401
from .client import ServeClient, ServeError  # noqa: F401
from .metrics import ServeMetrics, histogram_quantile  # noqa: F401
from .model import (fingerprint, forward, init_leaves,  # noqa: F401
                    make_forward)
from .swap import SwapWatcher  # noqa: F401
