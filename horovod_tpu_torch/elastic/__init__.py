"""Elastic training: survive membership changes without a job restart.

The port's counterpart of ``horovod_tpu/elastic/`` (ROADMAP A8b); its
modules import no torch until they touch tensors, so the launcher and
the driver start without it.

Reference lineage: Horovod Elastic (the successor capability to the
reproduced v0.17 — ``horovod/run/elastic/`` + ``horovod/common/elastic.py``
in later releases). A running job *shrinks* when a worker dies (survivors
roll back to the last committed state and continue at reduced size) and
*grows* when hosts return (the driver spawns replacements that sync state
from rank 0) — instead of the classic kill-all-on-first-exit teardown.

Pieces:

* :class:`ElasticState` and :class:`TorchState` (``state.py``) —
  commit/restore tensors (in place) and a model's and optimizer's
  ``state_dict``, and sync them from rank 0 after every membership
  change.
* :func:`run` (``run.py``) — decorator that catches
  ``HorovodInternalError`` (peer lost mid-collective: roll back, re-init,
  re-sync) and ``HostsUpdatedInterrupt`` (graceful membership change:
  re-init, re-sync, no rollback).
* ``discovery.py`` — host discovery (script-driven or fixed) plus the
  per-host failure blacklist with exponential backoff.
* ``driver.py`` — the launcher-side supervisor: monitors workers,
  blacklists failing hosts, bumps the rendezvous generation, and spawns
  replacements, keeping the world between ``--min-np`` and ``--max-np``.
* ``durable.py`` — async sharded durable snapshots of the committed
  state (``ElasticState.enable_durable`` / ``--ckpt-dir``): CRC32C
  manifests, atomic tmp→fsync→rename writes, torn-write-proof restore,
  and full-job crash recovery (auto-resume in :func:`run`).

See docs/ELASTIC.md for the state-commit semantics, the discovery script
contract, and the failure model.
"""

from .discovery import (  # noqa: F401
    FixedHosts,
    HostDiscovery,
    HostDiscoveryScript,
    HostManager,
)
from .durable import (  # noqa: F401
    CkptFaultInjector,
    CrcBuildError,
    DurableCheckpointer,
    last_durable_step,
    latest_valid_manifest,
)
from .run import HostsUpdatedInterrupt, run  # noqa: F401
from .state import ElasticState, State, TorchState  # noqa: F401
