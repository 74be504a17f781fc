"""The fleet controller: one pool of GPUs, many jobs, preemption-native.

The port's counterpart of ``horovod_tpu/fleet/`` (ROADMAP A8f), with the
same names, jobfile, ``/fleet`` document and ``fleet_*`` families, so
that either package's ``hvd-top --fleet`` reads the other's controller.
The controller imports no torch and never touches a device: its jobs'
workers do (a train job's port scripts, a serve job's
``python -m horovod_tpu_torch.serve.replica``, on the GPU by default).

The production-scale composition of the reliability stack (ROADMAP item
5): a :class:`FleetController` owns the host inventory and runs N
concurrent elastic jobs with priorities. A job that cannot fit yet is
gang-admitted later with capped backoff; a higher-priority arrival
preempts lower-priority work by **graceful drain** — the victim's
workers finish the in-flight step, force a durable commit of exactly
that step, and exit with ``EXIT_DRAINED`` so the controller reclaims
their hosts immediately (voluntary exit never trips the failure
blacklist) — and the victim is restored (grow or full durable resume)
when capacity returns.

Pieces:

* ``placement.py`` — the reusable placement library: ``plan_spawns``
  (shared with the single-job elastic driver) and :class:`PlacementPool`
  (slot-granular leases over the host inventory, oversubscription
  refused and counted).
* ``controller.py`` — the controller: admission, priority preemption,
  drain/restore orchestration, one elastic driver thread per job.
* ``chaos.py`` — the seeded fleet chaos schedule
  (``HVD_TPU_FLEET_CHAOS_SPEC``: arrival / kill / preempt events).
* ``metrics.py`` — fleet_* counters/gauges/histograms + the HTTP
  endpoint serving Prometheus ``/metrics`` and the ``/fleet`` JSON view
  ``hvd-top --fleet`` polls.
* ``cli.py`` — the launcher, ``python -m horovod_tpu_torch.fleet.cli``
  or ``python -m horovod_tpu_torch.fleet`` (jobfile in, exit 0 when
  every job completed).

See docs/FLEET.md for the controller model, the drain protocol, and the
chaos grammar.
"""

from .chaos import FleetChaos  # noqa: F401
from .controller import FleetController, FleetJob, JobSpec  # noqa: F401
from .metrics import FleetMetrics  # noqa: F401
from .placement import PlacementPool, plan_spawns  # noqa: F401
