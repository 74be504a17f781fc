"""The ``@hvd.elastic.run`` decorator + worker-side elastic plumbing.

Counterpart of ``horovod_tpu/elastic/run.py`` (Horovod's
``horovod/common/elastic.py::run_fn``: catch HorovodInternalError ->
restore committed state -> reinitialize -> resync; catch
HostsUpdatedInterrupt -> reinitialize without rollback) over the port's
process groups. A lost peer surfaces from torch.distributed as gloo's
transport errors or NCCL's remote error and timeouts; the port's
collectives (``common/ops.py``, the parallel modules', the sync's) and
``DistributedOptimizer`` raise those, and only those, as
``HorovodInternalError`` (``common/ops.py``'s ``peer_loss``). Any other
error from ``func``, one that names NCCL included, propagates: it is a
bug that a rollback would only repeat. Re-initializing destroys the failed process group and starts the
next generation's, with a fresh store from its own rendezvous.

Worker-side protocol (driver side in ``elastic/driver.py``):

* The driver publishes the current membership to the rendezvous KV at
  scope ``elastic`` key ``state``:
  ``{"generation": g, "size": n, "assignment": {worker_id: rank},
  "status": "running"|"shutdown"}``.
* ``bootstrap_topology()`` (called from ``hvd.init()`` when
  ``HVD_TPU_ELASTIC=1`` and no rank env is present) polls that key until
  this worker's id appears, then sets ``HVD_TPU_RANK/SIZE/GENERATION``;
  the normal dynamic rendezvous then runs in the generation's own scope.
* On ``HorovodInternalError`` the wrapper publishes a reinit request
  (scope ``elastic``, key ``reinit/<worker_id>``) so the driver bumps the
  generation promptly even when no process exited (e.g. a transport
  error), then waits for a generation NEWER than the one that failed.
"""

import functools
import json
import os
import sys
import time

from .state import (EXIT_DRAINED, KEY_DRAIN, KEY_STATE, SCOPE_ELASTIC,
                    DrainRequested, HostsUpdatedInterrupt)

# Env keys owned by a single generation's topology; scrubbed before
# re-rendezvous so nothing stale leaks into the next generation.
_GENERATION_ENV_KEYS = (
    "HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_LOCAL_RANK",
    "HVD_TPU_LOCAL_SIZE", "HVD_TPU_CROSS_RANK", "HVD_TPU_CROSS_SIZE",
    "HVD_TPU_ADDRS", "HVD_TPU_SLOTS",
)


def _log(msg):
    sys.stderr.write("[elastic] %s\n" % msg)
    sys.stderr.flush()


class JobCompleted(Exception):
    """The driver published status \"done\" (another worker finished the
    training) while this worker was waiting to (re)join a generation —
    there is nothing left to join. The ``@run`` wrapper treats it as a
    clean exit and returns None from the wrapped function."""


def _is_elastic():
    return os.environ.get("HVD_TPU_ELASTIC") == "1" and \
        os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")


# ---------------------------------------------------------------------------
# Graceful drain (docs/FLEET.md): the supervisor (elastic driver, fleet
# controller, or the static launcher under --drain-grace) publishes a
# drain request at scope ``elastic`` key ``drain``::
#
#     {"epoch": n, "workers": "all" | ["3", "7"], "grace": seconds}
#
# Workers notice it at their next commit. Because ranks poll on their own
# clocks, the ACTION is synchronized with a 1-element indicator allreduce
# inside every commit of a drain-enabled job: every rank raises
# DrainRequested at the same step, every rank force-writes that step's
# durable shard (so the manifest completes), then the victims exit with
# EXIT_DRAINED and the survivors re-initialize without rollback.

_drain_state = {"done_epoch": 0, "last_poll": 0.0, "pending": None}


def _drain_poll_enabled():
    """Rank-uniform gate for the per-commit agreement allreduce: set at
    spawn time by the launcher/driver (never from a locally-observed
    event, which would be rank-divergent)."""
    return (os.environ.get("HVD_TPU_ELASTIC") == "1"
            or os.environ.get("HVD_TPU_DRAIN_ENABLE") == "1") and \
        bool(os.environ.get("HVD_TPU_RENDEZVOUS_ADDR"))


def _read_drain_record():
    addr = os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    if not addr:
        return None
    from horovod_tpu_torch.run import rendezvous
    try:
        raw = rendezvous.get(addr, SCOPE_ELASTIC, KEY_DRAIN)
        if raw is None:
            return None
        rec = json.loads(raw.decode())
        epoch = int(rec.get("epoch", 0))
        if rec.get("done"):
            # Tombstone of a completed epoch (the driver publishes it
            # once every victim exited): fast-forward so a replacement
            # that never lived through the drain does not act on it.
            _drain_state["done_epoch"] = max(_drain_state["done_epoch"],
                                             epoch)
            return None
        if epoch <= _drain_state["done_epoch"]:
            return None  # already honored (this process survived it)
        return rec
    except Exception:
        return None


def drain_requested():
    """Lightweight local poll: True when an unhonored drain request
    covering THIS worker is currently published. For custom training
    loops that cannot use ``ElasticState.commit()``; the commit path
    uses the synchronized agreement in :func:`poll_drain_agreement`."""
    if not _drain_poll_enabled():
        return False
    rec = _read_drain_record()
    if rec is None:
        return False
    victims = rec.get("workers", "all")
    wid = os.environ.get("HVD_TPU_WORKER_ID")
    return victims == "all" or (wid is not None and
                                str(wid) in [str(v) for v in victims])


def poll_drain_agreement():
    """Called from ``State.commit()``. Returns ``(victims, epoch,
    grace)`` when a drain has been agreed across ranks, else None.

    The local KV read is rate-limited (HVD_TPU_ELASTIC_CHECK_INTERVAL),
    but the indicator allreduce runs at EVERY commit when drain polling
    is enabled — it must be rank-uniform, and commits are the elastic
    contract's rank-uniform points. An agreement where this rank has
    not yet seen the record itself re-reads the KV synchronously (a
    peer proved the record exists)."""
    if not _drain_poll_enabled():
        return None
    st = _drain_state
    now = time.monotonic()
    interval = float(os.environ.get("HVD_TPU_ELASTIC_CHECK_INTERVAL",
                                    "0.5"))
    if st["pending"] is None and now - st["last_poll"] >= interval:
        st["last_poll"] = now
        st["pending"] = _read_drain_record()
    local = 1.0 if st["pending"] is not None else 0.0
    agreed = local
    from horovod_tpu_torch.common import basics, ops
    if basics.is_initialized() and basics.size() > 1:
        import torch
        out = ops.allreduce(torch.tensor([local], dtype=torch.float64,
                                         device=basics.device()),
                            average=False, name="_hvd_drain_poll")
        agreed = float(out.reshape(-1)[0].item())
    if agreed < 0.5:
        return None
    rec = st["pending"]
    if rec is None:
        # A peer saw the request first; the record is committed to the
        # KV (peers only learn of drains by reading it), so a short
        # bounded re-read closes the gap.
        deadline = time.monotonic() + 5.0
        while rec is None and time.monotonic() < deadline:
            rec = _read_drain_record()
            if rec is None:
                time.sleep(0.05)
    if rec is None:
        # Degraded: agreement fired but the record is unreadable. Not
        # acting keeps this rank safe either way — as a victim the
        # supervisor escalates at grace expiry, as a survivor the
        # peers' exits surface as a recoverable connection loss.
        _log("drain agreed by peers but the drain record is "
             "unreadable; continuing until the supervisor escalates")
        return None
    st["pending"] = None
    epoch = int(rec.get("epoch", 1))
    st["done_epoch"] = max(st["done_epoch"], epoch)
    return (rec.get("workers", "all"), epoch,
            float(rec.get("grace", 30.0)))


def current_generation():
    return int(os.environ.get("HVD_TPU_GENERATION", "0") or 0)


def _elastic_timeout():
    return float(os.environ.get(
        "HVD_TPU_ELASTIC_TIMEOUT",
        os.environ.get("HVD_TPU_START_TIMEOUT", "120")))


def fetch_assignment(addr, timeout, min_generation=0, worker_id=None):
    """Polls the driver-published membership until its generation reaches
    `min_generation` (and, when given, `worker_id` is assigned a rank).
    Raises RuntimeError on driver shutdown, TimeoutError on expiry."""
    from horovod_tpu_torch.run import rendezvous

    deadline = time.monotonic() + timeout
    while True:
        info = None
        try:
            raw = rendezvous.get(addr, SCOPE_ELASTIC, KEY_STATE)
            if raw is not None:
                info = json.loads(raw.decode())
        except Exception:
            info = None
        if info is not None:
            if info.get("status") == "shutdown":
                raise RuntimeError(
                    "elastic driver is shutting down the job")
            if info.get("status") == "done":
                raise JobCompleted(
                    "training finished while waiting for generation "
                    ">= %d" % min_generation)
            if int(info["generation"]) >= min_generation and (
                    worker_id is None or
                    str(worker_id) in info["assignment"]):
                return info
        if time.monotonic() > deadline:
            raise TimeoutError(
                "timed out after %.0fs waiting for elastic generation "
                ">= %d (worker %s)" % (timeout, min_generation, worker_id))
        time.sleep(0.1)


def bootstrap_topology(min_generation=0, timeout=None):
    """Sets HVD_TPU_RANK/SIZE/GENERATION from the driver-published
    assignment (this worker identified by HVD_TPU_WORKER_ID), and
    HVD_TPU_SLOTS (every rank's local slot) where the driver publishes
    slots. The subsequent dynamic rendezvous then runs in the
    generation's scope."""
    addr = os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    wid = os.environ.get("HVD_TPU_WORKER_ID")
    if not addr or wid is None:
        raise RuntimeError(
            "HVD_TPU_ELASTIC=1 requires HVD_TPU_RENDEZVOUS_ADDR and "
            "HVD_TPU_WORKER_ID (spawn workers through the elastic "
            "launcher: python -m horovod_tpu_torch.run --min-np ...)")
    info = fetch_assignment(
        addr, _elastic_timeout() if timeout is None else timeout,
        min_generation=min_generation, worker_id=wid)
    for key in _GENERATION_ENV_KEYS:
        os.environ.pop(key, None)
    os.environ["HVD_TPU_RANK"] = str(info["assignment"][str(wid)])
    os.environ["HVD_TPU_SIZE"] = str(info["size"])
    os.environ["HVD_TPU_GENERATION"] = str(info["generation"])
    slots = info.get("slots")
    if slots:  # every rank's local slot, by rank: the local ranks
        by_rank = sorted(info["assignment"], key=info["assignment"].get)
        os.environ["HVD_TPU_SLOTS"] = ",".join(str(slots[w])
                                               for w in by_rank)
    return info


def _request_reinit(failed_generation):
    """Tells the driver this worker's core hit a connection loss in
    `failed_generation`, so it bumps the generation even when no process
    exit was observed. Best-effort."""
    addr = os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    wid = os.environ.get("HVD_TPU_WORKER_ID", "?")
    if not addr:
        return
    from horovod_tpu_torch.run import rendezvous
    try:
        rendezvous.put(addr, SCOPE_ELASTIC, "reinit/%s" % wid,
                       str(failed_generation), timeout=5)
    except Exception:
        pass


def _init_again():
    """``init()`` with the last init's device and model_parallel (an
    elastic job started on the CPU re-initializes on the CPU)."""
    from horovod_tpu_torch.common import basics
    basics.init(**(basics.last_init_args() or {}))


def _reinitialize(min_generation):
    """Tears the process group down and re-initializes for a new
    generation, retrying with ever-newer generations until the elastic
    timeout."""
    from horovod_tpu_torch.common import basics

    deadline = time.monotonic() + _elastic_timeout()
    while True:
        basics.shutdown()
        if not _is_elastic():
            # Same-topology restart (size-1 tests / manual recovery).
            _init_again()
            return
        try:
            bootstrap_topology(min_generation=min_generation,
                               timeout=max(1.0,
                                           deadline - time.monotonic()))
            _init_again()
            return
        except JobCompleted:
            raise
        except (TimeoutError, RuntimeError, OSError) as e:
            if time.monotonic() > deadline:
                raise
            from horovod_tpu_torch.run import rendezvous
            rendezvous.release_held_ports()
            # The generation we tried may itself have failed (e.g. the
            # replacement died during startup). Require a newer one.
            min_generation = max(min_generation, current_generation() + 1)
            _log("re-init failed (%s); waiting for generation >= %d"
                 % (e, min_generation))


def _maybe_auto_resume(state):
    """Durable auto-resume (docs/ELASTIC.md "Durability"): on the FIRST
    entry of a process — a fresh job, or a full-job restart after a
    crash — rank 0 restores the newest valid durable manifest into the
    state; the ``state.sync()`` that follows broadcasts it to every
    rank, whatever the new world size. Durability is auto-enabled from
    ``HVD_TPU_CKPT_DIR`` (the launcher's ``--ckpt-dir``) when the user
    did not call ``enable_durable`` themselves. Never raises: a broken
    checkpoint directory degrades to a fresh start with a warning."""
    try:
        if getattr(state, "_durable", None) is None:
            if not os.environ.get("HVD_TPU_CKPT_DIR") or \
                    not hasattr(state, "enable_durable"):
                return
            state.enable_durable()
        from horovod_tpu_torch.common import basics
        if basics.rank() == 0:
            step = state._durable.restore_into(state)
            if step is not None:
                _log("auto-resume: restored durable step %d; syncing "
                     "to %d rank(s)" % (step, basics.size()))
    except Exception as e:
        _log("auto-resume skipped (%s); starting fresh" % e)


def _flush_durable(state, timeout=None):
    """Drains the durable writer at clean training exit so the final
    committed state is on disk before the process goes away."""
    durable = getattr(state, "_durable", None)
    if durable is None:
        return
    if timeout is None:
        timeout = float(os.environ.get("HVD_TPU_CKPT_FLUSH_TIMEOUT",
                                       "120"))
    if not durable.flush(timeout=timeout):
        _log("durable writer did not drain within %.0fs at exit; "
             "newest snapshot may not be durable" % timeout)


# functions of @run running in this process (the negotiated gradient route
# refuses to run inside one: the core does not re-form across elastic
# generations yet, ROADMAP A8c4)
_running = [0]


def running():
    """True inside a function decorated with :func:`run`."""
    return _running[0] > 0


def run(func):
    """Decorator making ``func(state, *args, **kwargs)`` elastic:

    * ``HorovodInternalError`` (peer lost mid-collective): restore the
      last committed state, re-initialize at the next generation, re-sync
      from the new rank 0, and call ``func`` again.
    * ``HostsUpdatedInterrupt`` (graceful membership change noticed at a
      ``state.commit()``): re-initialize and re-sync WITHOUT rollback.

    ``func`` must be resumable: it should read its progress (step/epoch)
    from the state object, which survives across retries."""

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        from horovod_tpu_torch.common import basics
        from horovod_tpu_torch.common.ops import HorovodInternalError

        reset = None  # None = first entry, else "error" | "update"
        min_generation = 0
        while True:
            try:
                if reset is None:
                    if not basics.is_initialized():
                        basics.init()
                else:
                    _reinitialize(min_generation)
                    if reset == "error":
                        state.restore()
                    _log("resuming at generation %d size %d (rank %d)"
                         % (current_generation(), basics.size(),
                            basics.rank()))
                reset = None
                if getattr(state, "_committed", None) is None:
                    # Nothing committed in THIS process yet — a fresh
                    # job or full-job restart picks up the newest valid
                    # durable checkpoint before the initial sync
                    # distributes it. Gating on the in-memory commit
                    # (not a one-shot flag) matters: if the first sync
                    # fails and the ranks reshuffle, the NEW rank 0
                    # re-attempts the restore instead of silently
                    # broadcasting its fresh step-0 state. Once any
                    # commit exists, rollbacks use it, never the disk
                    # copy.
                    _maybe_auto_resume(state)
                state.sync()
                _running[0] += 1
                try:
                    result = func(state, *args, **kwargs)
                finally:
                    _running[0] -= 1
                _flush_durable(state)
                return result
            except HorovodInternalError as e:
                if "protocol divergence" in str(e):
                    # Not a fault but a program bug (rank-conditional
                    # collective etc., see docs/LINT.md): deterministic,
                    # so rollback+retry would loop until the elastic
                    # timeout reproducing it every generation. Surface it.
                    raise
                _log("collective failed (%s); rolling back to last commit"
                     % e)
                reset = "error"
                min_generation = current_generation() + 1
                _request_reinit(current_generation())
            except DrainRequested as e:
                # Every rank reaches this handler at the SAME step (the
                # agreement allreduce in commit()), so the forced
                # durable write below is manifest-complete: rank 0's
                # publisher finds every sibling shard for the drained
                # step instead of timing out on a skewed one.
                wid = os.environ.get("HVD_TPU_WORKER_ID")
                victims = e.victims
                is_victim = victims == "all" or (
                    wid is not None and
                    str(wid) in [str(v) for v in victims])
                durable = getattr(state, "_durable", None)
                step = getattr(state, "step", None)
                if durable is not None:
                    durable.force_enqueue(state._committed,
                                          state._durable_step())
                if is_victim:
                    _log("drain (epoch %d): writing durable snapshot "
                         "of step %s, then exiting with EXIT_DRAINED"
                         % (e.epoch, step))
                    if durable is not None:
                        _flush_durable(state, timeout=e.grace)
                    sys.exit(EXIT_DRAINED)
                _log("drain (epoch %d): peer worker(s) %s leaving; "
                     "re-initializing at the post-drain generation "
                     "without rollback" % (e.epoch, victims))
                reset = "update"
                min_generation = current_generation() + 1
            except HostsUpdatedInterrupt as e:
                _log("membership changed (generation %d); re-initializing"
                     % e.generation)
                reset = "update"
                min_generation = e.generation
            except JobCompleted as e:
                # A replacement spawned just before the job finished has
                # no generation left to join — that is success elsewhere,
                # not a failure here.
                _log(str(e))
                _flush_durable(state)
                return None

    return wrapper
