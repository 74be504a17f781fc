"""``hvd-top`` of the port — ``python -m horovod_tpu_torch.run.top`` — a
live terminal view of a running job, a serve pool or a fleet: a copy of
``horovod_tpu/run/top.py`` whose frames equal the reference's on the same
documents, so either package's tool reads either package's endpoints.

Three views:

* the job view polls the coordinator's ``/job`` metrics endpoint (rank 0
  of a job launched with ``--metrics-port``; docs/METRICS.md) and renders
  per-rank cycle / negotiation / fusion stats, so a hanging or
  straggling job is diagnosable in seconds: the rank whose announce lag
  grows is the one everybody else is waiting on. The port's launcher
  serves no ``/job`` document yet (its ``--metrics-port`` is ROADMAP
  A8d); the view reads the reference's;
* ``--serve`` polls a serve pool's (or one replica's) ``/serve``;
* ``--fleet`` polls a fleet controller's ``/fleet``.

Stdlib-only on purpose — it runs anywhere, against any reachable job.
"""

import argparse
import json
import sys
import time
import urllib.request


def fetch_job(endpoint, timeout=5):
    url = endpoint
    if not url.startswith("http"):
        url = "http://" + url
    if not url.rstrip("/").endswith("/job"):
        url = url.rstrip("/") + "/job"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _rate(cur, prev, field, dt):
    if prev is None or dt <= 0:
        return None
    return (cur.get(field, 0.0) - prev.get(field, 0.0)) / dt


def _fmt_rate(v, scale=1.0, suffix=""):
    if v is None:
        return "-"
    v *= scale
    if v >= 1e6:
        return "%.1fM%s" % (v / 1e6, suffix)
    if v >= 1e3:
        return "%.1fk%s" % (v / 1e3, suffix)
    return "%.1f%s" % (v, suffix)


def _int_field(field):
    """Column renderer for a plain integer counter; '-' when an older
    worker's summary predates the field (mixed-version elastic jobs)."""
    def fmt(cur, prev, dt, ctx):
        if field not in cur:
            return "-"
        return "%d" % int(cur[field])
    return fmt


def _tun_state(cur, prev, dt, ctx):
    """Closed-loop autotune posture (docs/AUTOTUNE.md): 'tun' while the
    tuner is actively sampling, 'cvg' once converged, suffixed with the
    re-arm count when it has re-armed (e.g. 'tun/2' = third tuning pass
    live). '-' when the worker's summary predates the autotune fields
    (mixed-version elastic job)."""
    if "autotune_active" not in cur:
        return "-"
    state = "tun" if int(cur.get("autotune_active", 0)) else "cvg"
    rearms = int(cur.get("autotune_rearms_total", 0))
    return "%s/%d" % (state, rearms) if rearms else state


def _grp_state(cur, prev, dt, ctx):
    """Process groups (docs/GROUPS.md): registered groups on the worker,
    suffixed with the group-scoped tensor throughput when any flows
    (e.g. '3/12.0' = 3 groups, 12 group tensors/s). '0' = no groups
    (pure data-parallel); '-' = the worker's summary predates the group
    fields (mixed-version elastic job)."""
    if "groups" not in cur:
        return "-"
    g = int(cur.get("groups", 0))
    rate = _rate(cur, prev, "group_tensors_total", dt)
    if g <= 0:
        return "0"
    if rate is None or rate <= 0:
        return "%d" % g
    return "%d/%s" % (g, _fmt_rate(rate))


def _shm_state(cur, prev, dt, ctx):
    """Shared-memory data plane (docs/TRANSPORT.md): live attached
    segments on the worker, suffixed with the shm byte rate when the
    plane is moving traffic (e.g. '3/1.2M' = 3 segments, 1.2 MB/s
    through shared memory). '0' = no segments (shm off, single-rank
    host, or every pair nacked); '-' = the worker's summary predates
    the shm fields (mixed-version elastic job)."""
    if "shm_segments_active" not in cur:
        return "-"
    segs = int(cur.get("shm_segments_active", 0))
    if segs <= 0:
        return "0"
    rate = _rate(cur, prev, "net_shm_bytes_sent_total", dt)
    if rate is None or rate <= 0:
        return "%d" % segs
    return "%d/%s" % (segs, _fmt_rate(rate))


def _trc_state(cur, prev, dt, ctx):
    """Trace recorder health (docs/TRACING.md): span rate through the
    ring, suffixed with the cumulative ring-drop count when any span was
    ever dropped (e.g. '1.2k/d37' = 1200 spans/s, 37 dropped — grow
    HVD_TPU_TRACE_RING). 'off' = tracing disabled on the worker; '-' =
    the worker's summary predates the trace fields (mixed-version
    elastic job)."""
    if "trace_spans_total" not in cur:
        return "-"
    dropped = int(cur.get("trace_spans_dropped_total", 0))
    rate = _rate(cur, prev, "trace_spans_total", dt)
    if rate is None and float(cur.get("trace_spans_total", 0.0)) <= 0:
        return "off"
    base = _fmt_rate(rate)
    return "%s/d%d" % (base, dropped) if dropped else base


def _cmp_ratio(cur, prev, dt, ctx):
    """Live wire-compression factor (docs/COMPRESSION.md): f32 bytes
    into the codec / bytes put on the wire. '-' when the worker
    predates the compression fields OR compression never engaged."""
    if "compression_bytes_out_total" not in cur:
        return "-"
    out_b = float(cur.get("compression_bytes_out_total", 0.0))
    in_b = float(cur.get("compression_bytes_in_total", 0.0))
    if out_b <= 0 or in_b <= 0:
        return "-"
    return "%.1fx" % (in_b / out_b)


# Column schema: (header, width, renderer(cur, prev, dt, ctx) -> str).
# Every cell renders through this table, so a worker whose summary lacks
# a NEWER field (elastic job mid-rolling-upgrade) shows '-' in that one
# column instead of shifting every column after it.
_COLUMNS = [
    ("cyc/s", 9,
     lambda cur, prev, dt, ctx: _fmt_rate(_rate(cur, prev, "cycles_total",
                                                dt))),
    ("cyc_ms", 9, lambda cur, prev, dt, ctx: "%.2f" % ctx["cyc_ms"]),
    ("ops/s", 8,
     lambda cur, prev, dt, ctx: _fmt_rate(
         _rate(cur, prev, "tensors_performed_total", dt))),
    ("B/s", 9,
     lambda cur, prev, dt, ctx: _fmt_rate(
         _rate(cur, prev, "bytes_performed_total", dt))),
    ("fused_B", 9,
     lambda cur, prev, dt, ctx: _fmt_rate(cur.get("fused_bytes_total",
                                                  0.0))),
    ("cache%", 7, lambda cur, prev, dt, ctx: "%.1f%%" % ctx["cache_pct"]),
    ("queue", 6, _int_field("queue_depth")),
    ("stall", 6, _int_field("stall_warnings_total")),
    ("diverr", 6, _int_field("divergence_errors_total")),
    # Transport health (docs/CHAOS.md): detected corrupt frames, I/O
    # deadline expiries, and control-star reconnects survived.
    ("crc", 5, _int_field("net_crc_errors_total")),
    ("nto", 5, _int_field("net_timeouts_total")),
    ("rcn", 5, _int_field("net_reconnects_total")),
    # Durable checkpoints: the newest step this rank knows is safely on
    # disk (-1 = durability off / nothing written yet; '-' = the worker
    # predates the field) — docs/ELASTIC.md.
    ("dur", 7, _int_field("last_durable_step")),
    # Graceful drain (docs/FLEET.md): drain requests this worker agreed
    # to honor (victims force a durable commit then exit EXIT_DRAINED).
    ("drn", 5, _int_field("drains_requested_total")),
    # Wire compression factor (codec bytes in / wire bytes out).
    ("cmp", 6, _cmp_ratio),
    # Sharded weight update (docs/ZERO.md): reduce-scatter collectives
    # this worker executed (0 = replicated mode; '-' = the worker
    # predates the field).
    ("shd", 6, _int_field("reduce_scatter_total")),
    # Closed-loop autotune posture: tun(actively sampling) / cvg
    # (converged), '/N' = re-armed N times (docs/AUTOTUNE.md).
    ("tun", 6, _tun_state),
    # Process groups: registered groups (+ group-tensor rate when the
    # mesh is actually moving traffic) — docs/GROUPS.md.
    ("grp", 8, _grp_state),
    # Shared-memory data plane: attached segments (+ shm byte rate) —
    # docs/TRANSPORT.md.
    ("shm", 8, _shm_state),
    # Trace recorder: span rate (+ '/dN' once the ring ever dropped) —
    # docs/TRACING.md.
    ("trc", 8, _trc_state),
    ("lag_s", 9, lambda cur, prev, dt, ctx: "%.2f" % ctx["lag_total"]),
]


def render(job, prev_job, dt, endpoint):
    """One frame: header + per-rank table + straggler verdict."""
    per_rank = job.get("per_rank") or {}
    lag = job.get("rank_lag_seconds") or []
    prev_rank = (prev_job or {}).get("per_rank") or {}
    prev_lag = (prev_job or {}).get("rank_lag_seconds") or []
    lines = []
    lines.append("hvd-top — %s — size %d, generation %d — %s" % (
        endpoint, int(job.get("size", 0)), int(job.get("generation", 0)),
        time.strftime("%H:%M:%S")))
    header = "%4s " % "rank" + " ".join(
        "%*s" % (width, name) for name, width, _ in _COLUMNS)
    lines.append(header)
    lines.append("-" * len(header))

    max_lag_delta, straggler = 0.0, None
    faults_total = 0
    for r in sorted(per_rank, key=int):
        cur = per_rank[r]
        prev = prev_rank.get(r)
        cyc_rate = _rate(cur, prev, "cycles_total", dt)
        # Mean work-cycle duration over the window (cumulative mean as
        # the first-frame fallback).
        dsec = _rate(cur, prev, "cycle_seconds_sum", dt)
        cyc_ms = (dsec / cyc_rate * 1e3) if cyc_rate else (
            cur.get("cycle_seconds_sum", 0.0) / cur["cycles_total"] * 1e3
            if cur.get("cycles_total") else 0.0)
        hits = cur.get("cache_hit_total", 0.0)
        misses = cur.get("cache_miss_total", 0.0)
        cache_pct = 100.0 * hits / (hits + misses) if hits + misses else 0.0
        ri = int(r)
        lag_total = lag[ri] if ri < len(lag) else 0.0
        lag_prev = prev_lag[ri] if ri < len(prev_lag) else 0.0
        lag_delta = lag_total - lag_prev
        if prev_job is not None and lag_delta > max_lag_delta:
            max_lag_delta, straggler = lag_delta, ri
        faults_total += int(cur.get("faults_injected_total", 0))
        ctx = {"cyc_ms": cyc_ms, "cache_pct": cache_pct,
               "lag_total": lag_total}
        lines.append("%4s " % r + " ".join(
            "%*s" % (width, fn(cur, prev, dt, ctx))
            for _, width, fn in _COLUMNS))
    if faults_total:
        lines.append("! fault injection active: %d fault(s) injected "
                     "across the job (HVD_TPU_FAULT_SPEC set)"
                     % faults_total)
    ages = job.get("age_seconds") or {}
    stale = [r for r, age in ages.items() if float(age) > 10.0]
    if stale:
        lines.append("! no summary from rank(s) %s for >10s (hung or dead?)"
                     % ", ".join(sorted(stale, key=int)))
    if lag and max(lag) > 0:
        worst = lag.index(max(lag))
        note = " (growing)" if straggler == worst else ""
        lines.append("straggler: rank %d holds the most waited-on-announce "
                     "time (%.2fs total)%s" % (worst, max(lag), note))
    return "\n".join(lines)


def fetch_fleet(endpoint, timeout=5):
    url = endpoint
    if not url.startswith("http"):
        url = "http://" + url
    if not url.rstrip("/").endswith("/fleet"):
        url = url.rstrip("/") + "/fleet"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


# Fleet column schema, same tolerance rule as _COLUMNS: a missing field
# renders '-' instead of shifting the row (docs/FLEET.md).
_FLEET_COLUMNS = [
    ("state", 10, lambda j: str(j.get("state", "-"))),
    # Job kind (docs/SERVE.md): train | serve; '-' = the controller
    # predates the serving plane (mixed-version fleets).
    ("kind", 6, lambda j: str(j.get("kind", "-"))),
    # Placement shape (docs/FLEET.md "Placement"): pack | spread.
    ("place", 7, lambda j: str(j.get("placement", "-"))),
    ("prio", 5, lambda j: "%d" % j.get("priority", 0)),
    ("live", 5, lambda j: "%d" % j.get("live", 0)),
    ("want", 5, lambda j: "%d" % j.get("np", 0)),
    ("min", 4, lambda j: "%d" % j.get("min_np", 0)),
    ("leased", 7, lambda j: "%d" % j.get("leased", 0)),
    ("drains", 7, lambda j: "%d" % j.get("drains", 0)),
    ("preempt", 8, lambda j: "%d" % j.get("preemptions", 0)),
    ("restore", 8, lambda j: "%d" % j.get("restores", 0)),
    ("restart", 8, lambda j: "%d" % j.get("restarts", 0)),
    ("dur", 6, lambda j: "-" if j.get("last_durable_step") is None
     else "%d" % j["last_durable_step"]),
    ("age_s", 8, lambda j: "-" if j.get("age_seconds") is None
     else "%.1f" % j["age_seconds"]),
]


def render_fleet(fleet, endpoint):
    """One frame of the cross-job view: per-job table + host states +
    the drain/preemption counters (docs/FLEET.md)."""
    jobs = fleet.get("jobs") or {}
    hosts = fleet.get("hosts") or {}
    counters = fleet.get("counters") or {}
    lines = ["hvd-fleet — %s — t=%.0fs — %d job(s), %d free slot(s) — %s"
             % (endpoint, float(fleet.get("t", 0.0)), len(jobs),
                int(fleet.get("free_slots", 0)),
                time.strftime("%H:%M:%S"))]
    width = max([len(n) for n in jobs] + [4])
    header = "%-*s " % (width, "job") + " ".join(
        "%*s" % (w, name) for name, w, _ in _FLEET_COLUMNS)
    lines.append(header)
    lines.append("-" * len(header))
    for name in sorted(jobs):
        j = jobs[name]
        lines.append("%-*s " % (width, name) + " ".join(
            "%*s" % (w, fn(j)) for _, w, fn in _FLEET_COLUMNS))
    by_state = {}
    for h in hosts.values():
        by_state[h.get("state", "?")] = by_state.get(
            h.get("state", "?"), 0) + 1
    lines.append("hosts: " + (", ".join(
        "%d %s" % (n, s) for s, n in sorted(by_state.items()))
        or "none discovered"))
    lines.append(
        "fleet: %d admitted, %d preempted, %d restored, %d drain(s), "
        "%d kill(s) injected, %d oversubscription refusal(s), "
        "%d occupancy violation(s)"
        % (counters.get("fleet_admissions_total", 0),
           counters.get("fleet_preemptions_total", 0),
           counters.get("fleet_restores_total", 0),
           counters.get("fleet_drains_requested_total", 0),
           counters.get("fleet_kills_injected_total", 0),
           counters.get("fleet_oversubscription_refusals_total", 0),
           counters.get("fleet_occupancy_violations_total", 0)))
    draining = sorted(n for n, j in jobs.items()
                      if j.get("state") == "draining")
    if draining:
        lines.append("! draining: %s (durable-committing, then hosts "
                     "return to the pool)" % ", ".join(draining))
    return "\n".join(lines)


def fetch_serve(endpoint, timeout=5):
    url = endpoint
    if not url.startswith("http"):
        url = "http://" + url
    if not url.rstrip("/").endswith("/serve"):
        url = url.rstrip("/") + "/serve"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _serve_num(field, fmt="%d"):
    """Serve-column renderer under the same mixed-version tolerance
    rule as _COLUMNS/_FLEET_COLUMNS: a replica (or pool) document that
    predates the field renders '-' in that one cell."""
    def render(v):
        if v.get(field) is None:
            return "-"
        return fmt % v[field]
    return render


# Per-replica serve columns (docs/SERVE.md; the pool's /serve document
# carries one row per replica under "per_replica").
_SERVE_COLUMNS = [
    ("state", 9, lambda v: str(v.get("state", "-"))),
    ("step", 7, _serve_num("model_step")),
    ("weights", 9, lambda v: str(v.get("weights_crc") or "-")),
    ("queue", 6, _serve_num("queue_depth")),
    ("infl", 5, _serve_num("inflight")),
    ("req", 8, _serve_num("requests_total")),
    ("resp", 8, _serve_num("responses_total")),
    ("batch", 7, _serve_num("batches_total")),
    ("rej", 5, _serve_num("rejects_total")),
    ("err", 5, _serve_num("errors_total")),
    # Deadline-expired tickets dropped before spending a forward row.
    ("cxl", 5, _serve_num("cancelled_total")),
    # Frame-integrity failures caught by the per-row CRC gate.
    ("corr", 5, _serve_num("frame_corrupt_total")),
    # Rolling weight swaps: landed / rejected (torn or CRC-invalid
    # lineage) / abandoned-to-drain.
    ("swp", 4, _serve_num("swaps_total")),
    ("swrej", 6, _serve_num("swap_rejects_total")),
    ("swabt", 6, _serve_num("swap_aborts_total")),
    ("p50ms", 8, _serve_num("p50_ms", "%.1f")),
    ("p99ms", 8, _serve_num("p99_ms", "%.1f")),
]


def render_serve(doc, endpoint):
    """One frame of the serving view: pool header + per-replica table
    (docs/SERVE.md). Works against a supervisor's aggregated /serve
    (per_replica rows) or a single replica's /serve (one row)."""
    replicas = doc.get("per_replica")
    if replicas is None:
        replicas = [doc] if doc.get("replica") is not None else []
    lines = ["hvd-serve — %s — %s replica(s) (%s reporting, %s "
             "draining), %s scale event(s) — %s"
             % (endpoint,
                doc.get("replicas", len(replicas)),
                doc.get("replicas_reporting", len(replicas)),
                doc.get("draining", "-"),
                doc.get("scale_events", "-"),
                time.strftime("%H:%M:%S"))]
    header = "%4s " % "rep" + " ".join(
        "%*s" % (w, name) for name, w, _ in _SERVE_COLUMNS)
    lines.append(header)
    lines.append("-" * len(header))
    for v in sorted(replicas, key=lambda v: v.get("replica", 0)):
        rep = v.get("replica")
        lines.append("%4s " % ("-" if rep is None else rep) + " ".join(
            "%*s" % (w, fn(v)) for _, w, fn in _SERVE_COLUMNS))
    totals = []
    for label, field in (("req", "requests_total"),
                         ("resp", "responses_total"),
                         ("rej", "rejects_total"),
                         ("err", "errors_total"),
                         ("swaps", "swaps_total")):
        if doc.get(field) is not None:
            totals.append("%s %s" % (doc[field], label))
    if doc.get("p99_ms") is not None:
        totals.append("p99 %.1fms" % doc["p99_ms"])
    if totals:
        lines.append("pool: " + ", ".join(totals))
    steps = doc.get("model_steps") or []
    if len(steps) > 1:
        lines.append("! mixed weights: replicas serve steps %s (a "
                     "rolling swap is in flight)"
                     % ", ".join(str(s) for s in steps))
    if doc.get("frame_corrupt_total"):
        lines.append("! %d corrupt batch frame(s) caught by the row-CRC "
                     "gate (requests failed with cause "
                     "'frame-corrupt', never silently wrong)"
                     % doc["frame_corrupt_total"])
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.run.top",
        description="Live per-rank view of a horovod_tpu job's metrics "
                    "plane (poll rank 0's /job endpoint), or — with "
                    "--fleet — the cross-job view of a fleet "
                    "controller's /fleet endpoint.")
    ap.add_argument("endpoint", nargs="?", default="localhost:9400",
                    help="coordinator metrics endpoint: host:port, URL, "
                         "or the --metrics-port base (rank 0 serves the "
                         "job view there). With --fleet: the hvd-fleet "
                         "--port endpoint. Default: localhost:9400")
    ap.add_argument("--fleet", action="store_true",
                    help="cross-job fleet view: poll a fleet "
                         "controller's /fleet endpoint instead of a "
                         "job's /job endpoint (docs/FLEET.md)")
    ap.add_argument("--serve", action="store_true",
                    help="serving-pool view: poll an hvd-serve "
                         "supervisor's (or single replica's) /serve "
                         "endpoint (docs/SERVE.md)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll interval seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (no screen "
                         "clearing; for scripts/tests)")
    args = ap.parse_args(argv)

    if args.fleet:
        return _fleet_loop(args)
    if args.serve:
        return _serve_loop(args)

    prev_job, prev_t = None, None
    try:
        while True:
            try:
                job = fetch_job(args.endpoint)
            except Exception as e:
                msg = "hvd-top: cannot reach %s: %s" % (args.endpoint, e)
                if args.once:
                    print(msg, file=sys.stderr)
                    return 1
                print(msg, file=sys.stderr)
                time.sleep(args.interval)
                continue
            if not job or not job.get("per_rank"):
                msg = ("hvd-top: %s answered but has no job view — point "
                       "me at RANK 0's port (the --metrics-port base)"
                       % args.endpoint)
                if args.once:
                    print(msg, file=sys.stderr)
                    return 1
                print(msg, file=sys.stderr)
                time.sleep(args.interval)
                continue
            now = time.monotonic()
            dt = (now - prev_t) if prev_t is not None else 0.0
            frame = render(job, prev_job, dt, args.endpoint)
            if args.once:
                print(frame)
                return 0
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            prev_job, prev_t = job, now
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def _serve_loop(args):
    try:
        while True:
            try:
                doc = fetch_serve(args.endpoint)
            except Exception as e:
                msg = "hvd-top: cannot reach serve pool at %s: %s" % (
                    args.endpoint, e)
                print(msg, file=sys.stderr)
                if args.once:
                    return 1
                time.sleep(args.interval)
                continue
            frame = render_serve(doc, args.endpoint)
            if args.once:
                print(frame)
                return 0
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def _fleet_loop(args):
    try:
        while True:
            try:
                fleet = fetch_fleet(args.endpoint)
            except Exception as e:
                msg = "hvd-top: cannot reach fleet at %s: %s" % (
                    args.endpoint, e)
                print(msg, file=sys.stderr)
                if args.once:
                    return 1
                time.sleep(args.interval)
                continue
            frame = render_fleet(fleet, args.endpoint)
            if args.once:
                print(frame)
                return 0
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
