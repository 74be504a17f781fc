"""Prometheus text rendering of a metrics snapshot.

The pure functions of ``horovod_tpu/_metrics.py`` (``_fmt``,
``render_prometheus``), which the serve replicas' ``/metrics`` renders
with. The rest of that module, ``metrics()``, ``job_metrics()`` and the
per-worker endpoint, reads the native core's registry and comes with
ROADMAP A8d (after A8c's core).
"""

_PREFIX = "hvdtpu_"


def _fmt(v):
    """Prometheus float formatting: integers stay integral."""
    f = float(v)
    return "%d" % f if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus(snapshot, labels=None):
    """Renders a snapshot (``{"counters", "gauges", "histograms": {name:
    {"bounds", "counts", "sum", "count"}}}``, optionally ``per_group``
    and ``rank_lag_seconds``) as Prometheus text exposition: one
    ``hvdtpu_``-prefixed family per counter and gauge, histograms as
    cumulative ``_bucket{le=...}`` plus ``_sum`` and ``_count``.
    ``labels`` is an optional dict rendered into every sample (e.g.
    rank)."""
    label_str = ""
    if labels:
        label_str = ",".join('%s="%s"' % (k, labels[k])
                             for k in sorted(labels))
    lines = []

    def sample(name, value, extra=""):
        inner = ",".join(x for x in (label_str, extra) if x)
        label_part = "{%s}" % inner if inner else ""
        lines.append("%s%s %s" % (_PREFIX + name, label_part, _fmt(value)))

    for name, value in sorted(snapshot.get("counters", {}).items()):
        lines.append("# TYPE %s%s counter" % (_PREFIX, name))
        sample(name, value)
    for name, value in sorted(snapshot.get("gauges", {}).items()):
        lines.append("# TYPE %s%s gauge" % (_PREFIX, name))
        sample(name, value)
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        lines.append("# TYPE %s%s histogram" % (_PREFIX, name))
        cumulative = 0
        for bound, count in zip(h["bounds"], h["counts"]):
            cumulative += count
            sample(name + "_bucket", cumulative, 'le="%s"' % _fmt(bound))
        cumulative += h["counts"][len(h["bounds"])]
        sample(name + "_bucket", cumulative, 'le="+Inf"')
        sample(name + "_sum", h["sum"])
        sample(name + "_count", h["count"])
    # Coordinator-side group-labeled negotiation counters: one series per
    # process group id.
    per_group = snapshot.get("per_group") or {}
    if per_group:
        lines.append("# TYPE %sgroup_negotiated_total counter" % _PREFIX)
        for gid in sorted(per_group, key=int):
            inner = 'group="%s"' % gid
            if label_str:
                inner = label_str + "," + inner
            lines.append("%sgroup_negotiated_total{%s} %s" % (
                _PREFIX, inner,
                _fmt(per_group[gid].get("negotiated_total", 0))))
    # Coordinator-only per-rank announce lag (straggler table). The rank
    # label here names the ATTRIBUTED rank, not the serving worker, so
    # the base labels are deliberately not applied.
    lag = snapshot.get("rank_lag_seconds") or []
    if any(lag):
        lines.append("# TYPE %srank_announce_lag_seconds_total counter"
                     % _PREFIX)
        for r, v in enumerate(lag):
            lines.append('%srank_announce_lag_seconds_total{rank="%d"} %s'
                         % (_PREFIX, r, _fmt(v)))
    return "\n".join(lines) + "\n"
