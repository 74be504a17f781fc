"""``python -m horovod_tpu_torch.fleet.cli`` (or ``python -m
horovod_tpu_torch.fleet``) — run a jobfile of concurrent elastic jobs on
one host pool (docs/FLEET.md); the port's ``hvd-fleet``, which takes the
reference's jobfile.

Jobfile (JSON)::

    {
      "hosts": "localhost:8",          // or --hosts / --host-discovery-script
      "drain_grace": 30,               // optional, seconds
      "jobs": [
        {"name": "prod", "command": "python train.py", "np": 4,
         "min_np": 2, "priority": 10, "ckpt_dir": "ckpt/prod"},
        {"name": "batch", "command": "python sweep.py", "np": 4,
         "min_np": 1, "priority": 0, "arrival": 5.0,
         "ckpt_dir": "ckpt/batch", "env": {"SWEEP_ID": "7"}}
      ]
    }

Exit code 0 when every job completed; 1 when any job failed or the
``--timeout`` expired. ``--port`` serves the controller's metrics plane
(``/metrics`` Prometheus, ``/fleet`` JSON) — point ``python -m
horovod_tpu_torch.run.top --fleet`` at it for the live cross-job view.

``--linger S`` (the port's own option) keeps that endpoint up for S
seconds after every job is terminal, so that a scraper reads the final
counters (an interrupt ends the wait early); without it the process
exits as the reference's does. Starting it loads no torch: the jobs'
workers do.
"""

import argparse
import json
import sys
import time


def make_parser():
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.fleet",
        description="Run N concurrent elastic jobs with priorities and "
                    "preemption-by-graceful-drain on one host pool.")
    parser.add_argument("jobfile", help="JSON jobfile (see docs/FLEET.md)")
    parser.add_argument("-H", "--hosts", default=None,
                        help='host pool, e.g. "localhost:8,host2:4" '
                             "(overrides the jobfile's hosts)")
    parser.add_argument("--host-discovery-script", default=None,
                        help="executable printing one 'host[:slots]' "
                             "line per available host; polled so the "
                             "pool tracks preemption/churn")
    parser.add_argument("--port", type=int, default=None,
                        help="controller metrics/view port (serves "
                             "/metrics and /fleet; hvd-top --fleet "
                             "polls it). 0 picks a free port")
    parser.add_argument("--drain-grace", type=float, default=None,
                        help="seconds a drain victim gets to durable-"
                             "commit before SIGKILL escalation "
                             "(default 30, or the jobfile's)")
    parser.add_argument("--timeout", type=float, default=None,
                        help="give up (exit 1) after this many seconds")
    parser.add_argument("--linger", type=float, default=0.0,
                        help="with --port: keep serving /metrics and "
                             "/fleet for this many seconds after the "
                             "fleet finishes (default 0)")
    parser.add_argument("--verbose", action="store_true")
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    try:
        with open(args.jobfile) as f:
            jobfile = json.load(f)
    except (OSError, ValueError) as e:
        sys.stderr.write("hvd-fleet: cannot read jobfile %s: %s\n"
                         % (args.jobfile, e))
        return 2
    specs = jobfile.get("jobs") or []
    if not specs:
        sys.stderr.write("hvd-fleet: jobfile has no jobs\n")
        return 2

    from horovod_tpu_torch.elastic.discovery import (
        FixedHosts, HostDiscoveryScript)
    from horovod_tpu_torch.fleet.chaos import FleetChaos
    from horovod_tpu_torch.fleet.controller import FleetController

    if args.host_discovery_script:
        discovery = HostDiscoveryScript(args.host_discovery_script)
    else:
        hosts = args.hosts or jobfile.get("hosts")
        if not hosts:
            sys.stderr.write(
                "hvd-fleet: no host pool (give -H/--hosts, "
                "--host-discovery-script, or a jobfile 'hosts' key)\n")
            return 2
        discovery = FixedHosts(hosts)

    chaos = FleetChaos.from_env()
    if chaos is not None:
        sys.stderr.write(
            "[fleet] ! chaos schedule active (HVD_TPU_FLEET_CHAOS_SPEC, "
            "seed %d, %d event(s)) — test mode\n"
            % (chaos.seed, len(chaos.events)))

    controller = FleetController(
        discovery,
        port=args.port,
        drain_grace=args.drain_grace or jobfile.get("drain_grace"),
        chaos=chaos,
        verbose=args.verbose)
    for spec in specs:
        controller.submit(spec)
    if controller.port is not None:
        sys.stderr.write(
            "[fleet] metrics at http://localhost:%d/metrics, job view "
            "at /fleet (try: python -m horovod_tpu_torch.run.top "
            "--fleet localhost:%d)\n"
            % (controller.port, controller.port))
    try:
        rc = controller.run(timeout=args.timeout)
        if args.linger > 0 and controller.port is not None:
            sys.stderr.write("[fleet] final view served for %.0f s\n"
                             % args.linger)
            sys.stderr.flush()
            try:
                time.sleep(args.linger)
            except KeyboardInterrupt:
                pass
        return rc
    finally:
        controller.shutdown()


if __name__ == "__main__":
    sys.exit(main())
