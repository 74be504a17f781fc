"""The port's launcher (``python -m horovod_tpu_torch.run``), rendezvous
and process-tree middleman; stdlib only, no torch."""

from .run import main, run_command  # noqa: F401
from .util import allocate_slots, parse_hostfile, parse_hosts  # noqa: F401
