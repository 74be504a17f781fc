"""``python -m horovod_tpu_torch.fleet JOBFILE``: the fleet controller's
command line (``cli.py``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
