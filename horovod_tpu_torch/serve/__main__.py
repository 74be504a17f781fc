"""``python -m horovod_tpu_torch.serve -np N --model M --dim D
--ckpt-dir DIR``: the serve-pool supervisor (the port's ``hvd-serve``;
see ``supervisor.py``)."""

import sys

from .supervisor import main

if __name__ == "__main__":
    sys.exit(main())
