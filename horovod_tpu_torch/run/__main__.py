"""``python -m horovod_tpu_torch.run -np N [-H hosts] cmd ...``."""

import sys

from .run import main

if __name__ == "__main__":
    sys.exit(main())
