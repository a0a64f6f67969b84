"""Entry point for ``python -m crimp_tpu_torch.obs``."""

import sys

from crimp_tpu_torch.obs.cli import main

if __name__ == "__main__":
    sys.exit(main())
