"""``python -m unionml_tpu_torch.analysis [paths] [--format json] [--select ...]``."""

import sys

from unionml_tpu_torch.analysis.engine import main

if __name__ == "__main__":
    sys.exit(main())
