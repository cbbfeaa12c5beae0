"""``python -m capreolus_tpu_torch`` entry point."""

import sys

from capreolus_tpu_torch.run import main

if __name__ == "__main__":
    sys.exit(main())
