import sys

from aha_tpu_torch.cli import main

sys.exit(main())
