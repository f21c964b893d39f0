import sys

from gpsat_tpu_torch.cli import main

sys.exit(main())
