"""`python3 -m tendermint_tpu_torch.cmd` (counterpart:
tendermint_tpu/cmd/__main__.py)."""

import sys

from .commands import main

sys.exit(main())
