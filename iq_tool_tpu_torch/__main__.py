import sys

from iq_tool_tpu_torch.cli import main

sys.exit(main())
