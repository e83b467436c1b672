import sys

from openpose_plus_tpu_torch.cli import main

sys.exit(main())
