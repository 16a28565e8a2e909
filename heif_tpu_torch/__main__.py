import sys

from heif_tpu_torch.cli import main

sys.exit(main())
