import sys

from vit2spn_tpu_torch.cli import main

sys.exit(main())
