import logging
import sys

from helix_tpu_torch.cli import main

if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
