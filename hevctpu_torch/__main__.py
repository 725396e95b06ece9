"""python -m hevctpu_torch: the port's command-line interface (cli.py)."""

import sys

from hevctpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
