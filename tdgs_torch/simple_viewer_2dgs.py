"""The viewer command line pinned to --model-type 2dgs (counterpart of the
JAX package's ``examples/simple_viewer_2dgs.py``).

    python -m tdgs_torch.simple_viewer_2dgs [--ply scene.ply] [--device cpu]
"""

import sys

from tdgs_torch.simple_viewer import main

if __name__ == "__main__":
    sys.exit(main(["--model-type", "2dgs"] + sys.argv[1:]))
