"""The viewer command line pinned to --model-type 3dgut (counterpart of the
JAX package's ``examples/simple_viewer_3dgut.py``).

    python -m tdgs_torch.simple_viewer_3dgut [--ply scene.ply] [--device cpu]
"""

import sys

from tdgs_torch.simple_viewer import main

if __name__ == "__main__":
    sys.exit(main(["--model-type", "3dgut"] + sys.argv[1:]))
