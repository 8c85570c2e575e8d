"""Train a small LM end-to-end with checkpoint/resume.

The port of ``examples/train_lm.py``: `launch.train.main` with the same
flags. The reduced same-family config of ``--arch`` by default; ``--full``
trains the published width and depth.

  python -m repro_torch.examples.train_lm --arch mixtral-8x7b --steps 30
  python -m repro_torch.examples.train_lm --device cpu --steps 3 \\
      --batch 2 --seq 32 --ckpt "$(mktemp -d)"
"""

from __future__ import annotations

import sys

from repro_torch.launch import train


def main(argv=None):
    """Run the launcher on `argv`; returns the final train state."""
    return train.main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
