"""Serve an LM with batched requests, end to end.

The port of ``examples/serve_lm.py``: `launch.serve.main` with the same
flags. Builds the reduced config of ``--arch`` (llama3.2-1b by default),
prefills a batch of prompts, then decodes greedily with the KV cache,
printing per-phase throughput. Any decoder of the ten serves
(mamba2-130m from its O(1) SSM state); ``--no-reduced`` serves the
published width and depth.

  python -m repro_torch.examples.serve_lm --arch llama3.2-1b --gen 48
  python -m repro_torch.examples.serve_lm --device cpu --arch mamba2-130m
"""

from __future__ import annotations

import sys

from repro_torch.launch import serve


def main(argv=None) -> dict:
    """Run the serving launcher on `argv`; returns its record."""
    return serve.main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
