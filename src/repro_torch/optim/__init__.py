"""Optimizers of the port (`repro.optim` on tensors): AdamW with its
warmup-cosine schedule, Adafactor, and the config's choice of the two."""

from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          make_optimizer, warmup_cosine)

__all__ = ["Optimizer", "adamw", "adafactor", "make_optimizer",
           "warmup_cosine"]
