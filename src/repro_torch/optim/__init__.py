"""Optimizers of the port (`repro.optim` on tensors): AdamW and its
warmup-cosine schedule, for the coefficient fit."""

from repro_torch.optim.optimizers import Optimizer, adamw, warmup_cosine

__all__ = ["Optimizer", "adamw", "warmup_cosine"]
