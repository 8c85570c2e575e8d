"""Deterministic, checkpointable synthetic data pipeline.

The port of `repro.data.pipeline`, with the reference's numbers. Each step
seeds its own numpy stream, so (a) restarts resume bit-identically from the
step counter alone (the only pipeline state), (b) elastic rescale changes
nothing in the global stream. Real deployments swap `_tokens` for tokenized
shards; the contract (``get_batch(step) -> global batch``) and the
checkpoint story stay identical. Batches are tensors on the device the
caller names.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 1234


class SyntheticPipeline:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg

    def _tokens(self, step: int) -> np.ndarray:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        # zipf-ish marginals make the CE landscape non-degenerate
        z = rng.zipf(1.3, size=(c.global_batch, c.seq_len + 1))
        return (z % c.vocab_size).astype(np.int32)

    def get_batch(self, step: int, cfg: ArchConfig | None = None,
                  device=None) -> dict:
        """The global batch of `step`: int32 ``tokens`` and ``labels``
        (the next token), or, for a config with a modality frontend,
        ``embeds`` in the config's dtype in place of tokens; M-RoPE
        configs add ``(3, B, S)`` int32 ``positions``. They lie on `device`
        (`resolve_device`: the card unless ``"cpu"`` is named)."""
        device = resolve_device(device)
        c = self.cfg
        toks = torch.from_numpy(self._tokens(step))
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        if cfg is not None and cfg.frontend != "none":
            rng = np.random.default_rng((c.seed, step, 7))
            emb = rng.standard_normal((c.global_batch, c.seq_len,
                                       cfg.d_model))
            # float64 rounded once to the config's dtype, as jnp.asarray
            batch = {"embeds": torch.from_numpy(emb).to(
                getattr(torch, cfg.dtype)), "labels": batch["labels"]}
        if cfg is not None and cfg.mrope_sections:
            batch["positions"] = torch.arange(
                c.seq_len, dtype=torch.int32).expand(
                3, c.global_batch, c.seq_len).contiguous()
        return {k: v.to(device) for k, v in batch.items()}

    # checkpointable state is just the step counter
    def state(self, step: int) -> dict:
        return {"pipeline_step": step, "seed": self.cfg.seed}
