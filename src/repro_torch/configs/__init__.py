"""Architecture registry: ``--arch <id>`` resolves here.

The port of `repro.configs`: the ten architectures and `reduced`, the
same-family smoke-scale config, as the reference defines them.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, SHAPES, shape_applicable
from repro_torch.configs import (gemma3_1b, h2o_danube3_4b, hubert_xlarge,
                           jamba_1_5_large, kimi_k2, llama3_2_1b,
                           mamba2_130m, mixtral_8x7b, qwen2_vl_2b, qwen3_4b)

REGISTRY: dict[str, ArchConfig] = {c.name: c for c in (
    gemma3_1b.CONFIG,
    llama3_2_1b.CONFIG,
    qwen3_4b.CONFIG,
    h2o_danube3_4b.CONFIG,
    hubert_xlarge.CONFIG,
    mamba2_130m.CONFIG,
    kimi_k2.CONFIG,
    mixtral_8x7b.CONFIG,
    qwen2_vl_2b.CONFIG,
    jamba_1_5_large.CONFIG,
)}

ARCH_IDS = tuple(REGISTRY)


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 64,
            vocab: int = 128) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    scale = d_model / cfg.d_model
    n_heads = max(1, min(cfg.n_heads, 4)) if cfg.n_heads else 0
    n_kv = max(1, min(cfg.n_kv_heads, n_heads)) if cfg.n_kv_heads else 0
    pat_period = len(cfg.layer_pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=max(n_layers, min(pat_period, 8)),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=(16 if cfg.n_heads else 0),
        d_ff=max(int(cfg.d_ff * scale) // 8 * 8, 64) if cfg.d_ff else 0,
        vocab_size=vocab,
        window=min(cfg.window, 16) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2)
        if cfg.experts_per_token else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        mrope_sections=(2, 3, 3) if cfg.mrope_sections else (),
    )


__all__ = ["ArchConfig", "SHAPES", "REGISTRY", "ARCH_IDS", "get", "reduced",
           "shape_applicable"]
