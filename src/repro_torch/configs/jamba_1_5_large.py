"""jamba-1.5-large-398b [arXiv:2403.19887]: Mamba+attention 1:7, MoE 16e top-2.

Layer pattern period 8: one attention layer per 7 Mamba layers; every 2nd
layer's FFN is MoE. Adafactor for the 398B training state.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "global", "mamba", "mamba", "mamba"),
    n_experts=16, experts_per_token=2, moe_period=2,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    tie_embeddings=False, optimizer="adafactor",
)
