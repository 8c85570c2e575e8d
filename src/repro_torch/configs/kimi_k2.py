"""kimi-k2-1t-a32b [arXiv:2501.kimi2]: trillion-parameter MoE, 384e top-8.

About 1.03T parameters (384 experts x 61 layers x 3*7168*2048); the
training state uses Adafactor (a factored second moment), whose state is
O(n + m) per (n, m) matrix instead of AdamW's two full moments.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163840,
    n_experts=384, experts_per_token=8,
    rope_theta=5e4, tie_embeddings=False,
    optimizer="adafactor",
)
