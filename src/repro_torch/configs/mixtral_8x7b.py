"""mixtral-8x7b [arXiv:2401.04088]: 8 experts top-2, sliding-window attention."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    layer_pattern=("local",), window=4096,
    n_experts=8, experts_per_token=2,
    rope_theta=1e6, tie_embeddings=False,
)
