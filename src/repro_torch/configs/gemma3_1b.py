"""gemma3-1b [hf:google/gemma-3-1b-pt]: 5:1 local:global attention."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    layer_pattern=("local",) * 5 + ("global",), window=512,
    qk_norm=True, rope_theta=1e6, act="gelu", tie_embeddings=True,
)
