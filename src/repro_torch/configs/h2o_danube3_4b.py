"""h2o-danube-3-4b [arXiv:2401.16818]: llama+mistral mix, sliding window."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab_size=32000,
    layer_pattern=("local",), window=4096,
    rope_theta=1e4, tie_embeddings=False,
)
