"""hubert-xlarge [arXiv:2106.07447]: encoder-only audio transformer.

The modality frontend (conv feature extractor) is a STUB per the brief:
the batch carries precomputed frame embeddings (B, S, d_model); the
backbone is the standard w2v2-style encoder; the 504-way head covers the
masked-unit prediction targets.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False, act="gelu", frontend="audio", tie_embeddings=False,
)
