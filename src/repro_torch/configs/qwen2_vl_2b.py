"""qwen2-vl-2b [arXiv:2409.12191]: VLM backbone with M-RoPE.

Vision frontend is a STUB per the brief: the batch carries precomputed
patch/token embeddings plus (3, B, S) multimodal position ids; M-RoPE splits
the rotary half-dim into (t, h, w) = (16, 24, 24) sections.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    mrope_sections=(16, 24, 24), frontend="vision",
    rope_theta=1e6, tie_embeddings=True,
)
