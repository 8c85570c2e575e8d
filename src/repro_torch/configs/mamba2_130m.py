"""mamba2-130m [arXiv:2405.21060]: attention-free SSD (state-space duality).

The SSD chunked scan is structurally the paper's wavefront temporal blocking
applied to a linear recurrence: chunk = in-fast-memory time block, carried
state = the wavefront (DESIGN.md Sec. 5).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    layer_pattern=("mamba",),
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    tie_embeddings=True,
)
