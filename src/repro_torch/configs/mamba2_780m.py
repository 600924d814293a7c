"""mamba2-780m — 48L d1536, attention-free SSD, state 128.

Sub-quadratic: runs the long_500k cell.
[arXiv:2405.21060; unverified tier]
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    ssm_chunk=256, supports_long_context=True,
    source="arXiv:2405.21060",
)
