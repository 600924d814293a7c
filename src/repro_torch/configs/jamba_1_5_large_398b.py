"""jamba-1.5-large-398b — 72L hybrid: Mamba+attention 1:7 interleave,
MoE 16e top-2 on every 2nd layer; d8192 64H(kv8) d_ff 24576.

Sub-quadratic mixers dominate: runs the long_500k cell.
[arXiv:2403.19887; hf-verified tier]
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, moe_d_ff=24576, vocab_size=65536,
    n_experts=16, experts_per_token=2, moe_period=2,
    attn_period=8,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    ssm_chunk=256, supports_long_context=True,
    mlp_act="swiglu", rope_theta=1e4,
    source="arXiv:2403.19887",
)
