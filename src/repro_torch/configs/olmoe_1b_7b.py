"""olmoe-1b-7b — 16L d2048 16H(kv16) expert-ffn 1024, 64e top-8.

[arXiv:2409.02060; hf-verified tier]
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, moe_d_ff=1024, vocab_size=50304,
    n_experts=64, experts_per_token=8,
    mlp_act="swiglu", rope_theta=1e4,
    source="arXiv:2409.02060",
)
