"""qwen3-moe-235b-a22b — 94L d4096 64H(kv4) expert-ffn 1536, 128e top-8.

[hf:Qwen/Qwen3-30B-A3B family; hf-verified tier]
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, moe_d_ff=1536, vocab_size=151936,
    n_experts=128, experts_per_token=8,
    mlp_act="swiglu", rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)
