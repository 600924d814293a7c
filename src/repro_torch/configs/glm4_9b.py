"""glm4-9b — 40L d4096 32H(kv2) d_ff 13696, RoPE GQA.

[hf:THUDM/glm-4-9b; hf-verified tier]
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=151552,
    mlp_act="swiglu", rope_theta=1e4,
    source="hf:THUDM/glm-4-9b",
)
