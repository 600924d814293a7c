"""starcoder2-15b — 40L d6144 48H(kv4) d_ff 24576, GQA RoPE, GeLU MLP.

[arXiv:2402.19173; hf-verified tier]
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152,
    mlp_act="gelu", rope_theta=1e5,
    source="arXiv:2402.19173",
)
