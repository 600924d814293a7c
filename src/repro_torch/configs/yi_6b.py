"""yi-6b — 32L d4096 32H(kv4) d_ff 11008, llama-arch GQA.

[arXiv:2403.04652; hf-verified tier]
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000,
    mlp_act="swiglu", rope_theta=5e6,
    source="arXiv:2403.04652",
)
