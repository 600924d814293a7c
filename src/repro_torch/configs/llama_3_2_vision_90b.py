"""llama-3.2-vision-90b — 100L d8192 64H(kv8) d_ff 28672; cross-attn image
layers every 5th layer; vision frontend is a stub (precomputed patch
embeddings, d=1280, 1601 tokens).

[hf:meta-llama/Llama-3.2-11B-Vision scaled; unverified tier]
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    mlp_act="swiglu", rope_theta=5e5,
    cross_attn_period=5, n_image_tokens=1601, d_frontend=1280,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
