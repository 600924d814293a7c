"""seamless-m4t-large-v2 — enc-dec 24+24L d1024 16H d_ff 8192, multimodal.

Assignment lists "24L": interpreted as 24 encoder + 24 decoder layers (the
published model is 24/24).  Audio frontend is a stub: precomputed frame
embeddings (d=1024).
[arXiv:2308.11596; hf-verified tier]
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_encoder_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206, d_frontend=1024,
    mlp_act="swiglu", rope_theta=1e4,
    source="arXiv:2308.11596",
)
