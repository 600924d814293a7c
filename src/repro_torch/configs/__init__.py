"""Config registry: the 10 assigned architectures (+ paper's CNN-class repro).

``get_config(name)`` returns the exact published config; ``smoke_variant``
shrinks it to a CPU-runnable reduced config of the same family (small widths,
few layers/experts, tiny vocab) for the per-arch smoke tests.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES,
    MeshConfig,
    ModelConfig,
    ShapeSpec,
    TrainConfig,
    shapes_for,
)

_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "gemma-7b": "gemma_7b",
    "glm4-9b": "glm4_9b",
    "yi-6b": "yi_6b",
    "starcoder2-15b": "starcoder2_15b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "mamba2-780m": "mamba2_780m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.ARCH


def all_configs() -> dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


def smoke_variant(cfg: ModelConfig, *, tp: int = 1) -> ModelConfig:
    """Reduced same-family config runnable on CPU in seconds."""
    r = dict(
        d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4) or 0,
        head_dim=16, d_ff=128, vocab_size=512,
        compute_dtype="float32", remat=False, rope_theta=1e4,
    )
    if cfg.family == "moe":
        r.update(n_layers=2, n_experts=8, experts_per_token=2, moe_d_ff=32)
    elif cfg.family == "dense":
        r.update(n_layers=2)
    elif cfg.family == "vlm":
        r.update(n_layers=4, cross_attn_period=2, n_image_tokens=9,
                 d_frontend=32)
    elif cfg.family == "ssm":
        r.update(n_layers=2, n_heads=0, n_kv_heads=0, d_ff=0, head_dim=0,
                 ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8)
    elif cfg.family == "encdec":
        r.update(n_layers=2, n_encoder_layers=2, d_frontend=32)
    elif cfg.family == "hybrid":
        r.update(n_layers=4, attn_period=2, moe_period=2, n_experts=4,
                 experts_per_token=2, moe_d_ff=32,
                 ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **r)
