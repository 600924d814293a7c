"""Config dataclasses: model architecture, input shapes, mesh, training."""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "cnn"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 => d_model // n_heads
    mlp_act: str = "swiglu"            # swiglu | geglu | gelu
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                  # expert hidden dim (if != d_ff)
    moe_period: int = 1                # MoE every k-th layer (1 = all)
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid (jamba) ---
    attn_period: int = 0               # 1 attention layer every `attn_period`
    # --- enc-dec ---
    n_encoder_layers: int = 0          # 0 => decoder-only
    # --- VLM ---
    cross_attn_period: int = 0         # cross-attn layer every k layers
    n_image_tokens: int = 0
    d_frontend: int = 0                # stub frontend embedding width
    # --- numerics / distribution ---
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    seq_parallel: bool = True          # Megatron-SP activation sharding
    fsdp_gather_dtype: str = ""        # "" = param dtype; "bfloat16" = cast-on-gather
    # --- notes ---
    supports_long_context: bool = False  # sub-quadratic => run long_500k
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        qkv = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d

        def mlp(dff):
            mults = 3 if self.mlp_act in ("swiglu", "geglu") else 2
            return mults * d * dff

        n_blocks = self.n_layers
        total = emb + head
        if self.family in ("dense", "vlm"):
            per = qkv + mlp(self.d_ff)
            total += n_blocks * per
            if self.family == "vlm" and self.cross_attn_period:
                n_cross = n_blocks // self.cross_attn_period
                total += n_cross * qkv  # cross-attn projections
        elif self.family == "moe":
            per = qkv + self.n_experts * mlp(self.moe_d_ff or self.d_ff)
            per += d * self.n_experts  # router
            total += n_blocks * per
        elif self.family == "ssm":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            per = d * (2 * d_in + 2 * self.ssm_state + nh) + d_in * d
            total += n_blocks * per
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            ssm_per = d * (2 * d_in + 2 * self.ssm_state + nh) + d_in * d
            n_attn = self.n_layers // (self.attn_period or 8)
            n_ssm = self.n_layers - n_attn
            moe_per = self.n_experts * mlp(self.moe_d_ff or self.d_ff) + d * self.n_experts
            n_moe = self.n_layers // max(self.moe_period, 1)
            n_dense_mlp = self.n_layers - n_moe
            total += n_attn * qkv + n_ssm * ssm_per
            total += n_moe * moe_per + n_dense_mlp * mlp(self.d_ff)
        elif self.family == "encdec":
            enc = self.n_encoder_layers * (qkv + mlp(self.d_ff))
            dec = self.n_layers * (2 * qkv + mlp(self.d_ff))  # self + cross
            total += enc + dec
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k experts only)."""
        if self.family not in ("moe", "hybrid") or not self.n_experts:
            return self.param_count()
        dense = self.param_count()
        mults = 3 if self.mlp_act in ("swiglu", "geglu") else 2
        per_expert = mults * self.d_model * (self.moe_d_ff or self.d_ff)
        n_moe = (self.n_layers // max(self.moe_period, 1))
        inactive = n_moe * (self.n_experts - self.experts_per_token) * per_expert
        return int(dense - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str                         # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                         # "train" | "prefill" | "decode"


LM_SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)


def shapes_for(cfg: ModelConfig) -> tuple[ShapeSpec, ...]:
    """The shape cells this arch actually runs (long_500k: sub-quadratic only)."""
    out = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and not cfg.supports_long_context:
            continue  # full-attention arch: noted skip (DESIGN.md §6)
        out.append(s)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: tuple[int, ...] = (16, 16)
    axes: tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    optimizer: str = "sgd"             # paper server update is plain SGD
    momentum: float = 0.0
    weight_decay: float = 0.0
    n_rounds: int = 100
    microbatch: int = 0                # 0 = no microbatching
    seed: int = 0
    # FWQ (bit-width assignment lives in repro.api.PrecisionPolicy now):
    n_clients: int = 16
    error_tolerance: float = 0.05      # lambda in constraint (23)
    grad_compression_bits: int = 0     # 0 = off (paper-faithful)
    nonfinite_grads: str = "raise"     # wire-quantizer NaN/Inf policy:
    #                                    "raise" | "saturate"
