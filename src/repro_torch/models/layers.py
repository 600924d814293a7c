"""Building-block layers: norms, rotary embeddings, MLPs, embeddings.

Single-device counterparts of ``repro/models/layers.py``: the reference's
tensor-parallel collectives are kept as call sites on the axis context,
where they are identities at ``tp = 1``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ParamCtx, QTensor


def sp_out(pc: ParamCtx, y):
    """Block-output combine (all-reduce over the model axis; identity at tp=1)."""
    return pc.ctx.psum_model(y)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(pc: ParamCtx, path: str, scale, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    # the scale is stored as (scale - 1)
    return (y * (1.0 + pc.use_small(path, scale).to(torch.float32))).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (rotate-half, not interleaved)
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables, f32.  positions: (...,) int -> (..., head_dim/2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (..., S, n_heads, head_dim); cos/sin: (S, head_dim/2) (broadcast)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / GeLU)
# ---------------------------------------------------------------------------


def mlp(pc: ParamCtx, path: str, p, x, act: str):
    up = dense(pc, f"{path}/w_up", p["w_up"], x)
    if act == "swiglu":
        gate = dense(pc, f"{path}/w_gate", p["w_gate"], x)
        h = F.silu(gate) * up
    elif act == "geglu":
        gate = dense(pc, f"{path}/w_gate", p["w_gate"], x)
        h = F.gelu(gate, approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    y = dense(pc, f"{path}/w_down", p["w_down"], h)
    return sp_out(pc, y)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def vocab_embed(pc: ParamCtx, path: str, table, ids: torch.Tensor, vocab_local: int):
    """ids: (B, S) token ids; table: (V, D)."""
    lo = pc.ctx.tp_index() * vocab_local
    local = ids - lo
    in_range = (local >= 0) & (local < vocab_local)
    safe = torch.clamp(local, 0, vocab_local - 1)
    t = pc.use(f"{path}/table", table)
    if isinstance(t, QTensor):
        # lazy-quant: gather int8 rows, dequantize only the touched rows
        e = (t.codes[safe].to(torch.float32)
             * t.scale.to(torch.float32)).to(pc.compute_dtype)
    else:
        e = t[safe]
    e = torch.where(in_range[..., None], e, torch.zeros_like(e))
    return sp_out(pc, e)


def vocab_logits(pc: ParamCtx, path: str, w_unembed, x):
    """x: (B, S, D) -> logits (B, S, V)."""
    return dense(pc, f"{path}/w", w_unembed, x)


# ---------------------------------------------------------------------------
# Generic dense projection (packed weights go to the quant_matmul kernel)
# ---------------------------------------------------------------------------


def dense(pc: ParamCtx, path: str, w, x):
    """``x @ use(w)`` with leaf-type dispatch: under lazy-quant the packed
    int8 codes go straight to the ``quant_matmul`` kernel."""
    return ops.dense_dispatch(x, pc.use(path, w))
