"""Mamba2 (SSD: state-space duality) mixer on one device.

Counterpart of ``repro/models/ssm.py``.  The selective SSM
``s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t``, ``y_t = C_t s_t + D x_t`` is
evaluated in chunks for training and prefill: a quadratic attention-like
*intra-chunk* term plus a linear *inter-chunk* recurrence over the chunk
summary states (:func:`_ssd_scan`).  Decode advances the state one token at
a time (:func:`ssm_decode_step`) and returns NEW tensors: a bucketed
prefill merges each step's state per slot, so a step must never write the
state it was given.

B/C projections use one group (mamba2's default).  The recurrence's own
parameters (``a_log``, ``dt_bias``, ``d_skip``), the conv kernels and the
gated norm's scale are used through ``pc.use_small``: never quantized.
Nothing here sets a matmul precision: the scan's f32 einsums stay f32 on the
card (TF32 stays off).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamCtx, init_dense
from repro_torch.models.layers import dense, sp_out

#: Bytes the intra-chunk decay block of one group of heads may take: the
#: scan forms ``(B, C, Q, Q, g)`` for ``g`` heads at a time, never all heads
#: of a wide mixer (jamba's 256 heads at Q 256 would take gigabytes).
DECAY_BLOCK_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_state: int
    head_dim: int
    expand: int
    conv_width: int
    chunk: int
    tp: int

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def heads_local(self) -> int:
        assert self.n_heads % self.tp == 0
        return self.n_heads // self.tp

    @property
    def d_inner_local(self) -> int:
        return self.heads_local * self.head_dim


def init_ssm(gen: torch.Generator, dims: SSMDims, *, lead=(), device=None,
             dtype=torch.float32) -> dict:
    """The mixer's parameters with ``lead`` stack dims, drawn in the
    reference's order (``wx, wz, w_bc, w_dt, conv_x, conv_bc, wo``)."""
    d, dl, hl, n = dims.d_model, dims.d_inner_local, dims.heads_local, dims.d_state
    lead = tuple(lead)
    kw = {"lead": lead, "device": device, "dtype": dtype}

    def normal(shape, std):
        w = torch.empty(lead + shape, device=device, dtype=torch.float32)
        return w.normal_(0.0, 1.0, generator=gen).mul_(std).to(dtype)

    def full(n_, value):
        return torch.full(lead + (n_,), value, device=device, dtype=torch.float32)

    p = {"wx": init_dense(gen, d, dl, **kw), "wz": init_dense(gen, d, dl, **kw),
         "w_bc": init_dense(gen, d, 2 * n, **kw), "w_dt": init_dense(gen, d, hl, **kw),
         "conv_x": normal((dims.conv_width, dl), 0.1),
         "conv_bc": normal((dims.conv_width, 2 * n), 0.1),
         "a_log": full(hl, 0.0),           # A = -exp(a_log): init -1
         "dt_bias": full(hl, -2.0),        # softplus ~= 0.12
         "d_skip": full(hl, 1.0)}
    p["wo"] = init_dense(gen, dl, d, **kw)
    p["norm"] = full(dl, 0.0)
    return p


def _causal_depthwise_conv(x, kernel):
    """x: (B, S, C); kernel: (W, C).  Causal depthwise conv as W shifted
    multiply-adds (no conv op)."""
    W, S = kernel.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for w in range(W):
        out = out + pad[:, w:w + S, :] * kernel[w][None, None, :]
    return out


def _ssd_scan(xdt, la, Bm, Cm, chunk: int):
    """Chunked SSD.

    xdt: (B,S,H,P) inputs pre-scaled by dt; la: (B,S,H) log-decay (dt*A,
    <= 0); Bm/Cm: (B,S,N).  Returns y: (B,S,H,P) and the final state
    (B,H,N,P).
    """
    Bsz, S, H, P = xdt.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, "sequence must divide the SSD chunk"
    C = S // Q
    xdt = xdt.reshape(Bsz, C, Q, H, P)
    la = la.reshape(Bsz, C, Q, H)
    Bm = Bm.reshape(Bsz, C, Q, N)
    Cm = Cm.reshape(Bsz, C, Q, N)

    L = torch.cumsum(la, dim=2)                      # within-chunk cum log decay
    Ltot = L[:, :, -1:, :]                           # (B,C,1,H)

    # intra-chunk (quadratic in Q only), a group of heads at a time: the
    # decay block is (B,C,Q,Q,g).  The mask goes in before the exp, so the
    # masked entries are exp(-inf) = 0 and their gradient 0, never 0 * inf.
    dotCB = torch.einsum("bcin,bcjn->bcij", Cm, Bm)[..., None]   # shared by heads
    ii = torch.arange(Q, device=xdt.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    g = max(1, DECAY_BLOCK_BYTES // (Bsz * C * Q * Q * L.element_size()))
    parts = []
    for h0 in range(0, H, g):
        Lh = L[..., h0:h0 + g]                       # (B,C,Q,g)
        diff = Lh[:, :, :, None, :] - Lh[:, :, None, :, :]
        decay = torch.exp(torch.where(causal, diff, torch.full_like(diff, -torch.inf)))
        parts.append(torch.einsum("bcijh,bcjhp->bcihp", dotCB * decay,
                                  xdt[:, :, :, h0:h0 + g]))
    y_intra = torch.cat(parts, dim=3)

    # chunk summary states: S_c = sum_j exp(Ltot - L_j) B_j (x dt)_j
    w_end = torch.exp(Ltot - L)                      # (B,C,Q,H)
    Sc = torch.einsum("bcjn,bcjhp->bchnp", Bm, w_end[..., None] * xdt)

    # inter-chunk recurrence over chunk states (the state BEFORE each chunk)
    dc = torch.exp(Ltot[:, :, 0, :])                 # (B,C,H) total chunk decay
    R = torch.zeros((Bsz, H, N, P), dtype=xdt.dtype, device=xdt.device)
    prev = []
    for c in range(C):
        prev.append(R)
        R = R * dc[:, c, :, None, None] + Sc[:, c]
    Rprev = torch.stack(prev, dim=1)                 # (B,C,H,N,P)

    w_start = torch.exp(L)                           # decay from chunk start
    y_inter = torch.einsum("bcin,bchnp->bcihp", Cm, Rprev) * w_start[..., None]

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, R


def _gated_norm(pc: ParamCtx, path, scale, y, z, eps=1e-6):
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yn = yf * torch.rsqrt(var + eps)
    return (yn * (1.0 + pc.use_small(path, scale))).to(y.dtype)


def _dt_and_decay_rate(pc: ParamCtx, path: str, p, dt):
    """softplus(dt + dt_bias) in f32, and A = -exp(a_log)."""
    dt = F.softplus(dt.to(torch.float32)
                    + pc.use_small(f"{path}/dt_bias", p["dt_bias"]).to(torch.float32))
    A = -torch.exp(pc.use_small(f"{path}/a_log", p["a_log"]).to(torch.float32))
    return dt, A


def ssm_block(pc: ParamCtx, path: str, p, x, dims: SSMDims):
    """Training/prefill mixer.  x: (B,S,D) -> (B,S,D)."""
    B, S, D = x.shape
    hl, P, N = dims.heads_local, dims.head_dim, dims.d_state

    xr = dense(pc, f"{path}/wx", p["wx"], x)         # (B,S,dl)
    z = dense(pc, f"{path}/wz", p["wz"], x)
    bc = dense(pc, f"{path}/w_bc", p["w_bc"], x)     # replicated
    dt = dense(pc, f"{path}/w_dt", p["w_dt"], x)     # (B,S,hl)

    xr = F.silu(_causal_depthwise_conv(xr, pc.use_small(f"{path}/conv_x", p["conv_x"])))
    bc = F.silu(_causal_depthwise_conv(bc, pc.use_small(f"{path}/conv_bc", p["conv_bc"])))
    Bm, Cm = bc[..., :N], bc[..., N:]

    dt, A = _dt_and_decay_rate(pc, path, p, dt)
    la = dt * A[None, None, :]                       # (B,S,hl), <= 0

    xh = xr.reshape(B, S, hl, P)
    xdt = xh * dt[..., None].to(xh.dtype)
    y, _ = _ssd_scan(xdt, la.to(xh.dtype), Bm, Cm, dims.chunk)
    d_skip = pc.use_small(f"{path}/d_skip", p["d_skip"]).to(xh.dtype)
    y = y + xh * d_skip[None, None, :, None]

    y = y.reshape(B, S, dims.d_inner_local)
    y = _gated_norm(pc, f"{path}/norm", p["norm"], y, z)
    out = dense(pc, f"{path}/wo", p["wo"], y)
    return sp_out(pc, out)


# ---------------------------------------------------------------------------
# Decode path: O(1) per token: constant state, no KV cache growth.
# ---------------------------------------------------------------------------


class SSMCache(NamedTuple):
    """One mixer's decode state; layer-stacked caches carry a leading
    ``(L,)`` on every field."""

    state: torch.Tensor       # (B, H_local, N, P)
    conv_x: torch.Tensor      # (B, W-1, d_inner_local)
    conv_bc: torch.Tensor     # (B, W-1, 2N)


def init_ssm_cache(batch: int, dims: SSMDims, dtype=torch.bfloat16, *, device=None,
                   lead=()) -> SSMCache:
    lead = tuple(lead) + (batch,)
    kw = {"dtype": dtype, "device": device}
    return SSMCache(
        state=torch.zeros(lead + (dims.heads_local, dims.d_state, dims.head_dim), **kw),
        conv_x=torch.zeros(lead + (dims.conv_width - 1, dims.d_inner_local), **kw),
        conv_bc=torch.zeros(lead + (dims.conv_width - 1, 2 * dims.d_state), **kw))


def stack_caches(per_layer: list) -> SSMCache:
    """Per-layer :class:`SSMCache` s as one layer-stacked cache (new tensors)."""
    return SSMCache(*(torch.stack(ts) for ts in zip(*per_layer)))


def ssm_decode_step(pc: ParamCtx, path: str, p, x, cache: SSMCache, dims: SSMDims):
    """x: (B, 1, D) -> (y, new cache).  ``cache`` is read, never written."""
    B = x.shape[0]
    hl, P, N = dims.heads_local, dims.head_dim, dims.d_state

    xr = dense(pc, f"{path}/wx", p["wx"], x)
    z = dense(pc, f"{path}/wz", p["wz"], x)
    bc = dense(pc, f"{path}/w_bc", p["w_bc"], x)
    dt = dense(pc, f"{path}/w_dt", p["w_dt"], x)

    # rolling conv windows
    cx = torch.cat([cache.conv_x, xr.to(cache.conv_x.dtype)], dim=1)
    cb = torch.cat([cache.conv_bc, bc.to(cache.conv_bc.dtype)], dim=1)
    kx = pc.use_small(f"{path}/conv_x", p["conv_x"])
    kb = pc.use_small(f"{path}/conv_bc", p["conv_bc"])
    xr1 = F.silu(torch.einsum("bwc,wc->bc", cx.to(kx.dtype), kx))[:, None, :]
    bc1 = F.silu(torch.einsum("bwc,wc->bc", cb.to(kb.dtype), kb))[:, None, :]
    Bm, Cm = bc1[..., :N], bc1[..., N:]

    dtv, A = _dt_and_decay_rate(pc, path, p, dt)
    dtv = dtv[:, 0]                                  # (B, hl)
    decay = torch.exp(dtv * A[None, :])

    xh = xr1.reshape(B, hl, P)
    upd = torch.einsum("bn,bhp->bhnp", Bm[:, 0].to(torch.float32),
                       (xh * dtv[..., None].to(xh.dtype)).to(torch.float32))
    state = cache.state.to(torch.float32) * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].to(torch.float32), state).to(x.dtype)
    d_skip = pc.use_small(f"{path}/d_skip", p["d_skip"]).to(xh.dtype)
    y = y + xh * d_skip[None, :, None]

    y = y.reshape(B, 1, dims.d_inner_local)
    y = _gated_norm(pc, f"{path}/norm", p["norm"], y, z)
    out = pc.ctx.psum_model(dense(pc, f"{path}/wo", p["wo"], y))
    new = SSMCache(state=state.to(cache.state.dtype), conv_x=cx[:, 1:], conv_bc=cb[:, 1:])
    return out, new
