"""Building-block layers: norms, rotary embeddings, MLPs, embeddings.

Counterparts of ``repro/models/layers.py``, Megatron style: activations are
replicated over the model axis; column-parallel weights split their output
dim, row-parallel ones their input dim and are followed by the model axis's
``psum``; the embedding and the unembedding split the vocabulary.  The
collectives are the axis context's (identities at ``tp = 1``) and carry
gradients (:mod:`repro_torch.dist.collectives`).  Under Megatron sequence
parallelism (``pc.sp`` at ``tp > 1``, the trainer's) the residual stream
between blocks is cut over the sequence: a block's input is all-gathered
(:func:`sp_gather`) and its output reduce-scattered (:func:`sp_out`);
serving runs without it, as the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.common import ParamCtx, QTensor, init_dense


def _sp(pc: ParamCtx) -> bool:
    return pc.sp and pc.ctx.tp > 1


def sp_gather(pc: ParamCtx, x):
    """A block's input: (B, S/tp, D) -> (B, S, D), the all-gather over the
    model axis under sequence parallelism (backward: the reduce-scatter of
    the ranks' parts); without it the replicated ``x`` entering the block's
    rank-local work (backward: the sum of the ranks' parts)."""
    if _sp(pc):
        return pc.ctx.all_gather_model(x, axis=1)
    return pc.ctx.copy_model(x)


def sp_out(pc: ParamCtx, y):
    """A block's output: the reduce-scatter over the sequence under
    sequence parallelism, else the all-reduce over the model axis."""
    if _sp(pc):
        return pc.ctx.psum_scatter_model(y, axis=1)
    return pc.ctx.psum_model(y)


def sp_split(pc: ParamCtx, x):
    """A replicated activation entering the sequence-parallel residual
    stream (an encoder's input): the rank's block of the sequence under
    sequence parallelism (backward: the all-gather of the blocks), else
    ``x``.  The reference reduce-scatters it there (``encdec.py:64``), which
    sums T equal copies: ROADMAP §3, D16."""
    return pc.ctx.split_model(x, axis=1) if _sp(pc) else x


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


def init_mlp(gen: torch.Generator, d: int, d_ff_local: int, act: str, *, lead=(),
             device=None, dtype=torch.float32) -> dict:
    """``{"w_up", "w_down"[, "w_gate"]}`` with ``lead`` stack dims, drawn in
    that order."""
    kw = {"lead": lead, "device": device, "dtype": dtype}
    p = {"w_up": init_dense(gen, d, d_ff_local, **kw),
         "w_down": init_dense(gen, d_ff_local, d, **kw)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = init_dense(gen, d, d_ff_local, **kw)
    return p


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
    """ids: (B, S) global token ids; table: (V/tp, D), the shard's rows
    (ids outside them embed to zero before the model axis's sum)."""
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
    """x: (B, S, D) -> the shard's logits (B, S, V/tp)."""
    return dense(pc, f"{path}/w", w_unembed, x)


def _xent_terms(pc: ParamCtx, lg, labels, vocab_local: int, ignore_id: int,
                vocab: int | None = None):
    """Per-position NLL over (vocab-sharded) f32 logits, and the valid mask.
    The shards agree on the max (``pmax``, a constant to the gradient); the
    denominator and the true-class logit are summed over them.  ``vocab``:
    the model's vocabulary, whose padding columns (ids ``>= vocab`` on the
    last shard) are masked out, so a padded ``1xT`` launch takes the ``1x1``
    model's softmax."""
    lo = pc.ctx.tp_index() * vocab_local
    if vocab is not None and lo + vocab_local > vocab:
        ids = lo + torch.arange(vocab_local, device=lg.device)
        lg = torch.where(ids < vocab, lg, torch.full_like(lg, -torch.inf))
    m = pc.ctx.pmax_model(lg.amax(dim=-1).detach())
    z = torch.exp(lg - m[..., None])
    denom = pc.ctx.psum_model(z.sum(dim=-1))
    local = labels - lo
    in_range = (local >= 0) & (local < vocab_local)
    safe = torch.clamp(local, 0, vocab_local - 1).to(torch.long)
    picked = torch.gather(lg, -1, safe[..., None])[..., 0]
    picked = pc.ctx.psum_model(torch.where(in_range, picked, torch.zeros_like(picked)))
    nll = torch.log(denom) + m - picked
    return nll, labels != ignore_id


def vocab_parallel_xent(pc: ParamCtx, local_logits, labels, vocab_local: int,
                        *, ignore_id: int = -1):
    """Cross-entropy over (vocab-sharded) logits without gathering the vocab.

    Stable log-softmax; labels: (B, S).  Returns (mean_loss, n_tokens).
    """
    nll, valid = _xent_terms(pc, local_logits.to(torch.float32), labels, vocab_local,
                             ignore_id)
    n = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / n, n


def fused_vocab_xent(pc: ParamCtx, path: str, w_unembed, x, labels,
                     vocab_local: int, *, chunk: int = 512, ignore_id: int = -1,
                     vocab: int | None = None):
    """Unembed + cross-entropy, chunked over the sequence.

    Each chunk's logits are recomputed in backward (activation checkpoint,
    the model collectives with them), so the full (B, S, V/tp) logits never
    live at once.  x: (B, S, D) the whole sequence (gathered under sequence
    parallelism); labels: (B, S).  Returns the mean loss over valid
    positions, the same on every model rank.  ``vocab``: see
    :func:`_xent_terms`.
    """
    w = ops.as_array(pc.use(path, w_unembed), pc.compute_dtype)  # quantize once
    B, S, D = x.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError("sequence must divide the xent chunk")

    def chunk_sum(xs, ws, ls):
        nll, valid = _xent_terms(pc, (xs @ ws).to(torch.float32), ls, vocab_local,
                                 ignore_id, vocab)
        return torch.where(valid, nll, torch.zeros_like(nll)).sum()

    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_valid = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(S // c):
        xs, ls = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        nll_sum = nll_sum + checkpoint(chunk_sum, xs, w, ls, use_reentrant=False)
        n_valid = n_valid + (ls != ignore_id).sum(dtype=torch.int32)
    return nll_sum / torch.clamp(n_valid, min=1)


# ---------------------------------------------------------------------------
# Generic dense projection (packed weights go to the quant_matmul kernel)
# ---------------------------------------------------------------------------


def dense(pc: ParamCtx, path: str, w, x):
    """``x @ use(w)`` with leaf-type dispatch: under lazy-quant the packed
    int8 codes go straight to the ``quant_matmul`` kernel."""
    return ops.dense_dispatch(x, pc.use(path, w))
