"""Attention: GQA/MQA/MHA with tensor parallelism over heads, with
contiguous or paged KV caches.

Counterpart of ``repro/models/attention.py``.  Execution paths:

* ``full``    — materialized scores (short sequences).
* ``chunked`` — online softmax over key/value chunks in plain PyTorch.
* ``flash``   — the flash-attention kernel (prefill fast path).
* decode      — one query token against a :class:`KVCache` slab or a
  :class:`PagedKVCache` (shared page pool + per-slot page tables;
  ``impl="flash"`` walks the tables inside the flash-decode kernel).
* cross       — queries against an encoder/image memory, its K/V projected
  once at prefill (:func:`project_cross_kv`) and held as bare tensors;
  materialized scores, as in the reference.

Caches are updated IN PLACE: a decode step writes its token's K/V into the
pool (or slab) it was given and returns the cache with the lengths advanced;
prefill writes the prompt's pages into the pools it was given.  The values
are those the reference's functional updates produce.  The reference's
``.at[].set(mode="drop")`` writes go through :func:`_put_rows`, which drops
them explicitly (torch would raise on the out-of-range "drop" index).

Head sharding, as in the reference: q heads split over the model axis; KV
heads split when ``n_kv % tp == 0`` and otherwise replicated on every shard,
and then the self-attention cache is **sequence-parallel**: shard t holds
the positions ``[t*S_max/tp, (t+1)*S_max/tp)`` with every KV head, a decode
token is written only by the shard that owns its position, and the
one-token attention gathers q to all heads and merges the shards' partials
with a distributed online softmax (``pmax`` of the maxima, ``psum`` of the
rescaled sums), through the flash-decode kernel's unnormalised ``(acc, m,
l)`` on the paged layout.  Cross-attention (VLM, enc-dec) has no
sequence-parallel form: its K/V over the memory are computed whole on every
shard, and where the KV heads replicate each shard expands them to all q
heads and keeps its own q-head range.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ParamCtx, init_dense
from repro_torch.models.layers import apply_rope, dense, rope_tables, sp_out

@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv: int
    head_dim: int
    d_model: int
    tp: int
    causal: bool = True
    rope_theta: float = 1e4
    chunk_q: int = 512
    chunk_kv: int = 1024

    @property
    def heads_local(self) -> int:
        assert self.n_heads % self.tp == 0, "q heads must divide tp"
        return self.n_heads // self.tp

    @property
    def kv_sharded(self) -> bool:
        return self.n_kv % self.tp == 0 and self.n_kv >= self.tp

    @property
    def kv_local(self) -> int:
        return self.n_kv // self.tp if self.kv_sharded else self.n_kv

    @property
    def group(self) -> int:
        """Queries per KV head, in local terms."""
        return self.heads_local // self.kv_local if self.kv_sharded \
            else self.n_heads // self.n_kv


def kv_cache_seq_parallel(dims: AttnDims) -> bool:
    """Whether the KV heads replicate over tp, so the self-attention cache
    is sharded over the sequence instead."""
    return dims.tp > 1 and not dims.kv_sharded


def init_attention(gen: torch.Generator, dims: AttnDims, *, lead=(), device=None,
                   dtype=torch.float32) -> dict:
    """``{"wq", "wk", "wv", "wo"}`` with ``lead`` stack dims, drawn in that
    order."""
    d, hd = dims.d_model, dims.head_dim
    kw = {"lead": lead, "device": device, "dtype": dtype}
    return {"wq": init_dense(gen, d, dims.heads_local * hd, **kw),
            "wk": init_dense(gen, d, dims.kv_local * hd, **kw),
            "wv": init_dense(gen, d, dims.kv_local * hd, **kw),
            "wo": init_dense(gen, dims.heads_local * hd, d, **kw)}


def _project_qkv(pc: ParamCtx, path, p, x, x_kv, dims: AttnDims, q_pos, kv_pos):
    B = x.shape[0]
    q = dense(pc, f"{path}/wq", p["wq"], x).reshape(B, -1, dims.heads_local, dims.head_dim)
    k = dense(pc, f"{path}/wk", p["wk"], x_kv).reshape(B, -1, dims.kv_local, dims.head_dim)
    v = dense(pc, f"{path}/wv", p["wv"], x_kv).reshape(B, -1, dims.kv_local, dims.head_dim)
    if q_pos is not None:  # rope (self-attention only)
        cq, sq = rope_tables(q_pos, dims.head_dim, dims.rope_theta)
        ck, sk = rope_tables(kv_pos, dims.head_dim, dims.rope_theta)
        q = apply_rope(q, cq, sq)
        k = apply_rope(k, ck, sk)
    return q, k, v


def _expand_kv(k, dims: AttnDims, tp_idx=None):
    """(B, S, KVl, hd) -> (B, S, Hl, hd): repeat each kv head ``group``x
    (``jnp.repeat`` order: head h uses kv head h // group).

    KV-sharded: the local kv heads expand to exactly the local q heads.
    KV replicated under tp > 1: expand to ALL q heads, then keep shard
    ``tp_idx``'s q-head range (``tp_idx=None``: all of them, for the
    sequence-parallel decode)."""
    e = torch.repeat_interleave(k, dims.group, dim=2)
    if dims.kv_sharded or dims.tp == 1 or tp_idx is None:
        return e
    hl = dims.heads_local
    return e[:, :, tp_idx * hl:(tp_idx + 1) * hl]


def _full_attention(q, k, v, causal: bool, q_off: int = 0):
    """q: (B,Sq,H,hd), k/v: (B,Sk,H,hd) — materialized scores."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if causal:
        iq = torch.arange(q.shape[1], device=q.device)[:, None] + q_off
        ik = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(ik <= iq, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _chunked_attention(q, k, v, causal: bool, chunk_kv: int):
    """Online-softmax over KV chunks (flash-style, O(S) memory)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    n_chunks = Sk // chunk_kv
    scale = hd ** -0.5
    qf = q.to(torch.float32) * scale
    iq = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, H, Sq), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        ks = k[:, ci * chunk_kv:(ci + 1) * chunk_kv]
        vs = v[:, ci * chunk_kv:(ci + 1) * chunk_kv]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, ks.to(torch.float32))
        if causal:
            ik = ci * chunk_kv + torch.arange(chunk_kv, device=q.device)[None, :]
            s = torch.where(ik <= iq, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                    vs.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)  # (B,Sq,H,hd)


def self_attention(pc: ParamCtx, path: str, p, x, dims: AttnDims,
                   *, impl: str = "auto"):
    """Prefill self-attention.  Returns (y, (k, v)) with local KV.

    ``impl``: ``full`` (materialized scores), ``chunked`` (online softmax),
    ``flash`` (the flash-attention kernel — the prefill fast path), or
    ``auto``.
    """
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(pc, path, p, x, x, dims, pos, pos)
    tp_idx = pc.ctx.tp_index()
    ke, ve = _expand_kv(k, dims, tp_idx), _expand_kv(v, dims, tp_idx)
    if impl == "auto":
        impl = "chunked" if S > 4096 else "full"
    if impl == "flash":
        # (B,S,H,hd) -> kernel layout (B,H,S,hd) and back
        yt = ops.flash_attention(q.transpose(1, 2), ke.transpose(1, 2),
                                 ve.transpose(1, 2), causal=dims.causal)
        y = yt.transpose(1, 2)
    elif impl == "chunked":
        y = _chunked_attention(q, ke, ve, dims.causal, min(dims.chunk_kv, S))
    else:
        y = _full_attention(q, ke, ve, dims.causal)
    B = x.shape[0]
    y = y.reshape(B, S, dims.heads_local * dims.head_dim)
    out = dense(pc, f"{path}/wo", p["wo"], y)
    return sp_out(pc, out), (k, v)


def project_cross_kv(pc: ParamCtx, path: str, p, memory, dims: AttnDims):
    """Cross-attention K/V over a memory (B, S_m, D), computed once at
    prefill; the decode steps reuse them."""
    B = memory.shape[0]
    k = dense(pc, f"{path}/wk", p["wk"], memory).reshape(B, -1, dims.kv_local, dims.head_dim)
    v = dense(pc, f"{path}/wv", p["wv"], memory).reshape(B, -1, dims.kv_local, dims.head_dim)
    return k, v


def cross_attention_cached(pc: ParamCtx, path: str, p, x, k, v, dims: AttnDims):
    """Cross-attention of x (B, S, D) against precomputed K/V (B, S_m, KVl,
    hd): no mask, no rope.  The shard's q heads always take their own range
    of the expanded K/V (``tp_idx`` given: never the sequence-parallel
    decode's all-heads expansion)."""
    B, S = x.shape[0], x.shape[1]
    q = dense(pc, f"{path}/wq", p["wq"], x).reshape(B, -1, dims.heads_local, dims.head_dim)
    tp_idx = pc.ctx.tp_index()
    y = _full_attention(q, _expand_kv(k.to(q.dtype), dims, tp_idx),
                        _expand_kv(v.to(q.dtype), dims, tp_idx), causal=False)
    y = y.reshape(B, S, dims.heads_local * dims.head_dim)
    return pc.ctx.psum_model(dense(pc, f"{path}/wo", p["wo"], y))


def cross_attention(pc: ParamCtx, path: str, p, x, memory, dims: AttnDims):
    """Decoder -> encoder/image-memory attention (no causal mask, no rope)."""
    q, k, v = _project_qkv(pc, path, p, x, memory, dims, None, None)
    tp_idx = pc.ctx.tp_index()
    y = _full_attention(q, _expand_kv(k, dims, tp_idx), _expand_kv(v, dims, tp_idx),
                        causal=False)
    B, S = x.shape[0], x.shape[1]
    y = y.reshape(B, S, dims.heads_local * dims.head_dim)
    return sp_out(pc, dense(pc, f"{path}/wo", p["wo"], y))


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, KVl, hd)  [(L, ...) when layer-stacked]
    v: torch.Tensor
    length: torch.Tensor     # (B,) int32: tokens already cached, per sequence


class PagedKVCache(NamedTuple):
    """Paged decode cache: fixed-size pages allocated from a shared pool.

    ``k_pages``/``v_pages``: ``(N_pool, page, KVl, hd)`` shared by every
    slot.  ``page_table``: ``(B, n_pmax)`` int32 — slot b's logical page
    ``j`` lives at pool row ``page_table[b, j]``; ``-1`` marks an
    unallocated page (reads of it are masked, writes to it are dropped).
    ``length``: ``(B,)`` int32 tokens cached per sequence.  Layer-stacked
    caches carry a leading ``(L,)`` on every field.
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    length: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[-3]


def init_kv_cache(batch: int, s_max: int, dims: AttnDims, dtype=torch.bfloat16,
                  *, device=None, lead=()):
    """A zeroed contiguous cache: ``(B, S_loc, KVl, hd)`` slabs, ``S_loc =
    s_max // tp`` on the sequence-parallel layout (``s_max`` otherwise)."""
    s_local = s_max // dims.tp if kv_cache_seq_parallel(dims) else s_max
    shape = tuple(lead) + (batch, s_local, dims.kv_local, dims.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(tuple(lead) + (batch,), dtype=torch.int32, device=device))


def init_paged_kv_cache(batch: int, s_max: int, dims: AttnDims,
                        dtype=torch.bfloat16, *, page_size: int,
                        pool_pages: int | None = None, device=None,
                        lead=()) -> PagedKVCache:
    """Paged cache with an all-unallocated page table (entries -1).

    ``pool_pages`` is the per-shard pool; it defaults to the contiguous
    footprint (``batch * S_loc / page``); drivers shrink it to the
    workload's demand.  On the sequence-parallel layout a slot's logical
    pages cover the shard's ``S_loc = s_max / tp`` positions.
    """
    seqpar = kv_cache_seq_parallel(dims)
    if seqpar and s_max % dims.tp:
        raise ValueError(f"s_max={s_max} must divide tp={dims.tp} for the "
                         "sequence-parallel paged cache")
    s_local = s_max // dims.tp if seqpar else s_max
    if s_local % page_size:
        raise ValueError(f"page_size={page_size} must divide the per-shard "
                         f"sequence capacity {s_local}")
    n_pmax = s_local // page_size
    if pool_pages is None:
        pool_pages = batch * n_pmax
    lead = tuple(lead)
    shape = lead + (pool_pages, page_size, dims.kv_local, dims.head_dim)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device),
                        torch.full(lead + (batch, n_pmax), -1, dtype=torch.int32,
                                   device=device),
                        torch.zeros(lead + (batch,), dtype=torch.int32, device=device))


def demote_kv_cache(caches, dtype):
    """Cast a KV cache's key/value storage to ``dtype`` mid-run (page tables
    and per-slot lengths are kept)."""
    if isinstance(caches, PagedKVCache):
        return caches._replace(k_pages=caches.k_pages.to(dtype),
                               v_pages=caches.v_pages.to(dtype))
    if isinstance(caches, KVCache):
        return caches._replace(k=caches.k.to(dtype), v=caches.v.to(dtype))
    return caches


def _check_prompt_fits(S_p: int, S_loc: int, dims: AttnDims) -> None:
    S_glob = S_loc * (dims.tp if kv_cache_seq_parallel(dims) else 1)
    if S_p > S_glob:
        raise ValueError(
            f"prompt length {S_p} exceeds the KV-cache capacity {S_glob} "
            "(s_max); raise s_max or bucket the request — refusing to "
            "silently truncate the prompt")


def _prompt_lens(B: int, S_p: int, prompt_lens, device):
    if prompt_lens is None:
        return torch.full((B,), S_p, dtype=torch.int32, device=device)
    return prompt_lens.to(torch.int32)


def _put_rows(pool, idx, ok, rows) -> None:
    """``pool[idx[i]] = rows[i]`` for every ``i`` with ``ok[i]``; the other
    writes are DROPPED (the reference's ``.at[].set(mode="drop")``).

    Data-dependent indexing (``nonzero``, boolean masks) would stall the host
    on the device once per layer, so the drop is done without it: a dropped
    entry repeats the first kept entry's write (same row, same value), or,
    when nothing is kept, rewrites row 0 with its own contents.  Kept
    entries target distinct rows by construction, so every row written gets
    exactly one value.
    """
    # (1,)-shaped, not 0-d: indexing with a 0-d tensor would read it on the host
    first = torch.argmax(ok.to(torch.uint8)).reshape(1)   # 0 when nothing is kept
    any_ok = ok.any()
    idx = torch.where(ok, idx, torch.where(any_ok, idx[first], 0))
    shape = (-1,) + (1,) * (rows.ndim - 1)
    rows = torch.where(ok.reshape(shape), rows,
                       torch.where(any_ok, rows[first], pool[:1]))
    pool.index_put_((idx,), rows.to(pool.dtype))


def prefill_kv_cache(pc: ParamCtx, cache, k, v, dims: AttnDims, prompt_lens=None):
    """Write a full prompt's K/V (B, S_p, KVl, hd) into a cache, in place.

    Works for both storage layouts.  ``prompt_lens``: optional (B,) per-slot
    true lengths when the prompt batch is right-padded to a bucket; lengths
    default to S_p.  Prompts longer than the cache raise instead of
    truncating.  Positions ``>= prompt_lens[b]`` keep the cache's contents.
    On the sequence-parallel layout each shard keeps the prompt positions of
    its own range.
    """
    if isinstance(cache, PagedKVCache):
        return _prefill_paged(pc, cache, k, v, dims, prompt_lens)
    S_loc, S_p = cache.k.shape[1], k.shape[1]
    _check_prompt_fits(S_p, S_loc, dims)
    plens = _prompt_lens(k.shape[0], S_p, prompt_lens, k.device)
    base = pc.ctx.tp_index() * S_loc if kv_cache_seq_parallel(dims) else 0
    gpos = base + torch.arange(S_loc, device=k.device)
    idx = torch.clamp(gpos, 0, S_p - 1)
    sel = (gpos[None, :] < plens[:, None])[:, :, None, None]
    cache.k.copy_(torch.where(sel, k.to(cache.k.dtype)[:, idx], cache.k))
    cache.v.copy_(torch.where(sel, v.to(cache.v.dtype)[:, idx], cache.v))
    return KVCache(cache.k, cache.v, plens)


def _prefill_paged(pc: ParamCtx, cache: PagedKVCache, k, v, dims: AttnDims,
                   prompt_lens=None) -> PagedKVCache:
    B, S_p = k.shape[0], k.shape[1]
    n_pmax = cache.page_table.shape[1]
    page = cache.page_size
    S_loc = n_pmax * page
    _check_prompt_fits(S_p, S_loc, dims)
    plens = _prompt_lens(B, S_p, prompt_lens, k.device)
    base = pc.ctx.tp_index() * S_loc if kv_cache_seq_parallel(dims) else 0
    gpos = base + torch.arange(S_loc, device=k.device)
    idx = torch.clamp(gpos, 0, S_p - 1)
    sel = gpos[None, :] < plens[:, None]                       # (B, S_loc)
    pt = cache.page_table.to(torch.long).reshape(-1)           # (B * n_pmax,)

    def write(pages, src):
        src_pg = src.to(pages.dtype)[:, idx].reshape((B * n_pmax, page) + src.shape[2:])
        content = torch.where(sel.reshape(B * n_pmax, page)[..., None, None],
                              src_pg, pages[pt.clamp(min=0)])
        # unique targets by construction (a page belongs to one slot); the
        # unallocated pages' writes drop
        _put_rows(pages, pt, pt >= 0, content)

    write(cache.k_pages, k)
    write(cache.v_pages, v)
    return PagedKVCache(cache.k_pages, cache.v_pages, cache.page_table, plens)


def _attend_decode(pc: ParamCtx, q, kview, vview, length, dims: AttnDims,
                   extra_mask=None):
    """One-token decode attention over a local contiguous K/V view.

    ``kview``/``vview``: (B, S_loc, KVl, hd) — a contiguous slab or the
    page-gathered reconstruction of one.  Positions ``<= length[b]`` are
    attended (``length`` is the count BEFORE this step's token); ``extra_mask``
    (B, S_loc) further restricts (paged: unallocated pages).  The
    sequence-parallel layout merges the shards' partials with a distributed
    online softmax: q gathered to all heads, the maxima's ``pmax``, the
    sums' and the weighted values' ``psum``.
    Returns y (B, 1, heads_local, hd).
    """
    S_loc = kview.shape[1]
    scale = dims.head_dim ** -0.5
    tp_idx = pc.ctx.tp_index()
    if kv_cache_seq_parallel(dims):
        # every shard needs ALL q heads against its slice of the positions
        qg = pc.ctx.all_gather_model(q, axis=2)                      # (B, 1, H, hd)
        ke = _expand_kv(kview.to(q.dtype), dims)                    # H heads
        ve = _expand_kv(vview.to(q.dtype), dims)
        s = torch.einsum("bqhd,bkhd->bhqk", qg, ke).to(torch.float32) * scale
        gpos = tp_idx * S_loc + torch.arange(S_loc, device=q.device)
        gmask = gpos[None, :] <= length[:, None]                     # (B, S)
        if extra_mask is not None:
            gmask = gmask & extra_mask
        s = torch.where(gmask[:, None, None, :], s, torch.full_like(s, -1e30))
        m_glob = pc.ctx.pmax_model(s.amax(dim=-1))                   # (B, H, 1)
        pexp = torch.exp(s - m_glob[..., None])
        l_glob = pc.ctx.psum_model(pexp.sum(dim=-1))
        acc_glob = pc.ctx.psum_model(torch.einsum("bhqk,bkhd->bhqd", pexp.to(q.dtype), ve))
        y = acc_glob / torch.clamp(l_glob, min=1e-30)[..., None].to(q.dtype)
        y = y.permute(0, 2, 1, 3)                                    # (B, 1, H, hd)
        hl = dims.heads_local                  # back to this shard's heads for wo
        return y[:, :, tp_idx * hl:(tp_idx + 1) * hl]
    ke = _expand_kv(kview.to(q.dtype), dims, tp_idx)
    ve = _expand_kv(vview.to(q.dtype), dims, tp_idx)
    s = torch.einsum("bqhd,bkhd->bhqk", q, ke).to(torch.float32) * scale
    att_mask = torch.arange(S_loc, device=q.device)[None, :] <= length[:, None]
    if extra_mask is not None:
        att_mask = att_mask & extra_mask
    s = torch.where(att_mask[:, None, None, :], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, ve)


def _token_position(length, S_loc: int, dims: AttnDims, tp_idx: int):
    """``(ok, local position)`` of each slot's new token on this shard: the
    sequence-parallel shard that owns global position ``length[b]`` (its
    ``[t*S_loc, (t+1)*S_loc)``) writes it; otherwise every shard, while the
    position is inside its ``S_loc``.  ``ok`` False: nothing is written."""
    if kv_cache_seq_parallel(dims):
        owner = length // S_loc
        ok = owner == tp_idx
        lpos = length - owner * S_loc
    else:
        ok = length < S_loc
        lpos = length
    return ok, torch.where(ok, lpos, torch.zeros_like(lpos))


def decode_self_attention(pc: ParamCtx, path: str, p, x, cache,
                          dims: AttnDims, *, impl: str = "ref"):
    """One-token decode: x (B, 1, D); returns (y, cache with lengths + 1).

    Slot b's new token writes at ``length[b]`` (in place; on the
    sequence-parallel layout only the shard owning that position writes)
    and attends to positions ``<= length[b]``, so sequences admitted at
    different times coexist in one step.  :class:`PagedKVCache` takes
    ``impl="ref"`` (gather pages into the contiguous view) or
    ``impl="flash"`` (the flash-decode kernel walks the page table).
    """
    if isinstance(cache, PagedKVCache):
        return _decode_paged(pc, path, p, x, cache, dims, impl=impl)
    pos = cache.length[:, None]                      # (B, 1) per-seq positions
    q, k, v = _project_qkv(pc, path, p, x, x, dims, pos, pos)
    S_loc = cache.k.shape[1]
    # a slot whose position is not this shard's writes nothing (the
    # reference's where-mask selects no position): it rewrites its own
    # position 0 with its own contents
    ok, tpos = _token_position(cache.length, S_loc, dims, pc.ctx.tp_index())
    b = torch.arange(x.shape[0], device=x.device)
    tpos = tpos.to(torch.long)
    for slab, new in ((cache.k, k), (cache.v, v)):
        slab[b, tpos] = torch.where(ok[:, None, None], new[:, 0].to(slab.dtype),
                                    slab[b, 0])
    y = _attend_decode(pc, q, cache.k, cache.v, cache.length, dims)

    B = x.shape[0]
    y = y.reshape(B, 1, dims.heads_local * dims.head_dim)
    out = pc.ctx.psum_model(dense(pc, f"{path}/wo", p["wo"], y))
    return out, KVCache(cache.k, cache.v, cache.length + 1)


def _paged_write_token(cache: PagedKVCache, k_tok, v_tok, dims: AttnDims, tp_idx: int):
    """Write one token's K/V (B, KVl, hd) at position ``length[b]``, in place.

    The write lands in page ``page_table[b, pos // page]`` at offset
    ``pos % page`` (``pos`` local to the shard); it is DROPPED when the
    position is outside this shard's range or the page is unallocated — a
    slot past its capacity can only lose its own new token, never clobber
    another slot's pages.
    """
    n_pmax = cache.page_table.shape[1]
    page = cache.page_size
    in_range, lpos = _token_position(cache.length.to(torch.long), n_pmax * page, dims, tp_idx)
    j = lpos // page
    off = lpos % page
    pid = torch.gather(cache.page_table.to(torch.long), 1, j[:, None])[:, 0]
    ok = in_range & (pid >= 0)
    row = pid * page + off                    # row of the (N_pool * page) view
    for pages, tok in ((cache.k_pages, k_tok), (cache.v_pages, v_tok)):
        _put_rows(pages.view((-1,) + pages.shape[2:]), row, ok, tok)


def _decode_paged(pc: ParamCtx, path: str, p, x, cache: PagedKVCache,
                  dims: AttnDims, *, impl: str = "ref"):
    pos = cache.length[:, None]
    q, k, v = _project_qkv(pc, path, p, x, x, dims, pos, pos)
    tp_idx = pc.ctx.tp_index()
    _paged_write_token(cache, k[:, 0], v[:, 0], dims, tp_idx)
    new_cache = PagedKVCache(cache.k_pages, cache.v_pages, cache.page_table,
                             cache.length + 1)
    B, n_pmax = cache.page_table.shape
    page = cache.page_size
    if impl == "flash":
        y = _paged_flash_attend(pc, q, new_cache, dims, tp_idx)
    else:
        # reference path: gather pages into the contiguous per-shard view and
        # run the exact slab math
        pids = cache.page_table.to(torch.long).clamp(min=0)
        kview = cache.k_pages[pids].reshape((B, n_pmax * page) + cache.k_pages.shape[2:])
        vview = cache.v_pages[pids].reshape((B, n_pmax * page) + cache.v_pages.shape[2:])
        alloc = torch.repeat_interleave(cache.page_table >= 0, page, dim=1)  # (B, S_loc)
        y = _attend_decode(pc, q, kview, vview, cache.length, dims, extra_mask=alloc)
    y = y.reshape(B, 1, dims.heads_local * dims.head_dim)
    out = pc.ctx.psum_model(dense(pc, f"{path}/wo", p["wo"], y))
    return out, new_cache


def _paged_flash_attend(pc: ParamCtx, q, cache: PagedKVCache, dims: AttnDims, tp_idx: int):
    """Batched flash-decode over the page pool (the flash-decode kernel).

    The kernel returns unnormalised ``(acc, m, l)`` partials over the
    shard's pages.  On the sequence-parallel layout q is gathered to all
    heads, the kernel runs at the shard's local lengths ``clamp(length -
    t*S_loc, 0, S_loc)`` (0 where the slot has no position on the shard:
    ``m = -1e30, l = 0, acc = 0``), and the partials merge across the model
    axis as the reference's distributed softmax does: ``m_glob = pmax(m)``,
    ``l = psum(l * exp(m - m_glob))``, ``acc`` likewise; then the shard's
    own heads are kept.  Returns y (B, 1, heads_local, hd).
    """
    seqpar = kv_cache_seq_parallel(dims)
    B, n_pmax = cache.page_table.shape
    S_loc = n_pmax * cache.page_size
    hd = dims.head_dim
    if seqpar:
        qh = pc.ctx.all_gather_model(q, axis=2)[:, 0]        # (B, H, hd)
        n_q, base = dims.n_heads, tp_idx * S_loc
    else:
        qh = q[:, 0]                                         # (B, Hl, hd)
        n_q, base = dims.heads_local, 0
    kvh = dims.kv_local
    # group q heads by their kv head (matches _expand_kv's repeat order)
    qr = qh.reshape(B, kvh, n_q // kvh, hd)
    # cache.length was already incremented by the write, so it IS the valid
    # token count (including the just-written token); local to the shard
    lloc = torch.clamp(cache.length - base, 0, S_loc)
    acc, m, l = ops.flash_paged_decode(qr, cache.k_pages, cache.v_pages,
                                       cache.page_table, lloc)
    if seqpar:
        m_glob = pc.ctx.pmax_model(m)
        corr = torch.exp(m - m_glob)
        l = pc.ctx.psum_model(l * corr)
        acc = pc.ctx.psum_model(acc * corr)
    y = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)   # (B,KVh,G,hd)
    y = y.reshape(B, 1, n_q, hd)
    if seqpar:
        hl = dims.heads_local
        y = y[:, :, tp_idx * hl:(tp_idx + 1) * hl]
    return y


# ---------------------------------------------------------------------------
# Slot-granular cache merges (continuous batching / bucketed prefill)
# ---------------------------------------------------------------------------


def merge_slot_caches(old, new, keep):
    """Per-slot merge of a tree of layer-stacked caches: ``keep[b]`` takes
    slot b's state from ``new``.

    The tree may be one cache or a dict of caches (a hybrid's ``{"sub0":
    PagedKVCache, "sub1": SSMCache, ...}``, an enc-dec's ``{"self":
    PagedKVCache, "cross_k": Tensor, "cross_v": Tensor}``).
    :class:`KVCache` slabs merge on the slot dim, in place into ``old``.
    :class:`PagedKVCache` pools merge at PAGE granularity through the page
    table: kept slots' pages are copied from ``new`` into ``old``, every
    other pool row is untouched.  Where a decode step wrote ``old``'s
    storage in place, ``new`` holds the same tensors and only the lengths
    (and tables) merge.  Any other leaf is an ``(L, B, ...)`` tensor (an
    :class:`~repro_torch.models.ssm.SSMCache` field, a VLM's or enc-dec's
    cross K/V) and merges into a new tensor.
    """
    kb = keep.to(torch.bool)
    if isinstance(old, PagedKVCache):
        return _merge_paged_stacked(old, new, kb)
    if isinstance(old, KVCache):
        sel = kb.reshape(1, -1, *([1] * (old.k.ndim - 2)))
        if not _same_memory(new.k, old.k):
            old.k.copy_(torch.where(sel, new.k, old.k))
            old.v.copy_(torch.where(sel, new.v, old.v))
        return KVCache(old.k, old.v, torch.where(kb[None, :], new.length, old.length))
    if isinstance(old, dict):
        return {k: merge_slot_caches(v, new[k], kb) for k, v in old.items()}
    if isinstance(old, tuple):
        return type(old)(*(merge_slot_caches(o, n, kb) for o, n in zip(old, new)))
    return torch.where(kb.reshape(1, -1, *([1] * (old.ndim - 2))), new, old)


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` start at the same element of one storage (a
    step wrote the live cache in place); a fake tensor has no data pointer,
    so the storages are compared."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())


def _merge_paged_stacked(old: PagedKVCache, new: PagedKVCache, kb):
    """Layer-stacked (L, ...) paged merge; ``kb`` (B,) is layer-invariant."""
    if not _same_memory(new.k_pages, old.k_pages):
        pt = new.page_table.to(torch.long)                     # (L, B, n_pmax)
        take = ((pt >= 0) & kb[None, :, None]).reshape(pt.shape[0], -1)
        rows = pt.clamp(min=0).reshape(pt.shape[0], -1)
        for layer in range(pt.shape[0]):
            for po, pn in ((old.k_pages, new.k_pages), (old.v_pages, new.v_pages)):
                _put_rows(po[layer], rows[layer], take[layer], pn[layer][rows[layer]])
    return PagedKVCache(old.k_pages, old.v_pages,
                        torch.where(kb[None, :, None], new.page_table, old.page_table),
                        torch.where(kb[None, :], new.length, old.length))


def fresh_slot_caches(caches):
    """Zeroed per-slot state for a prefill pass over a cache tree, KEEPING
    page tables.

    The prefill needs the live tables to place its pages;
    :func:`merge_slot_caches` discards the non-admitted slots' (and any
    untouched) pages afterwards.
    """
    if isinstance(caches, PagedKVCache):
        return PagedKVCache(torch.zeros_like(caches.k_pages),
                            torch.zeros_like(caches.v_pages),
                            caches.page_table, torch.zeros_like(caches.length))
    if isinstance(caches, dict):
        return {k: fresh_slot_caches(v) for k, v in caches.items()}
    if isinstance(caches, tuple):
        return type(caches)(*(fresh_slot_caches(c) for c in caches))
    return torch.zeros_like(caches)
