"""Public kernel entry points + leaf-type dispatch.

Dispatch rule: a CUDA tensor goes to the hand-written kernel, which launches
or raises; a CPU tensor goes to the kernel's plain PyTorch version; a fake
tensor (a step traced under ``FakeTensorMode`` for its roofline) goes to
the trace route, which returns outputs of the right shape and dtype and
records the kernel's node with its cost (:mod:`repro_torch.roofline.count`).
A real tensor never takes the trace route, and nothing falls back from one
route to another.  The entry points also do the layout plumbing around the
kernels (flattening heads into the batch, contiguity, index dtypes).

:func:`dense_dispatch` is the serving fast path's single entry point: given
an activation and either a plain tensor or a
:class:`~repro_torch.models.common.QTensor` weight, it routes packed weights
to ``quant_matmul``, so the int8 codes are the bytes the projection reads;
:func:`expert_dispatch` does the same for a layer's stack of MoE experts.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import sr_quant as sq
from repro_torch.kernels._build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.roofline import count


def _route(t: torch.Tensor, kernel, plain, trace):
    if count.is_traced(t):
        return trace
    if t.is_cuda:
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no kernel for tensors on {t.device}")


# ---- the trace route: outputs of the right shape, the kernel's node recorded --


def _trace_segments(w, offsets, s, d, u, *, ste: bool = True):
    C, P = u.shape
    out = torch.empty((C, P), dtype=torch.float32, device=w.device)
    count.record_kernel(sq.NAME, count.sr_quant_segments_cost(P, C, s.shape[0]),
                        f"C={C} P={P}", ins=(w, offsets, s, d, u), outs=(out,))
    return out


def _trace_segments_keyed(leaves, delta, key, out=None, col: int = 0):
    P, C = sum(x.numel() for x in leaves), delta.shape[0]
    count.record_kernel(sq.KEYED_NAME, count.sr_quant_keyed_cost(P, C), f"C={C} P={P}",
                        ins=(*leaves, delta), outs=(out,))
    return out


def _trace_inline(w, delta, key, out_dtype):
    out = torch.empty(w.shape, dtype=out_dtype, device=w.device)
    count.record_kernel(sq.INLINE_NAME, count.sr_quant_inline_cost(w.numel(), out_dtype),
                        str(tuple(w.shape)), ins=(w, delta), outs=(out,))
    return out


def _trace_pack(g, offsets, step, u, lim, dtype):
    C, P = g.shape
    codes = torch.empty((C, P), dtype=dtype, device=g.device)
    count.record_kernel(sq.PACK_NAME, count.sr_pack_segments_cost(P, C, step.shape[0], dtype),
                        f"C={C} P={P}", ins=(g, offsets, step, u), outs=(codes,),
                        params={"lim": int(lim)})
    return codes


def _trace_pack_keyed(leaves, key, lim, dtype, out=None, col: int = 0):
    C, L = len(leaves[0]), len(leaves)
    P = sum(leaf[0].numel() for leaf in leaves)
    dev = leaves[0][0].device
    codes = out if out is not None else torch.empty((C, P), dtype=dtype, device=dev)
    step = torch.empty(L, dtype=torch.float32, device=dev)
    bad = torch.empty((), dtype=torch.int64, device=dev)
    count.record_kernel(sq.PACK_KEYED_NAME, count.sr_pack_keyed_cost(P, C, L, dtype),
                        f"C={C} P={P}", ins=tuple(g for leaf in leaves for g in leaf),
                        outs=(codes, step, bad), params={"lim": int(lim), "elements": C * P})
    return codes, step, bad


def _trace_pack_scales(leaves):
    C, L = len(leaves[0]), len(leaves)
    P = sum(leaf[0].numel() for leaf in leaves)
    dev = leaves[0][0].device
    fmax = torch.empty((C, L), dtype=torch.float32, device=dev)
    bad = torch.empty((), dtype=torch.int64, device=dev)
    count.record_kernel(sq.PACK_SCALES_NAME, count.sr_pack_keyed_scales_cost(P, C, L),
                        f"C={C} P={P}", ins=tuple(g for leaf in leaves for g in leaf),
                        outs=(fmax, bad), params={"elements": C * P})
    return fmax, bad


def _trace_pack_scaled(leaves, smax, fmax, key, lim, dtype, c0: int = 0, out=None,
                       col: int = 0):
    C, L = len(leaves[0]), len(leaves)
    P = sum(leaf[0].numel() for leaf in leaves)
    dev = leaves[0][0].device
    codes = out if out is not None else torch.empty((C, P), dtype=dtype, device=dev)
    step = torch.empty(L, dtype=torch.float32, device=dev)
    count.record_kernel(sq.PACK_SCALED_NAME, count.sr_pack_keyed_scaled_cost(P, C, L, dtype),
                        f"C={C} P={P}",
                        ins=(*(g for leaf in leaves for g in leaf), smax, fmax),
                        outs=(codes, step), params={"lim": int(lim), "elements": C * P})
    return codes, step


def _trace_quant_matmul(x, codes, scale):
    (M, K), N = x.shape, codes.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    count.record_kernel(qm.NAME, count.quant_matmul_cost(M, K, N, x.dtype, codes.dtype),
                        f"M={M} K={K} N={N} x={count.dtype_name(x.dtype)} "
                        f"codes={count.dtype_name(codes.dtype)}", ins=(x, codes, scale),
                        outs=(out,))
    return out


def _trace_attention(q, k, v, causal: bool = True):
    BH, S, D = q.shape
    out = torch.empty_like(q)
    count.record_kernel("flash_attention",
                        count.flash_attention_cost(BH, S, D, q.dtype, causal),
                        f"BH={BH} S={S} D={D} causal={causal} dtype={count.dtype_name(q.dtype)}",
                        ins=(q, k, v), outs=(out,),
                        params={"causal": bool(causal)})
    return out


def _trace_decode(q, k_pages, v_pages, page_table, lengths):
    """K5's bytes follow the slots' lengths, which a traced tensor does not
    hold: each slot counts the record's ``decode_len`` tokens (the cell's
    ``seq_len``, or a list of per-slot lengths), at most its pages' reach."""
    B, KV, G, hd = q.shape
    page, n_pmax = k_pages.shape[1], page_table.shape[1]
    rec, cap = count.active(), n_pmax * page
    lens = [cap] * B if rec is None or rec.decode_len is None else rec.decode_len
    if isinstance(lens, int):
        lens = [lens] * B
    if len(lens) != B:
        raise ValueError(f"decode_len gives {len(lens)} slot lengths for {B} slots")
    tokens = sum(min(int(n), cap) for n in lens)
    acc = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, KV, G, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((B, KV, G, 1), dtype=torch.float32, device=q.device)
    count.record_kernel("flash_decode",
                        count.flash_decode_cost(B, KV, G, hd, q.dtype, k_pages.dtype, n_pmax,
                                                tokens),
                        f"B={B} KV={KV} G={G} hd={hd} page={page} n_pmax={n_pmax} "
                        f"q={count.dtype_name(q.dtype)} pool={count.dtype_name(k_pages.dtype)} "
                        f"tokens={tokens}",
                        ins=(q, k_pages, v_pages, page_table, lengths), outs=(acc, m, l))
    return acc, m, l


def sr_quantize_segments(w: torch.Tensor, offsets: torch.Tensor, s: torch.Tensor,
                         delta: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """SR of every (client, leaf) segment in one K1 call -> (C, P) f32.

    ``w`` (P,) the leaves concatenated, ``offsets`` (L+1,) int32, ``s`` (L,)
    per-leaf scales, ``delta`` (C,) per-client resolutions, ``u`` (C, P)
    uniforms.  Element (c, p) of leaf l is ``core.quantization.sr_quantize``
    of it at ``step = s[l] * delta[c]``: rounded, clipped to ``[-s, s]``,
    ``step == 0`` bypassed, emitted as ``w + (q - w)``.
    """
    fn = _route(w, sq.sr_quant_segments_cuda, sq.sr_quant_segments_plain,
                _trace_segments)
    return fn(w.contiguous(), offsets.contiguous(), s.contiguous(), delta.contiguous(),
              u.contiguous())


def sr_quantize_segments_keyed(leaves, delta: torch.Tensor, key: int) -> torch.Tensor:
    """SR of every (client, leaf) segment in one call of K1's keyed segment
    entry -> (C, P) f32, the leaves read where they lie.

    ``leaves`` the round's quantizable leaves (any shapes), ``delta`` (C,)
    per-client resolutions, ``key`` the round's 64-bit key.  The value is
    :func:`sr_quantize_segments` of the leaves concatenated, with ``s[l] =
    tensor_scale(leaf l)`` and client ``c``'s uniforms stream ``c`` of
    :func:`~repro_torch.kernels.ref.philox_uniforms_plain` under ``key``.
    More leaves than one table holds go in groups of at most
    ``sr_quant.SEG_MAX_LEAVES``, one call a group into the same output, each
    drawing the tree's columns: the value does not depend on the grouping.
    """
    fn = _route(delta, sq.sr_quant_segments_keyed_cuda, sq.sr_quant_segments_keyed_plain,
                _trace_segments_keyed)
    flat = [x.to(torch.float32).contiguous().reshape(-1) for x in leaves]
    delta = delta.to(torch.float32).contiguous()
    out = torch.empty((delta.shape[0], sum(x.numel() for x in flat)), dtype=torch.float32,
                      device=delta.device)
    for l0, l1, col in sq.table_groups([x.numel() for x in flat], 1, sq.KEYED_NAME):
        fn(flat[l0:l1], delta, int(key), out=out, col=col)
    return out


def sr_quantize_inline(w: torch.Tensor, delta: torch.Tensor, key: int,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """SR of one weight use in one call of K1's inline entry -> ``w.shape``
    in ``out_dtype`` (f32 or bf16).

    ``delta`` a one-element f32 tensor on ``w``'s device, ``key`` the site's
    64-bit key.  The value is ``core.quantization.sr_quantize`` of ``w``
    with the uniforms :func:`~repro_torch.kernels.ref.philox_uniforms_plain`
    of ``key``, cast to ``out_dtype``; scale and uniforms are made inside.
    """
    fn = _route(w, sq.sr_quant_inline_cuda, sq.sr_quant_inline_plain, _trace_inline)
    return fn(w.to(torch.float32).contiguous(), delta.reshape(-1), int(key), out_dtype)


def sr_quantize_fused(w: torch.Tensor, bits: int, u: torch.Tensor) -> torch.Tensor:
    """Fake-quantize a 2-D weight with SR at ``bits`` (one K1 call).

    The reference's ``kernels/ops.sr_quantize_fused`` with the uniforms ``u``
    given: ``s = max(max|w|, 1e-30)``, rounded at pitch ``s / (2^bits - 1)``,
    clipped to ``[-s, s]``, cast back to ``w.dtype``.  XLA compiles that
    division by a constant into a multiplication by the constant's f32
    reciprocal, so the pitch is ``s * fl32(1 / (2^bits - 1))`` here too —
    bit-equal to the reference as it runs, and the same pitch formula as
    ``core.quantization.sr_quantize``.
    """
    if w.ndim != 2 or u.shape != w.shape:
        raise ValueError(f"sr_quantize_fused: w must be 2-D and u of its shape, got "
                         f"{tuple(w.shape)} and {tuple(u.shape)}")
    wf = w.to(torch.float32).reshape(-1)
    s = torch.clamp(wf.abs().amax(), min=1e-30).reshape(1)
    one = torch.ones(1, dtype=torch.float32)
    delta = (one / torch.tensor([2.0**bits - 1.0], dtype=torch.float32)).to(w.device)
    offsets = torch.tensor([0, wf.numel()], dtype=torch.int32, device=w.device)
    fn = _route(w, sq.sr_quant_segments_cuda, sq.sr_quant_segments_plain,
                _trace_segments)
    q = fn(wf.contiguous(), offsets, s, delta,
           u.to(torch.float32).reshape(1, -1).contiguous(), ste=False)
    return q.reshape(w.shape).to(w.dtype)


def sr_pack_segments(g: torch.Tensor, offsets: torch.Tensor, step: torch.Tensor,
                     u: torch.Tensor, lim: int, dtype: torch.dtype) -> torch.Tensor:
    """SR onto integer codes of every (client, leaf) segment in one K2 call.

    ``g`` (C, P) f32 the clients' leaves concatenated, ``offsets`` (L+1,)
    int32, ``step`` (L,) per-leaf pitch, ``u`` (C, P) uniforms.  Returns
    ``(C, P)`` codes of ``dtype`` (int8/int16/int32): ``clip(floor(t) + [u <
    t - floor(t)], -lim, lim)`` with ``t = g / step``, saturated to ``dtype``.
    """
    fn = _route(g, sq.sr_pack_segments_cuda, sq.sr_pack_segments_plain, _trace_pack)
    return fn(g.contiguous(), offsets.contiguous(), step.contiguous(), u.contiguous(),
              lim, dtype)


def sr_pack_keyed(leaves, key: int, lim: int, dtype: torch.dtype):
    """The SR wire's whole quantizer in one call of K2's keyed entry.

    ``leaves``: per leaf, the C clients' gradients (one shape a leaf), read
    where they lie.  Each client's leaf is guarded (NaN -> 0, +-Inf -> +- its
    largest finite |g|; a no-op on finite gradients), the leaf's pitch is
    ``step = s * fl32(1 / lim)`` with ``s`` the max over the clients (1 where
    0), and element ``(c, p)`` of the leaves concatenated takes stream ``c``
    of :func:`~repro_torch.kernels.ref.philox_uniforms_plain` under ``key``.
    Returns ``(codes (C, P) of dtype, step (L,) f32, the non-finite count ()
    int64)``, all on the gradients' device.  More (client, leaf) pointers
    than one table holds go in groups of whole leaves, ``C`` x leaves at
    most ``sr_quant.SEG_MAX_PTRS``, one call a group into the same codes,
    each drawing the tree's columns; the groups' counts are summed on the
    card, so the guard stays one decision and "raise" reads one number.
    """
    fn = _route(leaves[0][0], sq.sr_pack_keyed_cuda, sq.sr_pack_keyed_plain,
                _trace_pack_keyed)
    flat = [[g.to(torch.float32).contiguous().reshape(-1) for g in leaf] for leaf in leaves]
    C = len(flat[0])
    groups = sq.table_groups([leaf[0].numel() for leaf in flat], C, sq.PACK_KEYED_NAME)
    if len(groups) == 1:        # the step and the count need no gathering
        return fn(flat, int(key), lim, dtype)
    codes = torch.empty((C, sum(leaf[0].numel() for leaf in flat)), dtype=dtype,
                        device=flat[0][0].device)
    steps, bads = [], []
    for l0, l1, col in groups:
        _codes, step, bad = fn(flat[l0:l1], int(key), lim, dtype, out=codes, col=col)
        steps.append(step)
        bads.append(bad)
    return codes, torch.cat(steps), torch.stack(bads).sum()


def _rows_f32(leaves) -> list:
    return [[g.to(torch.float32).contiguous().reshape(-1) for g in leaf] for leaf in leaves]


def sr_pack_keyed_scales(leaves):
    """K2's pass 1 alone, for a wire whose rows lie on several ranks.

    ``leaves``: per leaf, this rank's ``C`` rows of gradients (one shape a
    leaf).  Returns ``(fmax (C, L) f32, the non-finite count () int64)``:
    each row's largest finite |g| a leaf and the count over every row and
    leaf, on the gradients' device.  Trees past one table go in groups of
    whole leaves, as :func:`sr_pack_keyed`, the counts summed on the card.
    """
    fn = _route(leaves[0][0], sq.sr_pack_keyed_scales_cuda, sq.sr_pack_keyed_scales_plain,
                _trace_pack_scales)
    flat = _rows_f32(leaves)
    groups = sq.table_groups([leaf[0].numel() for leaf in flat], len(flat[0]),
                             sq.PACK_SCALES_NAME)
    if len(groups) == 1:
        return fn(flat)
    outs = [fn(flat[l0:l1]) for l0, l1, _col in groups]
    return torch.cat([f for f, _b in outs], dim=1), torch.stack([b for _f, b in outs]).sum()


def sr_pack_keyed_scaled(leaves, smax: torch.Tensor, fmax: torch.Tensor, key: int, lim: int,
                         dtype: torch.dtype, c0: int = 0):
    """K2's pass 2 given the scales: the codes of this rank's rows.

    ``smax`` (L,) the shared scale of each leaf (the max over every rank's
    pass 1), ``fmax`` (C, L) this rank's rows' own (the guard's clamp); row
    ``c`` draws stream ``c0 + c`` of
    :func:`~repro_torch.kernels.ref.philox_uniforms_plain` under ``key``.
    Returns ``(codes (C, P) of dtype, step (L,) f32)``: over the ranks, the
    one-call :func:`sr_pack_keyed`'s rows and pitch bit for bit.
    """
    fn = _route(leaves[0][0], sq.sr_pack_keyed_scaled_cuda, sq.sr_pack_keyed_scaled_plain,
                _trace_pack_scaled)
    flat = _rows_f32(leaves)
    C = len(flat[0])
    groups = sq.table_groups([leaf[0].numel() for leaf in flat], C, sq.PACK_SCALED_NAME)
    if len(groups) == 1:
        return fn(flat, smax, fmax, int(key), lim, dtype, int(c0))
    codes = torch.empty((C, sum(leaf[0].numel() for leaf in flat)), dtype=dtype,
                        device=flat[0][0].device)
    steps = []
    for l0, l1, col in groups:
        _codes, step = fn(flat[l0:l1], smax[l0:l1].contiguous(),
                          fmax[:, l0:l1].contiguous(), int(key), lim, dtype, int(c0),
                          out=codes, col=col)
        steps.append(step)
    return codes, torch.cat(steps)


def sr_pack_fused(w: torch.Tensor, bits: int, u: torch.Tensor):
    """Pack a 2-D weight to int8 codes + scalar scale (one K2 call).

    The reference's ``kernels/ops.sr_pack_fused`` with the uniforms ``u``
    given: ``s = max(max|w|, 1e-30)``, pitch ``s * Delta`` (``Delta = 1 /
    (2^bits - 1)`` in f32), codes clipped to ``±(2^bits - 1)``.  Returns
    ``(codes, s * Delta)``.
    """
    if w.ndim != 2 or u.shape != w.shape or not 1 <= bits <= 7:
        raise ValueError(f"sr_pack_fused: w must be 2-D, u of its shape and bits in "
                         f"[1, 7]; got {tuple(w.shape)}, {tuple(u.shape)}, bits={bits}")
    wf = w.to(torch.float32).reshape(1, -1)
    s = torch.clamp(wf.abs().amax(), min=1e-30)
    step = (s * torch.tensor(1.0 / (2.0**bits - 1.0), dtype=torch.float32,
                             device=w.device)).reshape(1)
    offsets = torch.tensor([0, wf.shape[1]], dtype=torch.int32, device=w.device)
    codes = sr_pack_segments(wf, offsets, step, u.to(torch.float32).reshape(1, -1),
                             2**bits - 1, torch.int8)
    return codes.reshape(w.shape), step.reshape(())


def quant_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M,K) @ dequant(codes (K,N) int8/int16, scale) -> (M,N) f32."""
    fn = _route(x, qm.quant_matmul_cuda, qm.quant_matmul_plain, _trace_quant_matmul)
    return fn(x.contiguous(), codes.contiguous(), scale.contiguous())


def flash_attention(q, k, v, causal: bool = True):
    """q,k,v: (B, H, S, D) -> (B, H, S, D); online-softmax kernel.

    Ragged S needs no padding: the kernel masks keys ``>= S`` itself.
    """
    B, H, S, D = q.shape
    fn = _route(q, fa.flash_attention_cuda, fa.flash_attention_plain, _trace_attention)
    out = fn(*(t.reshape(B * H, S, D).contiguous() for t in (q, k, v)),
             causal=causal)
    return out.reshape(B, H, S, D)


def flash_paged_decode(q, k_pages, v_pages, page_table, lengths):
    """Batched paged flash-decode: q (B, KVh, G, hd) against page pools.

    ``k_pages``/``v_pages`` are (N_pool, page, KVh, hd) in the KV-cache
    storage dtype (f32 or bf16); ``page_table`` (B, n_pmax) with -1 for
    unallocated pages; ``lengths`` (B,) valid tokens per slot.  Returns
    UNNORMALIZED fp32 ``(acc, m, l)``; normalize with ``acc / max(l, eps)``.
    G is not padded (the reference pads it to 8 for the TPU's sublanes).
    """
    fn = _route(q, fa.flash_decode_cuda, fa.flash_decode_plain, _trace_decode)
    return fn(q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
              page_table.to(torch.int32).contiguous(),
              lengths.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# Leaf-type dispatch (the serving fast path)
# ---------------------------------------------------------------------------


def _is_qtensor(w) -> bool:
    return hasattr(w, "codes") and hasattr(w, "scale")


def dense_dispatch(x: torch.Tensor, w) -> torch.Tensor:
    """``x (..., K) @ w`` where ``w`` is a plain ``(K, N)`` tensor *or* a
    packed :class:`~repro_torch.models.common.QTensor`.

    Packed weights take ``quant_matmul`` (codes read as int8/int16, f32
    accumulate); the result is cast back to ``x.dtype`` to match the
    eager-dequant path.
    """
    if _is_qtensor(w):
        lead = x.shape[:-1]
        out = quant_matmul(x.reshape(-1, x.shape[-1]), w.codes, w.scale)
        return out.reshape(*lead, w.codes.shape[-1]).to(x.dtype)
    return x @ w


def expert_dispatch(x: torch.Tensor, w, dtype=None) -> torch.Tensor:
    """Per-expert batched matmul ``x (E, C, K) @ w (E, K, N) -> (E, C, N)``
    in ``dtype`` (default ``x.dtype``).

    A packed :class:`~repro_torch.models.common.QTensor` stack with one
    scalar scale sends each expert's matmul through ``quant_matmul`` (one K3
    launch an expert, f32 out, stacked and cast); a stack with a per-expert
    scale row, which K3's one-scale interface cannot take, is dequantized
    eagerly; a plain stack is one einsum.  The reference's three branches.
    """
    if dtype is None:
        dtype = x.dtype
    if _is_qtensor(w):
        if w.scale.ndim == 0:
            return torch.stack([quant_matmul(x[e], w.codes[e], w.scale)
                                for e in range(w.codes.shape[0])]).to(dtype)
        scale = w.scale.to(torch.float32).reshape((-1,) + (1,) * (w.codes.ndim - 1))
        dense = (w.codes.to(torch.float32) * scale).to(dtype)
        return torch.einsum("eck,ekn->ecn", x.to(dtype), dense)
    return torch.einsum("eck,ekn->ecn", x.to(dtype), as_array(w, dtype))


def as_array(w, dtype=torch.float32) -> torch.Tensor:
    """Materialize a (possibly packed) weight as a dense tensor."""
    if _is_qtensor(w):
        return (w.codes.to(torch.float32) * w.scale.to(torch.float32)).to(dtype)
    return w

