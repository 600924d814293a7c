"""Public kernel entry points + leaf-type dispatch.

Dispatch rule: a CUDA tensor goes to the hand-written kernel, which launches
or raises; a CPU tensor goes to the kernel's plain PyTorch version.  There is
no other route and no fallback from one to the other.  The entry points also
do the layout plumbing around the kernels (flattening heads into the batch,
contiguity, index dtypes).

:func:`dense_dispatch` is the serving fast path's single entry point: given
an activation and either a plain tensor or a
:class:`~repro_torch.models.common.QTensor` weight, it routes packed weights
to ``quant_matmul``, so the int8 codes are the bytes the projection reads.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels._build import LAUNCHES, reset_launches  # noqa: F401


def _route(t: torch.Tensor, kernel, plain):
    if t.is_cuda:
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no kernel for tensors on {t.device}")


def quant_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M,K) @ dequant(codes (K,N) int8/int16, scale) -> (M,N) f32."""
    fn = _route(x, qm.quant_matmul_cuda, qm.quant_matmul_plain)
    return fn(x.contiguous(), codes.contiguous(), scale.contiguous())


def flash_attention(q, k, v, causal: bool = True):
    """q,k,v: (B, H, S, D) -> (B, H, S, D); online-softmax kernel.

    Ragged S needs no padding: the kernel masks keys ``>= S`` itself.
    """
    B, H, S, D = q.shape
    fn = _route(q, fa.flash_attention_cuda, fa.flash_attention_plain)
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
    fn = _route(q, fa.flash_decode_cuda, fa.flash_decode_plain)
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


def as_array(w, dtype=torch.float32) -> torch.Tensor:
    """Materialize a (possibly packed) weight as a dense tensor."""
    if _is_qtensor(w):
        return (w.codes.to(torch.float32) * w.scale.to(torch.float32)).to(dtype)
    return w

