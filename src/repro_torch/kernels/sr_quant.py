"""K1: fused stochastic-rounding quantization, a CUDA kernel for Hopper.

Replaces the Pallas kernel ``repro/kernels/sr_quant.py:sr_quant_fake_kernel``
(SR onto a grid of pitch ``step`` from caller-supplied uniforms) and the clip
its wrappers apply.  The kernel is ``csrc/sr_quant.cu``: one launch rounds
every (client, leaf) segment of an FL round; its note says what bounds it.

:func:`sr_quant_segments_cuda` launches it; :func:`sr_quant_segments_plain`
is the plain PyTorch version of the same function, built on
:func:`repro_torch.kernels.ref.sr_quant_fake_plain`.  The two are bit-equal
for the same uniforms.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sr_quant_fake_plain

NAME = "sr_quant"


def _check(w, offsets, s, d, u):
    if w.ndim != 1 or offsets.ndim != 1 or s.ndim != 1 or d.ndim != 1 or u.ndim != 2:
        raise ValueError(f"{NAME}: want w (P,), offsets (L+1,), s (L,), d (C,), "
                         f"u (C,P); got {tuple(w.shape)}, {tuple(offsets.shape)}, "
                         f"{tuple(s.shape)}, {tuple(d.shape)}, {tuple(u.shape)}")
    P, L, C = w.shape[0], s.shape[0], d.shape[0]
    if offsets.shape[0] != L + 1 or u.shape != (C, P):
        raise ValueError(f"{NAME}: {L} segments need {L + 1} offsets (got "
                         f"{offsets.shape[0]}); u must be ({C}, {P}), got {tuple(u.shape)}")
    for name, t in (("w", w), ("s", s), ("d", d), ("u", u)):
        if t.dtype != torch.float32:
            raise ValueError(f"{NAME}: {name} must be f32, got {t.dtype}")
    if offsets.dtype != torch.int32:
        raise ValueError(f"{NAME}: offsets must be int32, got {offsets.dtype}")
    if P >= 2**31 or C > 65535:
        raise ValueError(f"{NAME}: P={P} (< 2^31) and C={C} (<= 65535) out of range")


def sr_quant_segments_plain(w, offsets, s, d, u, *, ste: bool = True) -> torch.Tensor:
    """Plain version of K1: ``(C, P)`` rounded copies of ``w``; element
    ``(c, p)`` of leaf ``l`` at ``step = s[l] * d[c]``, clipped to
    ``[-s[l], s[l]]``, bypassed where ``step == 0``, and emitted as
    ``w + (q - w)`` when ``ste``."""
    _check(w, offsets, s, d, u)
    seg = (offsets[1:] - offsets[:-1]).to(torch.long)
    s_e = torch.repeat_interleave(s, seg, output_size=w.shape[0])[None, :]  # (1, P)
    step = s_e * d[:, None]                                   # (C, P)
    q = sr_quant_fake_plain(w[None, :], u, step)
    q = torch.where(step > 0, torch.clamp(q, -s_e, s_e), w[None, :])
    return w + (q - w) if ste else q


def sr_quant_segments_cuda(w, offsets, s, d, u, *, ste: bool = True) -> torch.Tensor:
    """Launch K1 on the current stream; returns ``(C, P)`` f32."""
    _check(w, offsets, s, d, u)
    _build.require_cuda(NAME, w, offsets, s, d, u)
    P, L, C = w.shape[0], s.shape[0], d.shape[0]
    out = torch.empty((C, P), dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    err = _build.lib().repro_sr_quant(
        w.data_ptr(), offsets.data_ptr(), s.data_ptr(), d.data_ptr(), u.data_ptr(),
        out.data_ptr(), P, L, C, int(ste), _build.stream_of(w))
    _build.check_launch(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return out
