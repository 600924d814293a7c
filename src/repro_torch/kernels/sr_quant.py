"""K1 and K2: stochastic-rounding quantization, CUDA kernels for Hopper.

K1 replaces the Pallas kernel ``repro/kernels/sr_quant.py:sr_quant_fake_kernel``
(SR onto a grid of pitch ``step`` from caller-supplied uniforms) and the clip
its wrappers apply.  It has three entries: the segment entry rounds every
(client, leaf) segment of an FL round in one launch from given uniforms; the
keyed segment entry does the same with the scales made on the card and the
uniforms drawn in the kernel from the round's key (the fl-sim round); the
inline entry is the trainer's whole quantizer for one weight use (scale,
uniforms drawn in the kernel from a site key, the straight-through value,
the compute dtype) in one call: the keyed kernels at one leaf and one
client.  K2 replaces ``sr_quant_pack_kernel`` (the same rounding onto
integer codes clipped to ``±(2^bits - 1)``); its u-taking
entry packs every (client, leaf) segment of given gradients from given
uniforms in one launch, its keyed entry is the SR wire's whole quantizer
(the non-finite guard, the shared scales and pitch, uniforms from the wire's
key, the codes) in one call that reads the clients' gradients where they lie.
Where the clients' rows lie on several ranks, the keyed entry splits at its
pass boundary: pass 1 (the rows' largest finite |g| a leaf and their
non-finite count) and pass 2 (the codes, from shared scales made across the
ranks and a Philox stream offset).  All are in ``csrc/sr_quant.cu``, whose notes say what bounds them.

The ``*_cuda`` functions launch them; the ``*_plain`` functions are the
plain PyTorch versions of the same functions, built on
:mod:`repro_torch.kernels.ref`.  Each pair is bit-equal for the same uniforms
(the same key, for the keyed entries).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (f32_reciprocal, philox4x32_plain, philox_streams_plain,
                                     philox_uniforms_plain, saturate_nonfinite,
                                     sr_quant_fake_plain, sr_quant_pack_plain)

NAME = "sr_quant"
INLINE_NAME = "sr_quant_inline"
PACK_NAME = "sr_pack"
KEYED_NAME = "sr_quant_keyed"
PACK_KEYED_NAME = "sr_pack_keyed"
PACK_SCALES_NAME = "sr_pack_keyed_scales"
PACK_SCALED_NAME = "sr_pack_keyed_scaled"
PHILOX_NAME = "philox"
INLINE_DTYPES = (torch.float32, torch.bfloat16)
CODE_DTYPES = (torch.int8, torch.int16, torch.int32)


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


# ---------------------------------------------------------------------------
# K1, the inline entry: one weight use, uniforms drawn from a key
# ---------------------------------------------------------------------------


def _check_inline(w, delta, key, out_dtype):
    if w.dtype != torch.float32 or delta.dtype != torch.float32 or delta.numel() != 1:
        raise ValueError(f"{INLINE_NAME}: want f32 w and a one-element f32 delta; got "
                         f"{w.dtype}, {delta.dtype} of {delta.numel()} elements")
    if out_dtype not in INLINE_DTYPES:
        raise ValueError(f"{INLINE_NAME}: out_dtype must be one of {INLINE_DTYPES}, got "
                         f"{out_dtype}")
    if not 0 <= key < 2**64 or w.numel() >= 2**31:
        raise ValueError(f"{INLINE_NAME}: key {key} (< 2^64) or n {w.numel()} (< 2^31) out "
                         "of range")


def sr_quant_inline_plain(w, delta, key: int, out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K1's inline entry: ``w`` (any shape, f32) rounded at
    ``step = s * delta`` with ``s = max|w|`` (1 where that is not > 0), from
    :func:`~repro_torch.kernels.ref.philox_uniforms_plain` of ``key``,
    clipped to ``[-s, s]``, bypassed where ``step == 0``, emitted as ``w +
    (q - w)`` in ``out_dtype``: the segment entry's arithmetic for one
    segment."""
    _check_inline(w, delta, key, out_dtype)
    if w.numel() == 0:
        return torch.empty(w.shape, dtype=out_dtype, device=w.device)
    wf = w.reshape(-1)
    s = wf.abs().amax()
    s = torch.where(s > 0, s, torch.ones_like(s))
    step = s * delta.reshape(())
    q = sr_quant_fake_plain(wf, philox_uniforms_plain(key, wf.numel(), w.device), step)
    q = torch.where(step > 0, torch.clamp(q, -s, s), wf)
    return (wf + (q - wf)).reshape(w.shape).to(out_dtype)


def sr_quant_inline_cuda(w, delta, key: int, out_dtype=torch.float32) -> torch.Tensor:
    """Launch K1's inline entry on the current stream (the keyed segment
    entry's max|w| pass and rounding pass at one leaf and one client);
    returns ``w.shape`` in ``out_dtype``.  The scale and ``delta`` never
    leave the device."""
    _check_inline(w, delta, key, out_dtype)
    _build.require_cuda(INLINE_NAME, w, delta)
    out = torch.empty(w.shape, dtype=out_dtype, device=w.device)
    n = w.numel()
    if n == 0:
        return out
    nb = seg_blocks([n], 1, _build.sm_count(w.device))[-1]
    parts = torch.empty((nb, 2), dtype=torch.int32, device=w.device)
    err = _build.lib().repro_sr_quant_inline(
        w.data_ptr(), n, nb, parts.data_ptr(), delta.data_ptr(), key & 0xFFFFFFFF, key >> 32,
        out.data_ptr(), _build.DTYPE_CODES[out_dtype], _build.stream_of(w))
    _build.check_launch(INLINE_NAME, err)
    _build.LAUNCHES[NAME] += 1
    _build.LAUNCHES[INLINE_NAME] += 1
    return out


def philox4x32_cuda(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 on the card, as the inline entry runs it: ``ctr`` (n, 4)
    and ``key`` (n, 2) int32 holding 32-bit words -> (n, 4) int32 words."""
    if ctr.dtype != torch.int32 or key.dtype != torch.int32 or ctr.ndim != 2 or \
            ctr.shape[1] != 4 or key.shape != (ctr.shape[0], 2):
        raise ValueError(f"{PHILOX_NAME}: want int32 ctr (n, 4) and key (n, 2), got "
                         f"{ctr.dtype} {tuple(ctr.shape)}, {key.dtype} {tuple(key.shape)}")
    _build.require_cuda(PHILOX_NAME, ctr, key)
    out = torch.empty_like(ctr)
    err = _build.lib().repro_philox4x32(ctr.data_ptr(), key.data_ptr(), out.data_ptr(),
                                        ctr.shape[0], _build.stream_of(ctr))
    _build.check_launch(PHILOX_NAME, err)
    _build.LAUNCHES[PHILOX_NAME] += 1
    return out


def philox4x32_words_plain(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`philox4x32_cuda` (int32 words in and out)."""
    def u32(t):
        return t.to(torch.int64) & 0xFFFFFFFF

    out = torch.stack(philox4x32_plain([u32(c) for c in ctr.unbind(1)],
                                       [u32(k) for k in key.unbind(1)]), dim=1)
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


# ---------------------------------------------------------------------------
# K2: integer codes
# ---------------------------------------------------------------------------


def _check_pack(g, offsets, step, u, lim, dtype):
    if g.ndim != 2 or offsets.ndim != 1 or step.ndim != 1 or u.shape != g.shape:
        raise ValueError(f"{PACK_NAME}: want g (C,P), offsets (L+1,), step (L,), u "
                         f"(C,P); got {tuple(g.shape)}, {tuple(offsets.shape)}, "
                         f"{tuple(step.shape)}, {tuple(u.shape)}")
    C, P = g.shape
    L = step.shape[0]
    if offsets.shape[0] != L + 1:
        raise ValueError(f"{PACK_NAME}: {L} segments need {L + 1} offsets, got "
                         f"{offsets.shape[0]}")
    for name, t in (("g", g), ("step", step), ("u", u)):
        if t.dtype != torch.float32:
            raise ValueError(f"{PACK_NAME}: {name} must be f32, got {t.dtype}")
    if offsets.dtype != torch.int32:
        raise ValueError(f"{PACK_NAME}: offsets must be int32, got {offsets.dtype}")
    if dtype not in CODE_DTYPES:
        raise ValueError(f"{PACK_NAME}: codes must be one of {CODE_DTYPES}, got {dtype}")
    if not 0 < lim < 2**31:
        raise ValueError(f"{PACK_NAME}: lim={lim} out of range")
    if P >= 2**31 or C > 65535:
        raise ValueError(f"{PACK_NAME}: P={P} (< 2^31) and C={C} (<= 65535) out of range")


def sr_pack_segments_plain(g, offsets, step, u, lim: int,
                           dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Plain version of K2: ``(C, P)`` codes; element ``(c, p)`` of leaf
    ``l`` is ``clip(floor(t) + [u < t - floor(t)], -lim, lim)`` with ``t =
    g / step[l]`` (``step <= 0`` divides by 1), saturated to ``dtype``."""
    _check_pack(g, offsets, step, u, lim, dtype)
    seg = (offsets[1:] - offsets[:-1]).to(torch.long)
    step_e = torch.repeat_interleave(step, seg, output_size=g.shape[1])[None, :]
    return sr_quant_pack_plain(g, u, step_e, lim, dtype)


def sr_pack_segments_cuda(g, offsets, step, u, lim: int,
                          dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Launch K2 on the current stream; returns ``(C, P)`` codes of ``dtype``."""
    _check_pack(g, offsets, step, u, lim, dtype)
    _build.require_cuda(PACK_NAME, g, offsets, step, u)
    C, P = g.shape
    out = torch.empty((C, P), dtype=dtype, device=g.device)
    if out.numel() == 0:
        return out
    err = _build.lib().repro_sr_pack(
        g.data_ptr(), offsets.data_ptr(), step.data_ptr(), u.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[dtype], P, step.shape[0], C, float(lim), _build.stream_of(g))
    _build.check_launch(PACK_NAME, err)
    _build.LAUNCHES[PACK_NAME] += 1
    return out


# ---------------------------------------------------------------------------
# The keyed segment entries: uniforms drawn in the kernel, scales on the card
# ---------------------------------------------------------------------------

#: The by-value table of the keyed entries (csrc/sr_quant.cu: SegTable):
#: leaves a row, and base pointers (rows x leaves) in all.  A tree past the
#: table goes through it in groups (:func:`table_groups`).
SEG_MAX_LEAVES = 64
SEG_MAX_PTRS = 256
SEG_THREADS = 256


def seg_blocks(sizes, rows: int, sms: int) -> list:
    """Block offsets of the keyed passes: leaf ``l`` owns blocks ``blk[l]``
    to ``blk[l+1] - 1`` of a row, its share of ~8 blocks an SM over the
    ``rows`` rows, at least one and no more than one a 4-group a thread."""
    P = sum(sizes)
    budget = max(1, 8 * sms // rows)
    blk = [0]
    for n in sizes:
        want = -(-budget * n // P) if P else 1
        blk.append(blk[-1] + max(1, min(-(-n // (4 * SEG_THREADS)), want)))
    return blk


def _check_table(name, L: int, rows: int):
    if not 1 <= L <= SEG_MAX_LEAVES or rows * L > SEG_MAX_PTRS:
        raise ValueError(f"{name}: {L} leaves of {rows} rows exceed the kernel's table "
                         f"({SEG_MAX_LEAVES} leaves, {SEG_MAX_PTRS} leaves x rows)")


def table_groups(sizes, rows: int, name: str) -> list:
    """The tables a keyed call over leaves of ``sizes`` and ``rows`` rows
    takes: ``[(l0, l1, col)]``, leaves ``l0 .. l1 - 1`` in one table (at
    most :data:`SEG_MAX_LEAVES`, and ``rows`` x leaves at most
    :data:`SEG_MAX_PTRS`), ``col`` the tree's column of leaf ``l0``.  One
    leaf's rows must fit one table: past 256 clients in one process the
    call raises (a rank of the distributed trainer holds one row)."""
    if rows > SEG_MAX_PTRS:
        raise ValueError(f"{name}: {rows} clients exceed the keyed table's {SEG_MAX_PTRS} "
                         "pointers a leaf in one process; run one client a rank instead "
                         "(torchrun: the trainer's process group, ROADMAP queue 1, item 8a)")
    per = min(SEG_MAX_LEAVES, SEG_MAX_PTRS // max(rows, 1))
    groups, col = [], 0
    for l0 in range(0, len(sizes), per):
        l1 = min(l0 + per, len(sizes))
        groups.append((l0, l1, col))
        col += sum(sizes[l0:l1])
    return groups


def _check_key(name, key: int):
    if not 0 <= key < 2**64:
        raise ValueError(f"{name}: key {key} out of range (< 2^64)")


def _seg_offsets(sizes, col: int = 0) -> list:
    off = [col]
    for n in sizes:
        off.append(off[-1] + n)
    if off[-1] >= 2**31:
        raise ValueError(f"keyed segments: P={off[-1]} out of range (< 2^31)")
    return off


def _seg_launch_args(sizes, rows: int, tensors, device, col: int):
    """The host arrays of the table (off from column ``col``, blk, base) and
    the blocks a row."""
    off, blk = _seg_offsets(sizes, col), seg_blocks(sizes, rows, _build.sm_count(device))
    return ((ctypes.c_int * len(off))(*off), (ctypes.c_int * len(blk))(*blk),
            (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors)), blk[-1])


def _absmax_or_zero(x: torch.Tensor) -> torch.Tensor:
    return x.abs().amax() if x.numel() else torch.zeros((), dtype=x.dtype, device=x.device)


def _group_out(name, out, rows: int, col: int, n: int, dtype, device) -> torch.Tensor:
    """The ``(rows, P)`` output a call writes columns ``col .. col + n - 1``
    of: ``out`` where the call is one group of a tree, else a new one."""
    if out is None:
        if col != 0:
            raise ValueError(f"{name}: a group at column {col} needs the tree's output")
        return torch.empty((rows, n), dtype=dtype, device=device)
    if (out.dtype != dtype or out.ndim != 2 or out.shape[0] != rows or
            out.shape[1] < col + n or not out.is_contiguous() or out.device != device):
        raise ValueError(f"{name}: out must be a contiguous ({rows}, >= {col + n}) {dtype} "
                         f"tensor on {device}; got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    return out


def _check_quant_keyed(leaves, delta, key):
    _check_table(KEYED_NAME, len(leaves), 1)
    _check_key(KEYED_NAME, key)
    for t in (*leaves, delta):
        if t.dtype != torch.float32 or t.ndim != 1:
            raise ValueError(f"{KEYED_NAME}: want 1-D f32 leaves and delta (C,), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not 1 <= delta.shape[0] <= 65535:
        raise ValueError(f"{KEYED_NAME}: C={delta.shape[0]} out of range [1, 65535]")


def sr_quant_segments_keyed_plain(leaves, delta, key: int, out=None,
                                  col: int = 0) -> torch.Tensor:
    """Plain version of K1's keyed segment entry: the segment entry on the
    leaves concatenated (the straight-through value), with ``s[l] = max|leaf
    l|`` (1 where that is not > 0, as ``tensor_scale``) and client ``c``'s
    uniforms stream ``c`` of
    :func:`~repro_torch.kernels.ref.philox_uniforms_plain` under ``key``.
    With ``out`` the leaves are one group of a tree whose columns start at
    ``col``: their uniforms are the tree's columns and the call writes those
    columns of ``out`` (C, P), which it returns."""
    _check_quant_keyed(leaves, delta, key)
    sizes = [x.numel() for x in leaves]
    w = torch.cat(list(leaves))
    out = _group_out(KEYED_NAME, out, delta.shape[0], col, w.numel(), torch.float32,
                     w.device)
    offsets = torch.tensor(_seg_offsets(sizes), dtype=torch.int32, device=w.device)
    s = torch.stack([_absmax_or_zero(x) for x in leaves])
    s = torch.where(s > 0, s, torch.ones_like(s))
    u = philox_streams_plain(key, delta.shape[0], w.numel(), w.device, start=col)
    out[:, col:col + w.numel()] = sr_quant_segments_plain(w, offsets, s, delta, u)
    return out


def sr_quant_segments_keyed_cuda(leaves, delta, key: int, out=None,
                                 col: int = 0) -> torch.Tensor:
    """Launch K1's keyed segment entry on the current stream (a max|w| pass
    over the leaves where they lie, then the rounding pass); returns ``(C,
    P)`` f32.  Scales, uniforms and ``delta`` never leave the card.  ``out``
    and ``col`` as in the plain version: the table's leaf offsets are the
    tree's columns, so a group draws the tree's Philox counters."""
    _check_quant_keyed(leaves, delta, key)
    _build.require_cuda(KEYED_NAME, delta, *leaves)
    sizes = [x.numel() for x in leaves]
    C = delta.shape[0]
    out = _group_out(KEYED_NAME, out, C, col, sum(sizes), torch.float32, delta.device)
    off, blk, base, nb = _seg_launch_args(sizes, C, leaves, delta.device, col)
    parts = torch.empty((nb, 2), dtype=torch.int32, device=delta.device)
    err = _build.lib().repro_sr_quant_keyed(
        off, blk, base, len(leaves), parts.data_ptr(), delta.data_ptr(), C, key & 0xFFFFFFFF,
        key >> 32, out.data_ptr(), out.shape[1], _build.stream_of(delta))
    _build.check_launch(KEYED_NAME, err)
    _build.LAUNCHES[NAME] += 1
    _build.LAUNCHES[KEYED_NAME] += 1
    return out


def _check_rows(name, leaves) -> int:
    C = len(leaves[0]) if leaves else 0
    _check_table(name, len(leaves), max(C, 1))
    if C < 1:
        raise ValueError(f"{name}: want at least one client")
    for leaf in leaves:
        if len(leaf) != C or any(g.shape != leaf[0].shape for g in leaf):
            raise ValueError(f"{name}: every leaf wants {C} clients' gradients of one shape")
        for g in leaf:
            if g.dtype != torch.float32:
                raise ValueError(f"{name}: gradients must be f32, got {g.dtype}")
    return C


def _check_pack_keyed(leaves, key, lim, dtype, name=PACK_KEYED_NAME):
    _check_rows(name, leaves)
    _check_key(name, key)
    if dtype not in CODE_DTYPES:
        raise ValueError(f"{name}: codes must be one of {CODE_DTYPES}, got {dtype}")
    if not 0 < lim < 2**31:
        raise ValueError(f"{name}: lim={lim} out of range")


def sr_pack_keyed_plain(leaves, key: int, lim: int, dtype: torch.dtype = torch.int8,
                        out=None, col: int = 0):
    """Plain version of K2's keyed entry.  ``leaves``: per leaf, the ``C``
    clients' f32 gradients.  Each client's leaf is guarded by
    :func:`~repro_torch.kernels.ref.saturate_nonfinite` (NaN -> 0, +-Inf ->
    +- its largest finite |g|); the leaf's scale ``s`` is the guarded max over
    the clients (1 where 0), its pitch ``s * fl32(1 / lim)``; the codes are
    K2's from client ``c``'s uniforms stream ``c`` under ``key``.  Returns
    ``(codes (C, P), step (L,) f32, non-finite count () int64)``.  With
    ``out`` the leaves are one group of a tree whose columns start at
    ``col``: the codes go to those columns of ``out`` (returned as the
    codes), drawn at the tree's columns; step and count are the group's."""
    _check_pack_keyed(leaves, key, lim, dtype)
    dev = leaves[0][0].device
    gs = [torch.stack([x.reshape(-1) for x in leaf]) for leaf in leaves]
    bad = sum(((~torch.isfinite(g)).sum() for g in gs),
              torch.zeros((), dtype=torch.int64, device=dev))
    rows = [saturate_nonfinite(g) for g in gs]
    s = torch.stack([_absmax_or_zero(g) for g in rows])
    s = torch.where(s > 0, s, torch.ones_like(s))
    step = s * f32_reciprocal(lim)
    g = torch.cat(rows, dim=1)
    out = _group_out(PACK_KEYED_NAME, out, g.shape[0], col, g.shape[1], dtype, dev)
    offsets = torch.tensor(_seg_offsets([r.shape[1] for r in rows]), dtype=torch.int32,
                           device=dev)
    u = philox_streams_plain(key, g.shape[0], g.shape[1], dev, start=col)
    out[:, col:col + g.shape[1]] = sr_pack_segments_plain(g, offsets, step, u, lim, dtype)
    return out, step, bad


def sr_pack_keyed_cuda(leaves, key: int, lim: int, dtype: torch.dtype = torch.int8,
                       out=None, col: int = 0):
    """Launch K2's keyed entry on the current stream (the guard's partials,
    then the guarded rounding onto codes); the gradients are read where they
    lie.  Returns ``(codes (C, P), step (L,) f32, non-finite count () int64)``,
    all on the card.  ``out`` and ``col`` as in the plain version."""
    _check_pack_keyed(leaves, key, lim, dtype)
    flat = [g for leaf in zip(*leaves) for g in leaf]       # client-major: base[c * L + l]
    _build.require_cuda(PACK_KEYED_NAME, *flat)
    dev = flat[0].device
    C, L = len(leaves[0]), len(leaves)
    sizes = [leaf[0].numel() for leaf in leaves]
    codes = _group_out(PACK_KEYED_NAME, out, C, col, sum(sizes), dtype, dev)
    step = torch.empty(L, dtype=torch.float32, device=dev)
    bad = torch.empty((), dtype=torch.int64, device=dev)
    off, blk, base, nb = _seg_launch_args(sizes, C, flat, dev, col)
    parts = torch.empty((C * nb, 2), dtype=torch.int32, device=dev)
    err = _build.lib().repro_sr_pack_keyed(
        off, blk, base, L, C, parts.data_ptr(), key & 0xFFFFFFFF, key >> 32, float(lim),
        codes.data_ptr(), codes.shape[1], _build.DTYPE_CODES[dtype], step.data_ptr(),
        bad.data_ptr(), _build.stream_of(flat[0]))
    _build.check_launch(PACK_KEYED_NAME, err)
    _build.LAUNCHES[PACK_NAME] += 1
    _build.LAUNCHES[PACK_KEYED_NAME] += 1
    return codes, step, bad


# ---------------------------------------------------------------------------
# K2's keyed entry split at its pass boundary: the wire across ranks
# ---------------------------------------------------------------------------


def _finite_absmax(g: torch.Tensor) -> torch.Tensor:
    """Largest finite |g| of each row of ``g`` (C, n); 0 where a row has none."""
    fin = torch.where(torch.isfinite(g), g.abs(), torch.zeros_like(g))
    return fin.amax(dim=1) if g.shape[1] else torch.zeros(g.shape[0], device=g.device)


def sr_pack_keyed_scales_plain(leaves):
    """Plain version of K2's pass 1 alone.  ``leaves``: per leaf, ``C`` rows'
    f32 gradients.  Returns ``(fmax (C, L) f32, non-finite count () int64)``:
    ``fmax[c, l]`` is row ``c``'s largest finite |g| in leaf ``l`` (0 where it
    has none), the count is over every row and leaf."""
    _check_rows(PACK_SCALES_NAME, leaves)
    dev = leaves[0][0].device
    gs = [torch.stack([x.reshape(-1) for x in leaf]) for leaf in leaves]
    bad = sum(((~torch.isfinite(g)).sum() for g in gs),
              torch.zeros((), dtype=torch.int64, device=dev))
    return torch.stack([_finite_absmax(g) for g in gs], dim=1), bad


def _check_scaled(leaves, smax, fmax, c0: int):
    C, L = len(leaves[0]), len(leaves)
    if smax.shape != (L,) or fmax.shape != (C, L) or smax.dtype != torch.float32 or \
            fmax.dtype != torch.float32:
        raise ValueError(f"{PACK_SCALED_NAME}: want f32 smax ({L},) and fmax ({C}, {L}); got "
                         f"{smax.dtype} {tuple(smax.shape)} and {fmax.dtype} "
                         f"{tuple(fmax.shape)}")
    if not 0 <= c0 or c0 + C > 2**31:
        raise ValueError(f"{PACK_SCALED_NAME}: stream offset c0={c0} out of range")


def sr_pack_keyed_scaled_plain(leaves, smax, fmax, key: int, lim: int,
                               dtype: torch.dtype = torch.int8, c0: int = 0, out=None,
                               col: int = 0):
    """Plain version of K2's pass 2 given the scales.  ``smax`` (L,) the
    shared scale of each leaf (the max of every rank's pass 1, 1 where not >
    0), ``fmax`` (C, L) the rows' own largest finite |g| (the guard's
    clamp); row ``c`` draws stream ``c0 + c`` under ``key``.  Returns
    ``(codes (C, P), step (L,) f32)``; ``out`` and ``col`` as in
    :func:`sr_pack_keyed_plain`.  Pass 1 on every row, the max of its
    ``fmax`` over the rows, then pass 2 with ``c0 = c`` on row ``c`` give
    the one-call entry's codes and pitch bit for bit."""
    _check_pack_keyed(leaves, key, lim, dtype, PACK_SCALED_NAME)
    _check_scaled(leaves, smax, fmax, c0)
    dev = leaves[0][0].device
    rows = []
    for l, leaf in enumerate(leaves):
        g = torch.stack([x.reshape(-1) for x in leaf])
        fm = fmax[:, l:l + 1]
        rows.append(torch.clamp(torch.where(torch.isnan(g), torch.zeros_like(g), g), -fm, fm))
    s = torch.where(smax > 0, smax, torch.ones_like(smax))
    step = s * f32_reciprocal(lim)
    g = torch.cat(rows, dim=1)
    out = _group_out(PACK_SCALED_NAME, out, g.shape[0], col, g.shape[1], dtype, dev)
    offsets = torch.tensor(_seg_offsets([r.shape[1] for r in rows]), dtype=torch.int32,
                           device=dev)
    u = philox_streams_plain(key, g.shape[0], g.shape[1], dev, start=col, c0=c0)
    out[:, col:col + g.shape[1]] = sr_pack_segments_plain(g, offsets, step, u, lim, dtype)
    return out, step


def sr_pack_keyed_scales_cuda(leaves):
    """Launch K2's pass 1 alone on the current stream (the block partials,
    then their fold a leaf and row); returns ``(fmax (C, L) f32, non-finite
    count () int64)`` on the card."""
    _check_rows(PACK_SCALES_NAME, leaves)
    flat = [g for leaf in zip(*leaves) for g in leaf]       # row-major: base[c * L + l]
    _build.require_cuda(PACK_SCALES_NAME, *flat)
    dev = flat[0].device
    C, L = len(leaves[0]), len(leaves)
    sizes = [leaf[0].numel() for leaf in leaves]
    fmax = torch.empty((C, L), dtype=torch.float32, device=dev)
    bad = torch.empty((), dtype=torch.int64, device=dev)
    off, blk, base, nb = _seg_launch_args(sizes, C, flat, dev, 0)
    parts = torch.empty((C * nb, 2), dtype=torch.int32, device=dev)
    err = _build.lib().repro_sr_pack_keyed_scales(
        off, blk, base, L, C, parts.data_ptr(), fmax.data_ptr(), bad.data_ptr(),
        _build.stream_of(flat[0]))
    _build.check_launch(PACK_SCALES_NAME, err)
    _build.LAUNCHES[PACK_SCALES_NAME] += 1
    return fmax, bad


def sr_pack_keyed_scaled_cuda(leaves, smax, fmax, key: int, lim: int,
                              dtype: torch.dtype = torch.int8, c0: int = 0, out=None,
                              col: int = 0):
    """Launch K2's pass 2 given the scales on the current stream; returns
    ``(codes (C, P), step (L,) f32)`` on the card.  Arguments as in the
    plain version; ``smax`` and ``fmax`` are read on the card."""
    _check_pack_keyed(leaves, key, lim, dtype, PACK_SCALED_NAME)
    _check_scaled(leaves, smax, fmax, c0)
    flat = [g for leaf in zip(*leaves) for g in leaf]
    _build.require_cuda(PACK_SCALED_NAME, smax, fmax, *flat)
    dev = flat[0].device
    C, L = len(leaves[0]), len(leaves)
    sizes = [leaf[0].numel() for leaf in leaves]
    codes = _group_out(PACK_SCALED_NAME, out, C, col, sum(sizes), dtype, dev)
    step = torch.empty(L, dtype=torch.float32, device=dev)
    smax, fmax = smax.contiguous(), fmax.contiguous()
    off, blk, base, _nb = _seg_launch_args(sizes, C, flat, dev, col)
    err = _build.lib().repro_sr_pack_keyed_scaled(
        off, blk, base, L, C, smax.data_ptr(), fmax.data_ptr(), int(c0), key & 0xFFFFFFFF,
        key >> 32, float(lim), codes.data_ptr(), codes.shape[1], _build.DTYPE_CODES[dtype],
        step.data_ptr(), _build.stream_of(flat[0]))
    _build.check_launch(PACK_SCALED_NAME, err)
    _build.LAUNCHES[PACK_NAME] += 1
    _build.LAUNCHES[PACK_SCALED_NAME] += 1
    return codes, step
