"""Axis context and the SR-quantized gradient all-reduce of the port.

:class:`AxisCtx` names the axes of a launch as the reference's mesh context
does (``batch_axes``, ``model_axis``, ``fsdp_axes``) and carries their sizes.
The port runs a ``Dx1`` mesh on one device: the D data-parallel groups (the
FL clients) run one after another in a loop, so where the reference asks
``lax.axis_index`` which client it is, the port's context says which client
the loop is at (:meth:`AxisCtx.at_client`).  The model axis is 1: its
collectives (``psum_model``) are identities, as in the reference outside a
mesh; tensor parallelism is not ported.

:func:`quantized_psum_batch` is the paper's Eq. 1 stochastic-rounding
quantizer applied to model updates on the wire: the clients agree on a shared
grid through the max of their scales, round onto integer codes (K2), sum the
codes exactly and dequantize to the mean.  It takes any number of leaves, so
one K2 call packs a whole train step's wire: the keyed entry
(:func:`repro_torch.kernels.ops.sr_pack_keyed`, uniforms drawn in the kernel
from the wire's key, the clients' gradients read where they lie) or, given
uniforms, the u-taking one (:func:`repro_torch.kernels.ops.sr_pack_segments`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.quantization import FULL_PRECISION_BITS
from repro_torch.kernels import ops
from repro_torch.kernels.ref import f32_reciprocal, saturate_nonfinite
from repro_torch.roofline import count


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """Named axes of one launch and their sizes (all 1 when unnamed).

    ``batch_axes``: data-parallel axes — one FL client per group.
    ``model_axis``: tensor-parallel axis (None = no TP; its size must be 1).
    ``fsdp_axes``:  axes the reference fully shards parameters over (the
    batch axes).  ``sizes``: ``((axis name, size), ...)``.  ``client``: the
    data-parallel rank the code runs as.
    """

    batch_axes: tuple[str, ...] = ()
    model_axis: str | None = None
    fsdp_axes: tuple[str, ...] = ()
    sizes: tuple[tuple[str, int], ...] = ()
    client: int = 0

    def __post_init__(self):
        if self.tp != 1:
            raise NotImplementedError(
                f"model axis of size {self.tp}: tensor parallelism is not ported "
                "(ROADMAP queue 1, item 9)")

    def _size(self, names) -> int:
        d = dict(self.sizes)
        n = 1
        for a in names:
            n *= int(d.get(a, 1))
        return n

    # --- static sizes ----------------------------------------------------
    @property
    def dp(self) -> int:
        """Number of data-parallel groups (= FL clients)."""
        return self._size(self.batch_axes)

    @property
    def tp(self) -> int:
        return self._size((self.model_axis,) if self.model_axis else ())

    @property
    def fsdp(self) -> int:
        return self._size(self.fsdp_axes)

    # --- indices ---------------------------------------------------------
    def dp_index(self) -> int:
        """Flattened data-parallel rank (client id)."""
        return self.client

    def tp_index(self) -> int:
        return 0

    def at_client(self, c: int) -> "AxisCtx":
        """The same axes, running as client ``c``."""
        if not 0 <= c < self.dp:
            raise ValueError(f"client {c} out of range for {self.dp} clients")
        return dataclasses.replace(self, client=int(c))

    # --- model-axis collectives (tp = 1) ---------------------------------
    def psum_model(self, x):
        return x


def code_bound(bits: int) -> int:
    """Largest |code| a ``bits``-wide SR quantizer can emit: ``2^bits - 1``.

    The exactness contract of the SR-quantized gradient all-reduce: codes are
    clipped to ``±code_bound(bits)``, and ``n_clients * code_bound(bits)``
    must fit the accumulator (:func:`wire_dtype`).
    """
    return 2 ** int(bits) - 1


def wire_dtype(bits: int, n_clients: int):
    """Narrowest signed integer dtype whose sum of ``n_clients`` codes is exact.

    Per-client codes lie in ``[-code_bound(bits), code_bound(bits)]``; the
    all-reduce accumulator must hold ``n * code_bound(bits)``.  Returns a
    numpy dtype class (``np.int8`` / ``np.int16`` / ``np.int32``).
    """
    need = n_clients * code_bound(bits)
    for dt in (np.int8, np.int16, np.int32):
        if need <= np.iinfo(dt).max:
            return dt
    raise ValueError(
        f"comm bits={bits} with {n_clients} clients needs an accumulator "
        f"holding {need} > int32 max; lower the bit-width (<= 16 is always "
        "safe below 32768 clients) or use 32 (uncompressed)")


def envelope_wire_dtype(bits_options, n_clients: int):
    """Widest accumulator any bit-width in an adaptive program's comm
    envelope needs, or ``None`` when the whole envelope is uncompressed.

    Calls :func:`wire_dtype` on every compressed member, so it raises if any
    round the program can emit would overflow the int32 accumulator.
    """
    compressed = [b for b in sorted({int(b) for b in bits_options})
                  if b < FULL_PRECISION_BITS]
    if not compressed:
        return None
    dts = [wire_dtype(b, n_clients) for b in compressed]
    return max(dts, key=lambda d: np.dtype(d).itemsize)


_TORCH_INT = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
              np.dtype(np.int32): torch.int32}


def _check_nonfinite_mode(on_nonfinite: str) -> None:
    if on_nonfinite not in ("raise", "saturate"):
        raise ValueError(f"on_nonfinite must be 'raise' or 'saturate', "
                         f"got {on_nonfinite!r}")


def _raise_nonfinite(bad: int | None) -> None:
    if bad:
        raise FloatingPointError(
            f"quantized_psum_batch: {bad} non-finite gradient "
            "values reached the wire quantizer (pass "
            "on_nonfinite='saturate' to clamp instead)")


def _nonfinite_guard(gfs: list, on_nonfinite: str) -> list:
    """Keep NaN/Inf gradients out of the wire quantizer.

    ``gfs`` are f32 leaves stacked over the clients.  A non-finite value
    would poison the shared scale and every client's codes.  ``"raise"``
    counts them over all leaves and raises ``FloatingPointError``;
    ``"saturate"`` maps NaN to 0 and clamps ±Inf to each client's largest
    finite magnitude in that leaf.
    """
    _check_nonfinite_mode(on_nonfinite)
    if on_nonfinite == "raise":
        reads = [count.host_read((~torch.isfinite(g)).sum(), "the wire's non-finite count")
                 for g in gfs]
        _raise_nonfinite(sum(r or 0 for r in reads))
        return gfs
    return [saturate_nonfinite(g) for g in gfs]


def quantized_psum_batch(axes: AxisCtx, grad, u, bits, *,
                         on_nonfinite: str = "raise", key: int | None = None):
    """SR-quantized all-reduce **mean** over the ``axes.dp`` clients.

    ``grad`` is one leaf stacked over the clients, ``(D, *shape)``, or a
    list of such leaves.  The SR draws are either ``u``, uniforms of the
    same shapes (client ``c``'s draws for each leaf), or, with ``u=None``,
    drawn inside K2 from the 64-bit ``key`` (:func:`ops.sr_pack_keyed
    <repro_torch.kernels.ops.sr_pack_keyed>`); with the key a leaf may also
    be a sequence of the D clients' gradients, read where they lie (nothing
    is stacked or concatenated).  Returns the mean of each leaf,
    ``shape``-sized, in the same structure:

    1. shared grid per leaf: ``s = max_c max|g_c|`` (1 where 0), pitch
       ``step = s / (2^bits - 1)``;
    2. every (client, leaf) segment rounded onto integer codes in ONE K2
       call, in :func:`wire_dtype` (int8/int16/int32);
    3. the codes summed exactly over the clients;
    4. ``(total * step) / D``.

    ``bits >= 32`` is the exact mean; one client is the identity.
    ``on_nonfinite`` guards against NaN/Inf (see :func:`_nonfinite_guard`);
    the keyed path applies the guard inside K2 and, in ``"raise"`` mode,
    reads the device's non-finite count once.  A traced step records the
    collectives the reference's device issues for each leaf (the count's
    ``psum`` in ``"raise"`` mode, the scale's ``pmax``, and after K2 the
    codes' ``psum`` with the codes as its operand; a ``pmean`` at full
    precision), and counts the one K2 call at ``1 / D`` per device: each
    device of the reference packs its own client.
    """
    single = isinstance(grad, torch.Tensor)
    grads = [grad] if single else list(grad)
    n = axes.dp
    if (u is None) == (key is None):
        raise ValueError("quantized_psum_batch: pass exactly one of the uniforms u and a key")
    if u is None:
        grads = [list(g) for g in grads]       # a stacked leaf's rows are views
        for g in grads:
            if len(g) != n or any(x.shape != g[0].shape for x in g):
                raise ValueError(f"quantized_psum_batch: leaves of D={n} client gradients "
                                 f"of one shape; got {[tuple(x.shape) for x in g]}")
    else:
        us = [u] if single else list(u)
        if len(us) != len(grads):
            raise ValueError("quantized_psum_batch: one uniform tensor per leaf")
        for g, uu in zip(grads, us):
            if g.shape[0] != n or uu.shape != g.shape:
                raise ValueError(f"quantized_psum_batch: leaves (D={n}, ...) with uniforms "
                                 f"of their shape; got {tuple(g.shape)} and {tuple(uu.shape)}")
    if count.active() is not None and n > 1:
        _record_wire([g[0] for g in grads], int(bits), n, on_nonfinite)
    if n == 1:
        out = [g[0] for g in grads]             # single client: nothing to reduce
    elif int(bits) >= FULL_PRECISION_BITS:
        out = []
        for g in grads:                         # full precision: exact mean
            total = g[0]
            for c in range(1, n):
                total = total + g[c]
            out.append(total * f32_reciprocal(n))
    elif u is None:
        out = _quantized_mean_keyed(grads, int(bits), n, on_nonfinite, int(key))
    else:
        out = _quantized_mean(grads, us, int(bits), n, on_nonfinite)
    return out[0] if single else out


def _record_wire(leaves, bits: int, n: int, on_nonfinite: str) -> None:
    """The collectives the reference's device issues for each wire leaf
    (``leaves``: client 0's gradient of each) before its codes exist: the
    ``pmean`` at full precision, else the non-finite count's ``psum`` (in
    ``"raise"`` mode) and the scale's ``pmax``.  The codes' ``psum`` is
    recorded after K2 has made them (:func:`_record_codes`)."""
    name = "quantized_psum_batch"
    for g in leaves:
        if bits >= FULL_PRECISION_BITS:
            count.record_collective("all-reduce", g.dtype, g.numel(), n, f"{name} pmean",
                                    operand=g)
            continue
        if on_nonfinite == "raise":
            count.record_collective("all-reduce", torch.int32, 1, n,
                                    f"{name} non-finite count", operand=_device_count(g))
        count.record_collective("all-reduce", torch.float32, 1, n, f"{name} scale pmax")


def _device_count(g: torch.Tensor):
    """One device's non-finite count of its leaf, the operand of the
    reference's count ``psum``.  The port's keyed K2 counts inside the
    kernel, so this is computed only for a traced step's graph, outside its
    live bytes (None otherwise)."""
    if not count.graph_active():
        return None
    with count.untracked():
        return (~torch.isfinite(g)).sum(dtype=torch.int32)


def _record_codes(codes: torch.Tensor, sizes, n: int) -> None:
    """The codes' ``psum`` of each wire leaf (``sizes`` its elements), in
    the wire dtype K2 wrote, with K2's codes as its operand."""
    if count.active() is None:
        return
    for elems in sizes:
        count.record_collective("all-reduce", codes.dtype, elems, n,
                                "quantized_psum_batch codes", operand=codes)


def _dequantized_means(codes, step, sizes, shapes, dtypes, n: int) -> list:
    # the integer sum is exact: wire_dtype holds n * lim
    total = codes.sum(dim=0, dtype=torch.int64).to(torch.float32)
    inv_n = f32_reciprocal(n)
    return [((chunk * step[i]) * inv_n).reshape(shape).to(dtype)
            for i, (chunk, shape, dtype) in enumerate(zip(total.split(sizes), shapes, dtypes))]


def _quantized_mean(grads, us, bits: int, n: int, on_nonfinite: str) -> list:
    if not grads:
        return []
    dev = grads[0].device
    gfs = _nonfinite_guard([g.to(torch.float32) for g in grads], on_nonfinite)
    s = torch.stack([g.abs().amax() for g in gfs])
    s = torch.where(s > 0, s, torch.ones_like(s))
    lim = code_bound(bits)
    step = s * f32_reciprocal(lim)
    sizes = [g[0].numel() for g in gfs]
    offsets = torch.tensor([0, *np.cumsum(sizes)], dtype=torch.int32, device=dev)
    flat = torch.cat([g.reshape(n, -1) for g in gfs], dim=1)
    uflat = torch.cat([uu.to(torch.float32).reshape(n, -1) for uu in us], dim=1)
    with count.share(1 / n):
        codes = ops.sr_pack_segments(flat, offsets, step, uflat, lim,
                                     _TORCH_INT[np.dtype(wire_dtype(bits, n))])
    _record_codes(codes, sizes, n)
    return _dequantized_means(codes, step, sizes, [g.shape[1:] for g in grads],
                              [g.dtype for g in grads], n)


def _quantized_mean_keyed(grads, bits: int, n: int, on_nonfinite: str, key: int) -> list:
    """The keyed wire: ``grads`` per leaf the D clients' gradients; one K2
    call guards, scales, draws and packs; in ``"raise"`` mode the one host
    read of a step is the non-finite count, after everything is queued."""
    _check_nonfinite_mode(on_nonfinite)
    if not grads:
        return []
    lim = code_bound(bits)
    with count.share(1 / n):
        codes, step, bad = ops.sr_pack_keyed(grads, key, lim,
                                             _TORCH_INT[np.dtype(wire_dtype(bits, n))])
    _record_codes(codes, [g[0].numel() for g in grads], n)
    out = _dequantized_means(codes, step, [g[0].numel() for g in grads],
                             [g[0].shape for g in grads], [g[0].dtype for g in grads], n)
    if on_nonfinite == "raise":
        _raise_nonfinite(count.host_read(bad, "the wire's non-finite count"))
    return out
