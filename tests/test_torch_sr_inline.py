"""K1's inline entry (the trainer's weight quantizer) on the CPU.

The keyed entry draws its uniforms inside the kernel from a 64-bit site key
(Philox4x32-10).  Here its plain version is held to the Random123 known
answers, to ``sr_quantize`` fed the same uniforms (bit for bit, f32 and bf16
out), to the reference's rounding arithmetic fed those uniforms, and to the
statistics SR promises; the CUDA kernel is held to the same plain version by
``chip_smoke.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels import ref as jref
from repro_torch.core import quantization as tq
from repro_torch.core.fwq import make_inline_quantizer, site_key
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sr_quant as tsq
from repro_torch.launch.steps import SRDraws

#: Random123's known answers for philox4x32-10: (counter, key, output).
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
KEY = site_key(0, 3, 1, 12345)


def _w(n: int, seed: int = 0, zero: bool = False) -> torch.Tensor:
    if zero:
        return torch.zeros(n)
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(n) * 0.3)
                            .astype(np.float32))


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    got = tref.philox4x32_plain([torch.tensor([c]) for c in ctr], key)
    assert [int(x) for x in got] == list(want)
    words = tsq.philox4x32_words_plain(
        torch.tensor([ctr], dtype=torch.int64).to(torch.int32),
        torch.tensor([key], dtype=torch.int64).to(torch.int32))
    assert [int(x) & 0xFFFFFFFF for x in words[0]] == list(want)


def test_uniforms_are_the_top_24_bits_of_the_counter_words():
    """Element i takes word i % 4 of the block at counter i // 4."""
    k = 0x0123456789ABCDEF
    u = tref.philox_uniforms_plain(k, 11)
    for g in range(3):
        words = tref.philox4x32_plain([torch.tensor([g]), torch.tensor([0]),
                                       torch.tensor([0]), torch.tensor([0])],
                                      (k & 0xFFFFFFFF, k >> 32))
        for j, x in enumerate(words):
            if 4 * g + j < 11:
                assert float(u[4 * g + j]) == (int(x) >> 8) * 2.0**-24


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("n,zero", [(1, False), (3, False), (4099, False), (4099, True)])
def test_inline_plain_is_sr_quantize_of_the_philox_uniforms(n, zero, bits, out_dtype):
    """Bit-equal to ``sr_quantize(w, delta, u)`` with ``u`` the plain
    Philox uniforms of the key, cast to the output type; and to the
    reference's rounding (``sr_quant_fake_ref``, clip, bypass, STE) fed
    those uniforms."""
    w = _w(n, seed=n + bits, zero=zero)
    delta = tq.delta_from_bits(bits)
    u = tref.philox_uniforms_plain(KEY, n)
    got = tops.sr_quantize_inline(w, delta, KEY, out_dtype)
    assert got.dtype == out_dtype and got.shape == w.shape
    assert torch.equal(got, tq.sr_quantize(w, delta, u).to(out_dtype))
    assert torch.equal(got, tsq.sr_quant_inline_plain(w, delta.reshape(1), KEY, out_dtype))
    wf = jnp.asarray(w.numpy())
    s = jq.tensor_scale(wf)
    step = s * jnp.float32(delta)
    q = jnp.where(step > 0, jnp.clip(jref.sr_quant_fake_ref(wf, jnp.asarray(u.numpy()), step),
                                     -s, s), wf)
    want = np.asarray((wf + (q - wf)).astype(jnp.float32 if out_dtype == torch.float32
                                             else jnp.bfloat16)).astype(np.float32)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    if bits == 32 or zero:
        assert torch.equal(got, w.to(out_dtype))


def test_keyed_gradient_is_the_identity():
    """The backward of the keyed entry is the straight-through identity: the
    incoming gradient cast to w's dtype, as ``q + (w - w.detach())`` then
    ``.to(bf16)`` gave."""
    w = _w(24 * 40, seed=5).reshape(24, 40).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((24, 40))
                         .astype(np.float32)).to(torch.bfloat16)
    out = tq.sr_quantize_keyed(w, tq.delta_from_bits(4), KEY, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.requires_grad
    (gw,) = torch.autograd.grad(out, w, g)
    assert gw.dtype == torch.float32 and torch.equal(gw, g.to(torch.float32))
    w2 = w.detach().clone().requires_grad_()
    old = tq.sr_quantize(w2, tq.delta_from_bits(4),
                         tref.philox_uniforms_plain(KEY, w2.numel()).reshape(24, 40))
    (gold,) = torch.autograd.grad(old.to(torch.bfloat16), w2, g)
    assert torch.equal(gw, gold) and torch.equal(out, old.to(torch.bfloat16))


def test_uniforms_are_flat():
    """Chi-square of 64 equal bins over 2^20 draws: 63 degrees of freedom,
    mean 63, sd 11.2; the bound is 6 sd above the mean (a fixed key, so
    the test is deterministic).  Mean within 4 sd of 1/2."""
    n, bins = 2**20, 64
    u = tref.philox_uniforms_plain(KEY, n)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    counts = torch.bincount((u * bins).to(torch.int64), minlength=bins).to(torch.float64)
    chi2 = float(((counts - n / bins) ** 2 / (n / bins)).sum())
    assert chi2 < 63 + 6 * (2 * 63) ** 0.5, chi2
    assert abs(float(u.to(torch.float64).mean()) - 0.5) < 4 * (1 / 12 / n) ** 0.5


def test_sr_is_unbiased():
    """E[Q(w)] = w: 2^18 copies of one value between two grid points, each
    rounded with its own uniform; the mean lies within 5 sd of the value
    (sd = sqrt(p (1 - p)) * step / sqrt(n))."""
    n, bits = 2**18, 4
    w = torch.full((n,), 0.3)
    w[0] = 1.0                                  # the scale
    q = tops.sr_quantize_inline(w, tq.delta_from_bits(bits), KEY, torch.float32)[1:]
    step = 1.0 / (2**bits - 1)
    lo = np.floor(0.3 / step) * step
    p = (0.3 - lo) / step
    np.testing.assert_allclose(np.unique(q.numpy()), [lo, lo + step], rtol=1e-6)
    sd = (p * (1 - p)) ** 0.5 * step / (n - 1) ** 0.5
    assert abs(float(q.to(torch.float64).mean()) - 0.3) < 5 * sd


def test_keys_are_deterministic_per_site():
    """Same key, same values; another client, round or path, other ones."""
    d = SRDraws(0, 3)
    k = d.weight_key(1, "blocks/mlp/w_up")
    assert k == d.weight_key(1, "blocks/mlp/w_up") == SRDraws(0, 3).weight_key(
        1, "blocks/mlp/w_up")
    others = {d.weight_key(0, "blocks/mlp/w_up"), d.weight_key(1, "blocks/mlp/w_down"),
              SRDraws(0, 4).weight_key(1, "blocks/mlp/w_up"),
              SRDraws(1, 3).weight_key(1, "blocks/mlp/w_up")}
    assert k not in others and len(others) == 4
    w, delta = _w(1000, seed=8), tq.delta_from_bits(8)
    a = tops.sr_quantize_inline(w, delta, k, torch.float32)
    assert torch.equal(a, tops.sr_quantize_inline(w, delta, k, torch.float32))
    for other in others:
        assert not torch.equal(a, tops.sr_quantize_inline(w, delta, other, torch.float32))
    # SRDraws.weights hands out the uniforms the keyed entry draws
    assert torch.equal(d.weights(1, "blocks/mlp/w_up", (10, 100), "cpu").reshape(-1),
                       tref.philox_uniforms_plain(k, 1000))
    # the seeded quantizer keys a site by (seed, path hash), as the reference folds
    t = make_inline_quantizer(tq.delta_from_bits(8), seed=2, out_dtype=torch.bfloat16)
    from repro_torch.core.fwq import _stable_hash
    w2 = w.reshape(10, 100)                     # (a vector would be exempt)
    assert torch.equal(t("a/w", w2), tops.sr_quantize_inline(
        w2, delta, site_key(2, _stable_hash("a/w")), torch.bfloat16))


def test_inline_cuda_wrapper_refuses_cpu_tensors_and_bad_arguments():
    with pytest.raises(ValueError, match="CUDA"):
        tsq.sr_quant_inline_cuda(torch.zeros(4), torch.ones(1), 1)
    with pytest.raises(ValueError, match="CUDA"):
        tsq.philox4x32_cuda(torch.zeros((1, 4), dtype=torch.int32),
                            torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="out_dtype"):
        tops.sr_quantize_inline(torch.zeros(4), torch.ones(()), 1, torch.float16)
    with pytest.raises(ValueError, match="delta"):
        tops.sr_quantize_inline(torch.zeros(4), torch.ones(2), 1, torch.float32)
    with pytest.raises(ValueError, match="key"):
        tops.sr_quantize_inline(torch.zeros(4), torch.ones(()), 2**64, torch.float32)
    assert tops.sr_quantize_inline(torch.zeros((0, 3)), torch.ones(()), 1,
                                   torch.bfloat16).shape == (0, 3)
