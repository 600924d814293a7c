"""The keyed segment entries of K1 (the fl-sim round) and K2 (the trainer's
SR wire) on the CPU.

Both draw their uniforms inside the kernel from a 64-bit key: element ``(c,
p)`` takes word ``p % 4`` of Philox4x32-10 at counter ``(p / 4, p / 4 >> 32,
c, 0)``, ``p`` the column of the leaves concatenated.  Here their plain
versions are held to the u-taking entries fed
``philox_uniforms_plain(key, ..., stream=c)`` (bit for bit), to the
reference's rounding arithmetic fed those uniforms, to the wire's guard, to
the statistics SR promises, and the fl round and the trainer's wire to the
same runs fed the keyed uniforms through their seams.  The CUDA kernels are
held to the same plain versions by ``chip_smoke.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels import ref as jref
from repro_torch.core import quantization as tq
from repro_torch.core.fwq import delta_for_clients, site_key
from repro_torch.dist import collectives as tcol
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sr_quant as tsq
from repro_torch.launch.steps import SRDraws

KEY = site_key(0, 7, 17)
#: leaf sizes, none a multiple of 4, so 4-groups straddle leaves
SIZES = {1: [1003], 3: [5, 130, 1], 7: [3, 17, 2, 41, 1, 9, 66]}


def _leaves(sizes, C, seed=0, scale=0.01):
    """Per leaf, C clients' f32 gradients (leaf l at scale * (l + 1))."""
    rng = np.random.default_rng(seed)
    return [[torch.from_numpy((rng.standard_normal(n) * scale * (i + 1)).astype(np.float32))
             for _c in range(C)] for i, n in enumerate(sizes)]


def _stream(key, C, P):
    """Client c's row: stream c, built here word by word from the definition."""
    return torch.stack([tref.philox_uniforms_plain(key, P, stream=c) for c in range(C)])


def _offsets(sizes):
    return torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)


def _axes(n):
    return tcol.AxisCtx(("data",), None, ("data",), (("data", n),))


def _wire_slices(sizes, n, key):
    """The keyed wire's uniforms cut into one (n, size) tensor a leaf."""
    return list(_stream(key, n, sum(sizes)).split(sizes, dim=1))


# ------------------------------------------------------------------ K2 keyed
@pytest.mark.parametrize("L", [1, 3, 7])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
@pytest.mark.parametrize("bits", [4, 8, 12, 16])
def test_keyed_pack_is_the_u_path_fed_the_client_streams(bits, dtype, L):
    """Codes bit-equal to K2's u-taking plain version fed stream ``c`` for
    client ``c``; the pitch ``s * fl32(1 / lim)`` with ``s`` the leaf's max
    over the clients; no non-finite count.  At bits 4 also equal to the
    reference's pack arithmetic (``sr_quant_pack_ref``) on those uniforms."""
    lim = 2**bits - 1
    for C in (1, 2, 4):
        leaves = _leaves(SIZES[L], C, seed=bits * 10 + L + C)
        codes, step, bad = tops.sr_pack_keyed(leaves, KEY, lim, dtype)
        g = torch.cat([torch.stack(leaf) for leaf in leaves], dim=1)
        s = torch.stack([torch.stack(leaf).abs().amax() for leaf in leaves])
        want_step = s * tcol.f32_reciprocal(lim)
        assert torch.equal(step, want_step)
        u = _stream(KEY, C, g.shape[1])
        want = tsq.sr_pack_segments_plain(g, _offsets(SIZES[L]), want_step, u, lim, dtype)
        assert codes.dtype == dtype and torch.equal(codes, want)
        assert int(bad) == 0
        if bits == 4:
            step_e = torch.repeat_interleave(want_step, torch.tensor(SIZES[L]))
            ref = jref.sr_quant_pack_ref(jnp.asarray(g.numpy()), jnp.asarray(u.numpy()),
                                         jnp.asarray(step_e.numpy()), lim)
            np.testing.assert_array_equal(codes.numpy().astype(np.int32),
                                          np.asarray(ref).astype(np.int32))


@pytest.mark.parametrize("bits", range(1, 32))
def test_keyed_pitch_is_s_times_the_f32_reciprocal(bits):
    """The pitch K2 makes on the device is ``s * fl32(1 / lim)``, the f32
    reciprocal rounded to nearest (``lim`` itself rounded to f32 above 2^24)."""
    lim = 2**bits - 1
    leaves = _leaves([37, 6], 3, seed=bits, scale=3.0)
    _codes, step, _bad = tsq.sr_pack_keyed_plain(leaves, KEY, lim, torch.int32)
    s = torch.stack([torch.stack(leaf).abs().amax() for leaf in leaves])
    recip = tcol.f32_reciprocal(lim)
    assert recip == np.float32(1) / np.float32(lim)
    assert torch.equal(step, s * recip)


def _nonfinite_leaves(C=3):
    leaves = _leaves([9, 14, 5], C, seed=11, scale=1.0)
    leaves[0][0][1], leaves[1][2][3], leaves[1][0][0] = np.nan, np.inf, -np.inf
    leaves[2][1][:] = np.inf                 # a client leaf with no finite value
    return leaves


def test_keyed_saturate_is_the_guard_then_the_u_path():
    """``saturate``: codes and means equal ``_nonfinite_guard`` followed by
    the u-taking path on the same uniforms; the count is reported."""
    leaves, lim = _nonfinite_leaves(), 255
    codes, step, bad = tsq.sr_pack_keyed_plain(leaves, KEY, lim, torch.int16)
    guarded = tcol._nonfinite_guard([torch.stack(leaf) for leaf in leaves], "saturate")
    s = torch.stack([g.abs().amax() for g in guarded])
    want_step = torch.where(s > 0, s, torch.ones_like(s)) * tcol.f32_reciprocal(lim)
    assert torch.equal(step, want_step)
    sizes = [g.shape[1] for g in guarded]
    want = tsq.sr_pack_segments_plain(torch.cat(guarded, dim=1), _offsets(sizes), want_step,
                                      _stream(KEY, 3, sum(sizes)), lim, torch.int16)
    assert torch.equal(codes, want)
    assert int(bad) == 3 + 5
    keyed = tcol.quantized_psum_batch(_axes(3), leaves, None, 8, key=KEY,
                                      on_nonfinite="saturate")
    given = tcol.quantized_psum_batch(_axes(3), [torch.stack(leaf) for leaf in leaves],
                                      _wire_slices(sizes, 3, KEY), 8, on_nonfinite="saturate")
    for k, g in zip(keyed, given):
        assert torch.isfinite(k).all() and torch.equal(k, g)


def _count_host_reads(monkeypatch):
    reads = []
    for name in ("__int__", "item", "tolist", "__bool__", "__float__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, **kw):
            reads.append(1)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, spy)
    return reads


def test_keyed_raise_reads_the_count_once(monkeypatch):
    """``raise``: the same ``FloatingPointError`` as the u-taking path, after
    one host read; finite gradients also cost one read and give the u-taking
    path's means."""
    leaves = _nonfinite_leaves()
    stacked = [torch.stack(leaf) for leaf in leaves]
    us = _wire_slices([9, 14, 5], 3, KEY)
    with pytest.raises(FloatingPointError) as want:
        tcol.quantized_psum_batch(_axes(3), stacked, us, 8)
    reads = _count_host_reads(monkeypatch)
    with pytest.raises(FloatingPointError, match="8 non-finite gradient values") as got:
        tcol.quantized_psum_batch(_axes(3), leaves, None, 8, key=KEY)
    assert str(got.value) == str(want.value) and len(reads) == 1
    finite = _leaves([9, 14, 5], 3, seed=2)
    reads.clear()
    keyed = tcol.quantized_psum_batch(_axes(3), finite, None, 8, key=KEY)
    assert len(reads) == 1
    monkeypatch.undo()
    given = tcol.quantized_psum_batch(_axes(3), [torch.stack(leaf) for leaf in finite], us, 8)
    assert all(torch.equal(k, g) for k, g in zip(keyed, given))
    with pytest.raises(ValueError, match="on_nonfinite"):
        tcol.quantized_psum_batch(_axes(3), finite, None, 8, key=KEY, on_nonfinite="ignore")
    with pytest.raises(ValueError, match="exactly one"):
        tcol.quantized_psum_batch(_axes(3), stacked, us, 8, key=KEY)


def test_keyed_wire_mean_is_unbiased():
    """Over many keys the keyed wire's mean approaches the exact mean: each
    client's code error is unbiased with variance <= step^2 / 4."""
    rng = np.random.default_rng(4)
    C, n, bits, K = 4, 2000, 4, 200
    leaves = [[torch.from_numpy(rng.standard_normal(n).astype(np.float32)) for _ in range(C)]]
    exact = torch.stack(leaves[0]).double().mean(0)
    acc = torch.zeros(n, dtype=torch.float64)
    for k in range(K):
        acc += tcol.quantized_psum_batch(_axes(C), leaves, None, bits,
                                         key=site_key(9, k, 17))[0].double()
    step = float(torch.stack(leaves[0]).abs().max()) / (2**bits - 1)
    sigma = step / 2 / np.sqrt(C) / np.sqrt(K)       # std of the mean over the keys
    err = acc / K - exact
    assert float(err.abs().max()) < 5.5 * sigma
    assert abs(float(err.mean())) < 5 * sigma / np.sqrt(n)


def test_trainer_wire_is_keyed_and_the_seam_takes_given_uniforms():
    """``SRDraws.wire`` gives no uniforms, so the step's wire is one keyed
    K2 call under ``wire_key()``; the means equal a u-taking call fed
    the wire key's client streams cut into leaves."""
    draws = SRDraws(3, 5)
    assert draws.wire(0, 4, (7,), "cpu") is None
    assert draws.wire_key() == site_key(3, 5, 17)
    sizes = [12, 7, 33]
    leaves = _leaves(sizes, 4, seed=8)
    u = tref.philox_streams_plain(draws.wire_key(), 4, sum(sizes))
    assert torch.equal(u, _stream(draws.wire_key(), 4, sum(sizes)))
    keyed = tcol.quantized_psum_batch(_axes(4), leaves, None, 8, key=draws.wire_key())
    given = tcol.quantized_psum_batch(_axes(4), [torch.stack(leaf) for leaf in leaves],
                                      list(u.split(sizes, dim=1)), 8)
    assert all(torch.equal(k, g) for k, g in zip(keyed, given))


# ------------------------------------------------------------------ K1 keyed
@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("L", [1, 3, 7])
def test_keyed_segments_are_the_u_path_fed_the_client_streams(L, C):
    """K1's keyed segment entry: bit-equal to the segment entry fed stream
    ``c`` for client ``c`` at ``s = tensor_scale(leaf)`` (the STE value), a
    zero delta returning w; and to the reference's rounding
    (``sr_quant_fake_ref``, clip, bypass, STE) on those uniforms."""
    leaves = [leaf[0] * 30 for leaf in _leaves(SIZES[L], 1, seed=L * 3 + C)]
    delta = delta_for_clients(np.array([8, 32, 4, 16][:C]))
    got = tops.sr_quantize_segments_keyed(leaves, delta, KEY)
    w = torch.cat(leaves)
    s = torch.stack([tq.tensor_scale(x) for x in leaves])
    u = _stream(KEY, C, w.numel())
    want = tsq.sr_quant_segments_plain(w, _offsets(SIZES[L]), s, delta, u)
    assert torch.equal(tsq.sr_quant_segments_keyed_plain(leaves, delta, KEY), want)
    assert torch.equal(got, want)
    if C > 1:
        assert torch.equal(got[1], w)
    for c in range(C):
        for i, x in enumerate(leaves):
            a = int(_offsets(SIZES[L])[i])
            wf = jnp.asarray(x.numpy())
            sj = jq.tensor_scale(wf)
            step = sj * jnp.float32(float(delta[c]))
            uj = jnp.asarray(u[c, a:a + x.numel()].numpy())
            q = jnp.where(step > 0, jnp.clip(jref.sr_quant_fake_ref(wf, uj, step), -sj, sj), wf)
            np.testing.assert_array_equal(got[c, a:a + x.numel()].numpy(),
                                          np.asarray(wf + (q - wf)))


def _params():
    rng = np.random.default_rng(6)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return {"conv1/w": t(3, 3, 2, 5), "conv1/norm": t(5), "head/w": t(7, 3),
            "head/bias": t(3), "mid/w": t(1, 13)}


def test_quantize_clients_with_the_key_is_the_u_path_fed_its_uniforms():
    params = _params()
    delta = delta_for_clients(np.array([8, 4, 16]))
    P = tq.quantizable_size(params)[0]
    keyed = tq.quantize_clients(params, delta, key=KEY)
    given = tq.quantize_clients(params, delta, _stream(KEY, 3, P))
    assert keyed.keys() == given.keys() == {"conv1/w", "head/w", "mid/w"}
    assert all(torch.equal(keyed[p], given[p]) for p in keyed)
    with pytest.raises(ValueError, match="exactly one"):
        tq.quantize_clients(params, delta, _stream(KEY, 3, P), key=KEY)


def test_stream_zero_is_the_inline_stream():
    """At one client and one leaf the keyed entries draw K1's inline stream:
    K1's keyed segment entry equals the inline entry (f32 out), and stream 0
    is the stream with no word ``c``."""
    w = _leaves([4099], 1, seed=1, scale=0.3)[0][0]
    delta = tq.delta_from_bits(8).reshape(1)
    assert torch.equal(tref.philox_uniforms_plain(KEY, 4099, stream=0),
                       tref.philox_uniforms_plain(KEY, 4099))
    assert not torch.equal(tref.philox_uniforms_plain(KEY, 4099, stream=1),
                           tref.philox_uniforms_plain(KEY, 4099))
    got = tops.sr_quantize_segments_keyed([w], delta, KEY)[0]
    assert torch.equal(got, tsq.sr_quant_inline_plain(w, delta, KEY, torch.float32))


def test_keyed_entries_refuse_tables_past_their_size():
    """The by-value table holds 64 leaves and 256 (client, leaf) pointers:
    4 clients x 64 leaves fit, 65 leaves or 5 x 64 do not; the CUDA wrappers
    refuse CPU tensors before they build anything."""
    tsq.sr_pack_keyed_plain(_leaves([3] * 64, 4), KEY, 15, torch.int8)
    with pytest.raises(ValueError, match="table"):
        tsq.sr_pack_keyed_plain(_leaves([3] * 65, 1), KEY, 15, torch.int8)
    with pytest.raises(ValueError, match="table"):
        tsq.sr_pack_keyed_plain(_leaves([3] * 64, 5), KEY, 15, torch.int8)
    delta = delta_for_clients(np.array([8]))
    tsq.sr_quant_segments_keyed_plain([x[0] for x in _leaves([3] * 64, 1)], delta, KEY)
    with pytest.raises(ValueError, match="table"):
        tsq.sr_quant_segments_keyed_plain([x[0] for x in _leaves([3] * 65, 1)], delta, KEY)
    with pytest.raises(ValueError, match="CUDA"):
        tsq.sr_pack_keyed_cuda(_leaves([5], 2), KEY, 15, torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tsq.sr_quant_segments_keyed_cuda([torch.ones(5)], delta, KEY)
    with pytest.raises(ValueError, match="key"):
        tsq.sr_pack_keyed_plain(_leaves([5], 2), 2**64, 15, torch.int8)
    with pytest.raises(ValueError, match="no kernel"):
        tops.sr_pack_keyed([[torch.ones(5, device="meta")]], KEY, 15, torch.int8)


def test_seg_blocks_give_every_leaf_its_share():
    """Each leaf owns at least one block, at most one a 4-group a thread,
    and ~8 blocks an SM in all over the rows."""
    blk = tsq.seg_blocks([0, 5, 4096 * 11008, 33], 4, 132)
    sizes = np.diff(blk)
    assert blk[0] == 0 and (sizes >= 1).all()
    assert sizes[1] == 1 and sizes[3] == 1 and sizes[2] == 8 * 132 // 4
    blk = tsq.seg_blocks([8 * 4096, 8 * 4096, 4096], 4, 132)
    assert list(np.diff(blk)) == [32, 32, 4]


# --------------------------------------------------------- the fl-sim round
def _sim():
    from repro_torch.fed.simulation import FLSimulation, SimConfig
    from repro_torch.models import cnn

    model = cnn.mobilenet(width=8, n_stages=2)
    sim = FLSimulation(cnn.xent_loss(model), model.init,
                       SimConfig(n_clients=3, lr=0.1, seed=4), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.standard_normal((3, 4, 16, 16, 3)).astype(np.float32)),
             "y": torch.from_numpy(rng.integers(0, 10, (3, 4)))}
    return sim, batch


def test_fl_round_with_the_key_equals_the_round_fed_its_uniforms(monkeypatch):
    """``run_round`` draws in K1 from ``round_key`` (one keyed call, no
    ``round_uniforms``); a run whose ``round_uniforms`` is replaced, on the
    instance or on the class, takes the u-path with the same uniforms and
    ends bit-equal."""
    from repro_torch.fed.simulation import FLSimulation

    bits = np.array([8, 16, 4])
    calls = {"keyed": 0, "given": 0}
    keyed_fn, given_fn = tops.sr_quantize_segments_keyed, tops.sr_quantize_segments

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tops, "sr_quantize_segments_keyed", spy("keyed", keyed_fn))
    monkeypatch.setattr(tops, "sr_quantize_segments", spy("given", given_fn))
    sim, batch = _sim()
    assert sim.round_key(2) == int(np.random.SeedSequence((4, 2)).generate_state(
        1, np.uint64)[0])
    u = sim.round_uniforms(0, 3)
    keyed = sim.run_round(batch, bits)
    assert calls == {"keyed": 1, "given": 0}
    inst, _ = _sim()
    inst.round_uniforms = lambda r, n: u
    given = inst.run_round(batch, bits)
    assert calls == {"keyed": 1, "given": 1}
    assert keyed["loss"] == given["loss"]
    assert all(torch.equal(sim.params[k], inst.params[k]) for k in sim.params)
    seen = []

    def patched(self, r, n):
        seen.append((r, n))
        return u

    monkeypatch.setattr(FLSimulation, "round_uniforms", patched)
    cls, _ = _sim()
    cls.run_round(batch, bits)
    assert seen == [(0, 3)] and calls == {"keyed": 1, "given": 2}
    assert all(torch.equal(sim.params[k], cls.params[k]) for k in sim.params)


# ------------------------------------------------------- trees past one table
def _ragged(L, seed):
    """L leaf sizes, none a multiple of 4, so 4-groups straddle leaves and
    the groups' seams."""
    return [int(n) for n in np.random.default_rng(seed).integers(1, 40, L) * 4 + 1 +
            np.arange(L) % 3]


@pytest.mark.parametrize("L", [65, 130])
def test_keyed_k1_splits_trees_past_its_table(L):
    """K1's keyed segment entry at 65 and 130 leaves (tables of at most 64):
    bit-equal to the u-taking entry fed the client streams of the whole
    tree, and each group to the one-table call on the leaves that fit."""
    sizes = _ragged(L, L)
    leaves = [leaf[0] * 30 for leaf in _leaves(sizes, 1, seed=L)]
    delta = delta_for_clients(np.array([8, 32, 4]))
    assert [g[:2] for g in tsq.table_groups(sizes, 1, "t")] == \
        [(a, min(a + 64, L)) for a in range(0, L, 64)]
    got = tops.sr_quantize_segments_keyed(leaves, delta, KEY)
    w = torch.cat(leaves)
    s = torch.stack([tq.tensor_scale(x) for x in leaves])
    want = tsq.sr_quant_segments_plain(w, _offsets(sizes), s, delta, _stream(KEY, 3, w.numel()))
    assert torch.equal(got, want)
    one = tops.sr_quantize_segments_keyed(leaves[:64], delta, KEY)
    assert torch.equal(got[:, :one.shape[1]], one)


def test_quantize_clients_takes_trees_past_the_table():
    rng = np.random.default_rng(11)
    params = {f"l{i:03d}/w": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
              for i in range(65)}
    delta = delta_for_clients(np.array([8, 4]))
    keyed = tq.quantize_clients(params, delta, key=KEY)
    given = tq.quantize_clients(params, delta, _stream(KEY, 2, 65 * 16))
    assert len(keyed) == 65 and all(torch.equal(keyed[p], given[p]) for p in keyed)


@pytest.mark.parametrize("C, L", [(26, 10), (4, 70)])
def test_keyed_k2_splits_trees_past_its_table(C, L):
    """K2's keyed entry at 26 clients x 10 leaves (260 pointers) and 4 x 70
    leaves: codes, pitch and count bit-equal to the u-taking entry fed the
    client streams of the whole tree, and to one-table calls on the leaves
    that fit; the wire's means as well."""
    sizes = _ragged(L, C + L)
    leaves = _leaves(sizes, C, seed=C)
    assert len(tsq.table_groups(sizes, C, "t")) == 2
    codes, step, bad = tops.sr_pack_keyed(leaves, KEY, 127, torch.int16)
    g = torch.cat([torch.stack(leaf) for leaf in leaves], dim=1)
    s = torch.stack([torch.stack(leaf).abs().amax() for leaf in leaves])
    want_step = s * tref.f32_reciprocal(127)
    want = tsq.sr_pack_segments_plain(g, _offsets(sizes), want_step,
                                      _stream(KEY, C, g.shape[1]), 127, torch.int16)
    assert torch.equal(codes, want) and torch.equal(step, want_step) and int(bad) == 0
    l1 = tsq.table_groups(sizes, C, "t")[0][1]
    one, one_step, _ = tops.sr_pack_keyed(leaves[:l1], KEY, 127, torch.int16)
    assert torch.equal(codes[:, :one.shape[1]], one) and torch.equal(step[:l1], one_step)
    keyed = tcol.quantized_psum_batch(_axes(C), leaves, None, 8, key=KEY)
    given = tcol.quantized_psum_batch(_axes(C), [torch.stack(leaf) for leaf in leaves],
                                      _wire_slices(sizes, C, KEY), 8)
    assert all(torch.equal(k, gv) for k, gv in zip(keyed, given))


@pytest.mark.parametrize("group", [0, 1])
def test_keyed_wire_raise_sees_a_nan_in_any_group(group):
    """The groups' non-finite counts are summed on the card: "raise" raises
    for a NaN in the first or the last table, "saturate" counts it."""
    C, sizes = 26, [5] * 10
    leaves = _leaves(sizes, C, seed=3)
    leaves[0 if group == 0 else 9][7][2] = float("nan")
    _codes, _step, bad = tops.sr_pack_keyed(leaves, KEY, 127, torch.int16)
    assert int(bad) == 1
    with pytest.raises(FloatingPointError, match="1 non-finite"):
        tcol.quantized_psum_batch(_axes(C), leaves, None, 8, key=KEY)


def test_keyed_wire_past_256_clients_names_the_roadmap():
    """One leaf's rows must fit one table: 257 clients on one card raise."""
    with pytest.raises(ValueError, match="ROADMAP queue 1, item 8"):
        tops.sr_pack_keyed(_leaves([3], 257), KEY, 127, torch.int16)


# ------------------------------------------- K2 split at its pass boundary
def _split(leaves, key, lim, dtype, c_rows=1):
    """The keyed wire as ranks of ``c_rows`` rows each run it, through
    ``ops``: pass 1 a rank, the max of the ranks' scales, pass 2 a rank at
    stream offset ``c0`` (its first row).  Returns (codes, step, count)."""
    C = len(leaves[0])
    ranks = [[leaf[c0:c0 + c_rows] for leaf in leaves] for c0 in range(0, C, c_rows)]
    firsts = [tops.sr_pack_keyed_scales(r) for r in ranks]
    smax = torch.cat([f[0] for f in firsts]).amax(dim=0)
    outs = [tops.sr_pack_keyed_scaled(r, smax, f[0], key, lim, dtype, c0=i * c_rows)
            for i, (r, f) in enumerate(zip(ranks, firsts))]
    assert all(torch.equal(o[1], outs[0][1]) for o in outs)
    return (torch.cat([o[0] for o in outs]), outs[0][1],
            sum(int(f[1]) for f in firsts))


@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("L", [1, 3, 7])
@pytest.mark.parametrize("dtype, bits", [(torch.int8, 4), (torch.int16, 8),
                                         (torch.int32, 12)])
def test_split_passes_compose_to_the_one_call_entry(dtype, bits, L, C):
    """Pass 1 on each row, the max of the rows' scales, pass 2 with ``c0 =
    c`` on row ``c``: the one-call keyed entry's codes, pitch and count bit
    for bit (and so at two rows a rank)."""
    leaves, lim = _leaves(SIZES[L], C, seed=C + L), 2**bits - 1
    codes, step, bad = tsq.sr_pack_keyed_plain(leaves, KEY, lim, dtype)
    got = _split(leaves, KEY, lim, dtype)
    assert torch.equal(got[0], codes) and torch.equal(got[1], step) and got[2] == int(bad)
    if C % 2 == 0:
        got2 = _split(leaves, KEY, lim, dtype, c_rows=2)
        assert torch.equal(got2[0], codes) and torch.equal(got2[1], step)


def test_split_passes_saturate_nonfinite_rows_as_the_one_call_entry():
    """NaN/Inf under "saturate": each row is clamped at its own largest
    finite |g| (pass 1's ``fmax``), the shared scale is finite."""
    leaves = _nonfinite_leaves(C=4)
    codes, step, bad = tsq.sr_pack_keyed_plain(leaves, KEY, 255, torch.int16)
    got = _split(leaves, KEY, 255, torch.int16)
    assert torch.equal(got[0], codes) and torch.equal(got[1], step)
    assert got[2] == int(bad) == 8 and torch.isfinite(step).all()
    fmax, n = tsq.sr_pack_keyed_scales_plain([[leaf[1]] for leaf in leaves])
    assert int(n) == 5 and fmax[0, 2] == 0.0            # leaf 2 of row 1: no finite value


@pytest.mark.parametrize("C, L", [(1, 65), (4, 70), (26, 10)])
def test_split_passes_take_trees_past_the_table(C, L):
    """Past one table (65 leaves of one row, 4 x 70, 26 x 10) ``ops`` splits
    both passes into the same groups of whole leaves: the one-call entry's
    codes, pitch and count bit for bit."""
    sizes = _ragged(L, C + L)
    leaves = _leaves(sizes, C, seed=C)
    assert len(tsq.table_groups(sizes, C, "t")) == 2
    codes, step, bad = tops.sr_pack_keyed(leaves, KEY, 127, torch.int16)
    got = _split(leaves, KEY, 127, torch.int16)
    assert torch.equal(got[0], codes) and torch.equal(got[1], step) and got[2] == int(bad)
    fmax, _n = tops.sr_pack_keyed_scales(leaves)
    assert fmax.shape == (C, L)


def test_split_entries_check_their_arguments():
    leaves = _leaves([5, 7], 2)
    fmax, _bad = tsq.sr_pack_keyed_scales_plain(leaves)
    smax = fmax.amax(dim=0)
    with pytest.raises(ValueError, match="smax"):
        tsq.sr_pack_keyed_scaled_plain(leaves, smax[:1], fmax, KEY, 15, torch.int8)
    with pytest.raises(ValueError, match="stream offset"):
        tsq.sr_pack_keyed_scaled_plain(leaves, smax, fmax, KEY, 15, torch.int8, c0=-1)
    with pytest.raises(ValueError, match="CUDA"):
        tsq.sr_pack_keyed_scales_cuda(leaves)
    with pytest.raises(ValueError, match="CUDA"):
        tsq.sr_pack_keyed_scaled_cuda(leaves, smax, fmax, KEY, 15, torch.int8)
    assert torch.equal(tref.philox_streams_plain(KEY, 2, 9, c0=3),
                       tref.philox_streams_plain(KEY, 5, 9)[3:])
