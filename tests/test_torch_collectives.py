"""Parity of the port's SR gradient wire with the JAX reference on the CPU.

* K2 (``sr_quant_pack``): the plain PyTorch version, which the CUDA kernel is
  held to bit for bit on the card, is ``array_equal`` to the reference's
  Pallas kernel (interpret mode) and to ``ref.sr_quant_pack_ref``.
* ``pack_quantize`` / ``dequantize`` and ``ops.sr_pack_fused`` given the
  reference's uniforms.
* ``quantized_psum_batch``: the reference runs under ``jax.vmap`` with the
  batch axis named (its collectives and ``axis_index`` see the vmapped axis
  as the clients); the port gets the same stacked gradients and the
  reference's per-client draws, and must give the same bits.
* Wire dtypes, byte reports and the FSDP plan, from the same shapes.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import quantization as jq
from repro.dist import collectives as jcol
from repro.dist import wire as jwire
from repro.kernels import ops as jops
from repro.kernels.ref import sr_quant_pack_ref
from repro.kernels.sr_quant import sr_quant_pack_kernel
from repro.launch.mesh import axis_ctx_for as jaxis_ctx_for
from repro.launch.steps import local_param_shapes as jlocal_param_shapes
from repro.models import common as jcommon
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core import quantization as tq
from repro_torch.dist import collectives as tcol
from repro_torch.dist import wire as twire
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sr_quant as tsq
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.steps import local_param_shapes
from repro_torch.models import common as tcommon
from repro_torch.models.model import build_model

JAX_AXES = jcol.AxisCtx(batch_axes=("data",), model_axis=None, fsdp_axes=("data",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------------------ K2
@pytest.mark.parametrize("bits", range(1, 9))
def test_k2_plain_matches_reference_kernel(bits):
    """Same w, u, step: the plain K2 equals the reference kernel (interpret
    mode) and its jnp oracle, including codes at the clip ``±(2^bits - 1)``
    and, at bits 8, the int8 saturation XLA applies to codes past 127."""
    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((37, 300)) * 0.4).astype(np.float32)
    u = rng.random(w.shape).astype(np.float32)
    lim = 2**bits - 1
    # a pitch whose grid ends inside the range: the clip must bite
    step = np.float32(np.abs(w).max() * 0.7) * np.float32(1.0 / lim)
    want = np.asarray(sr_quant_pack_kernel(jnp.asarray(w), jnp.asarray(u),
                                           jnp.full((1, 1), step, jnp.float32),
                                           bits=bits, interpret=True))
    oracle = np.asarray(sr_quant_pack_ref(jnp.asarray(w), jnp.asarray(u),
                                          jnp.float32(step), lim))
    got = tsq.sr_pack_segments_plain(_t(w.reshape(1, -1)),
                                     torch.tensor([0, w.size], dtype=torch.int32),
                                     torch.tensor([step]), _t(u.reshape(1, -1)), lim,
                                     torch.int8).numpy().reshape(w.shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    assert (np.abs(got) == min(lim, 127)).any()


def test_k2_segments_each_at_its_own_pitch():
    """Ragged leaves, several clients, int8/int16/int32 codes and a zero pitch
    (divides by 1): each (client, leaf) segment equals the oracle at its
    leaf's pitch."""
    rng = np.random.default_rng(7)
    sizes, C = [5, 1, 1000, 0, 33], 3
    P = sum(sizes)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    g = (rng.standard_normal((C, P)) * 3).astype(np.float32)
    u = rng.random((C, P)).astype(np.float32)
    step = np.array([0.01, 0.0, 0.05, 1.0, 0.002], np.float32)
    for bits, dtype in ((4, torch.int8), (8, torch.int16), (12, torch.int32)):
        lim = 2**bits - 1
        got = tops.sr_pack_segments(_t(g), torch.from_numpy(offsets), _t(step), _t(u), lim,
                                    dtype)
        assert got.dtype == dtype and got.shape == (C, P)
        for leaf in range(len(sizes)):
            lo, hi = offsets[leaf], offsets[leaf + 1]
            want = np.asarray(sr_quant_pack_ref(jnp.asarray(g[:, lo:hi]),
                                                jnp.asarray(u[:, lo:hi]),
                                                jnp.float32(step[leaf]), lim)
                              .astype(jnp.float32))
            # the oracle emits int8: compare where it cannot have saturated
            ok = np.abs(want) < 127
            np.testing.assert_array_equal(got[:, lo:hi].numpy()[ok], want[ok])


@pytest.mark.parametrize("bits", [2, 4, 7])
def test_sr_pack_fused_matches_reference(bits):
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((300, 257)).astype(np.float32)
    key = jax.random.PRNGKey(bits)
    u = np.asarray(jax.random.uniform(key, w.shape, dtype=jnp.float32))
    jc, js = jops.sr_pack_fused(jnp.asarray(w), key, bits)
    tc, ts = tops.sr_pack_fused(_t(w), bits, _t(u))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert float(ts) == float(js)


@pytest.mark.parametrize("bits", [1, 4, 7, 8, 15, 16, 20])
def test_pack_quantize_and_dequantize_match_reference(bits):
    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((5, 33, 70)) * 0.3).astype(np.float32)
    w[0, 3] = 0.0                                   # an all-zero channel
    key = jax.random.PRNGKey(bits)
    u = np.asarray(jax.random.uniform(key, w.shape, dtype=jnp.float32))
    for per_channel, axis in ((False, -1), (True, -1), (True, 0), (True, 1)):
        jp = jq.pack_quantize(jnp.asarray(w), bits, key, per_channel=per_channel, axis=axis)
        tp = tq.pack_quantize(_t(w), bits, _t(u), per_channel=per_channel, axis=axis)
        assert tp.codes.dtype == tq.storage_dtype(bits) and tp.nbytes() == jp.nbytes()
        np.testing.assert_array_equal(tp.codes.numpy(), np.asarray(jp.codes))
        np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))
        np.testing.assert_array_equal(tq.dequantize(tp).numpy(),
                                      np.asarray(jq.dequantize(jp)))
    with pytest.raises(ValueError, match="bits < 32"):
        tq.pack_quantize(_t(w), 32, _t(u))


# ------------------------------------------------------- quantized_psum_batch
@functools.lru_cache(maxsize=None)
def _ref_psum_fn(bits, mode):
    return jax.jit(jax.vmap(lambda gi, key: jcol.quantized_psum_batch(
        JAX_AXES, gi, key, bits, on_nonfinite=mode), in_axes=(0, None), axis_name="data"))


def _ref_psum(g, key, bits, mode):
    out = np.asarray(_ref_psum_fn(bits, mode)(jnp.asarray(g), key))
    assert all(np.array_equal(out[0], o, equal_nan=True) for o in out)
    return out[0]


def _ref_draws(key, n, shape):
    """Client c's uniforms: the reference folds the client id into the key."""
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, c), shape,
                                                   jnp.float32)) for c in range(n)])


def _axes(n):
    return tcol.AxisCtx(("data",), None, ("data",), (("data", n),))


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("bits", [4, 8, 32])
@pytest.mark.parametrize("mode", ["raise", "saturate"])
def test_quantized_psum_batch_bit_equal(n, bits, mode):
    rng = np.random.default_rng(n * 100 + bits)
    for trial in range(4):
        scale = rng.choice([1e-3, 1.0, 50.0], size=(n, 1, 1))
        g = (rng.standard_normal((n, 7, 33)) * scale).astype(np.float32)
        key = jax.random.PRNGKey(trial)
        want = _ref_psum(g, key, bits, mode)
        got = tcol.quantized_psum_batch(_axes(n), _t(g), _t(_ref_draws(key, n, g.shape[1:])),
                                        bits, on_nonfinite=mode)
        np.testing.assert_array_equal(got.numpy(), want)


def test_quantized_psum_batch_leaves_in_one_call():
    """Several leaves in one call (one K2 launch) equal one call per leaf; one
    client is the identity."""
    rng = np.random.default_rng(0)
    gs = [_t(rng.standard_normal((4,) + s).astype(np.float32)) for s in ((3, 5), (17,), ())]
    us = [_t(rng.random(g.shape).astype(np.float32)) for g in gs]
    together = tcol.quantized_psum_batch(_axes(4), gs, us, 8)
    for g, uu, t in zip(gs, us, together):
        assert torch.equal(t, tcol.quantized_psum_batch(_axes(4), g, uu, 8))
        assert t.shape == g.shape[1:]
    one = tcol.quantized_psum_batch(_axes(1), gs[0][:1], us[0][:1], 8)
    assert torch.equal(one, gs[0][0])


def test_nonfinite_guard():
    """``raise`` refuses NaN/Inf (the reference's own raise is pinned in
    ``tests/test_collectives.py``, in a subprocess: its raising callback can
    leave the runtime unusable); ``saturate`` clamps them to the reference's
    codes."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((2, 6, 5)).astype(np.float32)
    g[0, 1, 1], g[1, 2, 3], g[1, 0, 0] = np.nan, np.inf, -np.inf
    key = jax.random.PRNGKey(5)
    u = _t(_ref_draws(key, 2, g.shape[1:]))
    with pytest.raises(FloatingPointError, match="3 non-finite gradient values"):
        tcol.quantized_psum_batch(_axes(2), _t(g), u, 8)
    want = _ref_psum(g, key, 8, "saturate")
    got = tcol.quantized_psum_batch(_axes(2), _t(g), u, 8, on_nonfinite="saturate")
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="on_nonfinite"):
        tcol.quantized_psum_batch(_axes(2), _t(g), u, 8, on_nonfinite="ignore")


def test_wire_pitch_is_the_reciprocal_product():
    """The reference divides by ``lim``; XLA runs it as a product with the
    f32 reciprocal.  The port matches the running code on 4,000 random
    scales, where an IEEE division would differ on many."""
    rng = np.random.default_rng(11)
    s = (10.0 ** rng.uniform(-6, 3, 4000)).astype(np.float32)
    for bits in (4, 8, 12):
        lim = float(2**bits - 1)
        want = np.asarray(jax.jit(lambda x: x / lim)(jnp.asarray(s)))
        got = (_t(s) * tcol.f32_reciprocal(2**bits - 1)).numpy()
        np.testing.assert_array_equal(got, want)
    ieee = (_t(s) / 255.0).numpy()
    want = np.asarray(jax.jit(lambda x: x / 255.0)(jnp.asarray(s)))
    assert (ieee != want).sum() > 100


# ------------------------------------------------------------ host accounting
def test_wire_dtypes_match_reference():
    for bits in range(1, 31):
        for n in (1, 2, 3, 4, 16, 256, 40000):
            try:
                want = np.dtype(jcol.wire_dtype(bits, n))
            except ValueError:
                with pytest.raises(ValueError, match="int32 max"):
                    tcol.wire_dtype(bits, n)
                continue
            assert np.dtype(tcol.wire_dtype(bits, n)) == want
    for env in ((32,), (8,), (4, 8, 16, 32), (2, 30), (16, 31)):
        for n in (2, 4, 300):
            try:
                want = jcol.envelope_wire_dtype(env, n)
            except ValueError:
                with pytest.raises(ValueError):
                    tcol.envelope_wire_dtype(env, n)
                continue
            got = tcol.envelope_wire_dtype(env, n)
            assert (got is None) == (want is None)
            if got is not None:
                assert np.dtype(got) == np.dtype(want)


def _fake_mesh(shape):
    """What the reference's size helpers read of a mesh."""
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


@pytest.mark.parametrize("arch,mesh", [("yi-6b", (4, 1)), ("yi-6b", (2, 1)),
                                       ("glm4-9b", (8, 1)), ("yi-6b", (2, 4, 1))])
def test_fsdp_plan_shapes_and_wire_report_match_reference(arch, mesh):
    """The FSDP plan, the per-shard shapes and the byte reports of a
    full-width config, from the same shapes in both packages."""
    spec = "x".join(map(str, mesh))
    jaxes = jaxis_ctx_for(_fake_mesh(mesh))
    taxes = tmesh.axis_ctx_for(spec)
    assert (taxes.dp, taxes.fsdp, taxes.tp) == (int(np.prod(mesh)), int(np.prod(mesh)), 1)
    assert (taxes.batch_axes, taxes.fsdp_axes) == (jaxes.batch_axes, jaxes.fsdp_axes)
    jm, tm = jbuild_model(jget_config(arch)), build_model(get_config(arch))
    jshapes = jlocal_param_shapes(jm, _fake_mesh(mesh), jaxes)
    tshapes = local_param_shapes(tm, taxes)
    jpaths, jleaves, _ = jcommon.tree_paths_leaves(jshapes)
    tpaths, tleaves = tcommon.tree_paths_leaves(tshapes)
    assert tpaths == jpaths
    assert [tuple(t.shape) for t in tleaves] == [tuple(j.shape) for j in jleaves]
    assert (tcommon.fsdp_plan(tshapes, taxes.fsdp, check_divisibility=False)[2]
            == jcommon.fsdp_plan(jshapes, taxes.fsdp, check_divisibility=False)[3])
    n = taxes.dp
    for bits in (4, 8, 16, 32):
        assert (twire.grad_wire_report(tshapes, fsdp=taxes.fsdp, n_clients=n, comm_bits=bits)
                == jwire.grad_wire_report(jshapes, fsdp=taxes.fsdp, n_clients=n,
                                          comm_bits=bits))
    seq = [8, 8, 4, 32, 16]
    assert (twire.grad_wire_rounds(tshapes, fsdp=taxes.fsdp, n_clients=n, comm_bits_seq=seq)
            == jwire.grad_wire_rounds(jshapes, fsdp=taxes.fsdp, n_clients=n,
                                      comm_bits_seq=seq))


def test_axis_context_and_mesh_specs():
    ax = tmesh.axis_ctx_for("4x1")
    assert (ax.dp, ax.fsdp, ax.tp, ax.dp_index()) == (4, 4, 1, 0)
    assert ax.at_client(3).dp_index() == 3 and ax.at_client(3).dp == 4
    with pytest.raises(ValueError, match="out of range"):
        ax.at_client(4)
    assert tmesh.parse_mesh("2x16x16") == ((2, 16, 16), ("pod", "data", "model"))
    assert tmesh.axis_ctx_for("2x3x1").batch_axes == ("pod", "data")
    assert tmesh.axis_ctx_for("2x3x1").dp == 6
    with pytest.raises(ValueError, match="torchrun"):   # one process a model shard
        tmesh.axis_ctx_for("2x2")
    with pytest.raises(ValueError, match="1-3"):
        tmesh.parse_mesh("1x1x1x1")
    assert tcol.AxisCtx().dp == 1                       # the serving context
    # the reference's FSDP divisibility error, from the same rule
    shapes = {"blocks/attn/wq": torch.empty((2, 6, 300), device="meta")}
    with pytest.raises(ValueError, match="not divisible by fsdp=4"):
        tcommon.fsdp_plan(shapes, 4)
