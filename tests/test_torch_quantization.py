"""Parity of the port's SR quantization (paper Eq. 1, kernel K1) with the
JAX reference on the CPU.

Both packages get the same numpy inputs and the same uniforms: the
reference's own draws (``jax.random.uniform`` of the key it would fold) are
handed to the port, whose quantizers take uniforms as a tensor.  Given the
same uniforms the two are bit-equal.  The CUDA kernel is held to the plain
version used here by ``chip_smoke.py`` on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fwq as jfwq
from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sr_quant import sr_quant_fake_kernel
from repro.models import cnn as jcnn
from repro_torch.core import fwq as tfwq
from repro_torch.core import quantization as tq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sr_quant as tsq
from repro_torch.models.convert import cnn_params_from_jax

FL_MODELS = {"resnet": dict(depth_blocks=(1, 1), width=8),
             "mobilenet": dict(width=8, n_stages=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, seed: int = 0):
    """Parameters of the reference CNN's structure (its own init's shapes)
    with values drawn by numpy."""
    shapes = jax.eval_shape(getattr(jcnn, arch)(**FL_MODELS[arch]).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda sd: jnp.asarray((rng.standard_normal(sd.shape) * 0.2).astype(np.float32)),
        shapes)


_jit_quantize_tree = jax.jit(jq.quantize_tree)


def _leaf_uniforms(tree, key):
    """The reference's per-leaf SR uniforms for ``quantize_tree(tree, ., key)``."""
    paths, leaves, treedef = jq._flatten_with_paths(tree)
    return jax.tree_util.tree_unflatten(treedef, [
        jax.random.uniform(jax.random.fold_in(key, i), leaf.shape, jnp.float32)
        for i, leaf in enumerate(leaves)])


_jit_leaf_uniforms = jax.jit(_leaf_uniforms)


class TestResolution:
    def test_delta_from_bits(self):
        bits = np.arange(1, 33)
        want = np.asarray(jq.delta_from_bits(bits))
        got = tq.delta_from_bits(bits).numpy()
        assert got.dtype == np.float32
        # the reference's jnp.exp2 is exact on these q (all bit lattices the
        # system uses); on the others XLA's CPU exp2 is a few ulp off while the
        # port forms 2**q exactly (ROADMAP §3)
        exp2_exact = (np.asarray(jnp.exp2(jnp.minimum(bits, 31).astype(jnp.float32)))
                      == 2.0 ** np.minimum(bits, 31)) | (bits >= 32)
        assert {1, 2, 4, 7, 8, 16, 32}.issubset(set(bits[exp2_exact].tolist()))
        np.testing.assert_array_equal(got[exp2_exact], want[exp2_exact])
        exact = np.where(bits >= 32, 0.0,
                         1.0 / (np.float32(2.0) ** np.minimum(bits, 31) - np.float32(1.0)))
        np.testing.assert_array_equal(got, exact.astype(np.float32))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        for b in (4, 8, 16, 32):
            assert float(tq.delta_from_bits(b)) == float(jq.delta_from_bits(b))

    def test_delta_for_clients(self):
        bits = np.array([8, 16, 32, 4, 2, 8])
        want = np.asarray(jfwq.delta_for_clients(bits))
        got = tfwq.delta_for_clients(bits)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)

    def test_policy_delta(self):
        from repro.api.precision import PrecisionPolicy as JPolicy
        from repro_torch.api.precision import PrecisionPolicy as TPolicy

        w = (8, 16, 32, 8)
        np.testing.assert_array_equal(TPolicy(weights=w).delta(4).numpy(),
                                      np.asarray(JPolicy(weights=w).delta(4)))

    @pytest.mark.parametrize("shape", [(3, 3, 3, 8), (64,), (17, 33)])
    def test_tensor_scale(self, shape):
        w = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
        for arr in (w, np.zeros(shape, np.float32)):
            want = np.asarray(jq.tensor_scale(jnp.asarray(arr)))
            assert tq.tensor_scale(_t(arr)).numpy() == want
        want = np.asarray(jq.channel_scale(jnp.asarray(w), axis=0))
        np.testing.assert_array_equal(tq.channel_scale(_t(w), axis=0).numpy(), want)


class TestSRQuantize:
    @pytest.mark.parametrize("bits", [1, 2, 4, 7, 8, 16, 24, 31, 32])
    @pytest.mark.parametrize("shape", [(3, 3, 3, 8), (17, 33)])
    def test_matches_reference(self, bits, shape):
        rng = np.random.default_rng(bits)
        w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
        key = jax.random.PRNGKey(bits)
        delta = np.asarray(jq.delta_from_bits(bits))
        want = np.asarray(jq.sr_quantize(jnp.asarray(w), delta, key))
        u = np.asarray(jax.random.uniform(key, shape, jnp.float32))
        got = tq.sr_quantize(_t(w), _t(delta), _t(u)).numpy()
        np.testing.assert_array_equal(got, want)

    def test_explicit_scale_and_zero_tensor(self):
        rng = np.random.default_rng(5)
        w = rng.standard_normal((8, 12)).astype(np.float32)
        key = jax.random.PRNGKey(5)
        u = np.asarray(jax.random.uniform(key, w.shape, jnp.float32))
        delta = np.float32(1 / 15)
        # a scale below max|w| makes the clip to [-s, s] bite
        want = np.asarray(jq.sr_quantize(jnp.asarray(w), delta, key, scale=jnp.float32(0.5)))
        got = tq.sr_quantize(_t(w), delta, _t(u), scale=torch.tensor(0.5)).numpy()
        np.testing.assert_array_equal(got, want)
        assert np.abs(got).max() <= 0.5
        z = np.zeros((4, 4), np.float32)
        want = np.asarray(jq.sr_quantize(jnp.asarray(z), delta, key))
        got = tq.sr_quantize(_t(z), delta, torch.zeros(4, 4)).numpy()
        np.testing.assert_array_equal(got, want)

    def test_delta_zero_bypasses_and_ste_is_identity(self):
        rng = np.random.default_rng(1)
        w = _t(rng.standard_normal((5, 7)).astype(np.float32)).requires_grad_()
        u = _t(rng.random((5, 7)).astype(np.float32))
        out = tq.sr_quantize(w, 0.0, u)
        assert torch.equal(out, w.detach())
        out = tq.sr_quantize(w, tq.delta_from_bits(4), u)
        assert not torch.equal(out, w.detach())
        g = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
        (gw,) = torch.autograd.grad((out * g).sum(), w)
        assert torch.equal(gw, g)           # straight-through: d out / d w = I
        # the value does not depend on whether a gradient is taken
        assert torch.equal(out.detach(), tq.sr_quantize(w.detach(), tq.delta_from_bits(4), u))

    def test_nearest_quantize(self):
        w = np.random.default_rng(2).standard_normal((6, 9)).astype(np.float32)
        for bits in (2, 8, 32):
            d = np.asarray(jq.delta_from_bits(bits))
            want = np.asarray(jq.nearest_quantize(jnp.asarray(w), d))
            np.testing.assert_array_equal(tq.nearest_quantize(_t(w), _t(d)).numpy(), want)

    def test_expected_quant_mse(self):
        w = np.random.default_rng(3).standard_normal((10, 10)).astype(np.float32)
        assert tq.expected_quant_mse(_t(w), 8) == pytest.approx(
            jq.expected_quant_mse(jnp.asarray(w), 8), rel=1e-6)


class TestPlainK1:
    @pytest.mark.parametrize("step", [0.0, 1e-3, 0.07, 1.0])
    def test_plain_matches_ref_and_interpret_kernel(self, step):
        rng = np.random.default_rng(int(step * 1000))
        w = (rng.standard_normal((256, 512)) * 0.2).astype(np.float32)
        u = rng.random((256, 512)).astype(np.float32)
        st = np.full((1, 1), step, np.float32)
        want = np.asarray(jref.sr_quant_fake_ref(jnp.asarray(w), jnp.asarray(u),
                                                 jnp.float32(step)))
        kern = np.asarray(sr_quant_fake_kernel(jnp.asarray(w), jnp.asarray(u),
                                               jnp.asarray(st), interpret=True))
        got = tref.sr_quant_fake_plain(_t(w), _t(u), np.float32(step)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, kern)
        if step == 0.0:
            np.testing.assert_array_equal(got, w)

    @pytest.mark.parametrize("bits", [2, 7, 8])
    def test_fused_matches_reference(self, bits):
        rng = np.random.default_rng(bits)
        w = (rng.standard_normal((37, 70)) * 0.5).astype(np.float32)
        key = jax.random.PRNGKey(11 + bits)
        want = np.asarray(jops.sr_quantize_fused(jnp.asarray(w), key, bits))
        u = np.asarray(jax.random.uniform(key, w.shape, jnp.float32))
        got = tops.sr_quantize_fused(_t(w), bits, _t(u))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)

    def test_segments_ragged(self):
        """One call over ragged (client, leaf) segments equals per-leaf
        ``sr_quantize`` at ``step = s_leaf * delta_client``, bypass included."""
        rng = np.random.default_rng(9)
        sizes = [5, 1, 130, 0, 33]
        leaves = [(rng.standard_normal(n) * (i + 1)).astype(np.float32)
                  for i, n in enumerate(sizes)]
        w = torch.from_numpy(np.concatenate(leaves))
        offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
        s = torch.stack([tq.tensor_scale(torch.from_numpy(x)) if x.size else torch.tensor(1.0)
                         for x in leaves])
        delta = tq.delta_from_bits(np.array([2, 32, 8, 16]))
        u = torch.from_numpy(rng.random((4, w.numel())).astype(np.float32))
        got = tops.sr_quantize_segments(w, offsets, s, delta, u)
        assert got.shape == (4, w.numel())
        for c in range(4):
            for i, x in enumerate(leaves):
                lo, hi = int(offsets[i]), int(offsets[i + 1])
                want = tq.sr_quantize(torch.from_numpy(x), delta[c], u[c, lo:hi], scale=s[i])
                assert torch.equal(got[c, lo:hi], want)
        assert torch.equal(got[1], w)       # delta 0: every leaf bypassed

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        w = torch.zeros(4)
        with pytest.raises(ValueError, match="CUDA"):
            tsq.sr_quant_segments_cuda(w, torch.tensor([0, 4], dtype=torch.int32),
                                       torch.ones(1), torch.ones(1), torch.zeros(1, 4))

    def test_bad_shapes_raise(self):
        with pytest.raises(ValueError, match="offsets"):
            tops.sr_quantize_segments(torch.zeros(4), torch.tensor([0, 4], dtype=torch.int32),
                                      torch.ones(2), torch.ones(1), torch.zeros(1, 4))


class TestTree:
    @pytest.mark.parametrize("arch", sorted(FL_MODELS))
    def test_leaf_order_and_quantizable_size(self, arch):
        ref = _ref_params(arch)
        port = cnn_params_from_jax(ref)
        paths, _leaves, _ = jq._flatten_with_paths(ref)
        tpaths, _ = tq._flatten_with_paths(port)
        assert tpaths == paths
        assert tq.quantizable_size(port) == jq.quantizable_size(ref)
        assert tq.quantizable_size(port, exempt=None) == jq.quantizable_size(ref, exempt=None)
        ref_q = [i for i, (p, v) in enumerate(zip(paths, _leaves))
                 if not jq.default_exempt(p, v)]
        assert [i for i, _p in tq.quantizable_paths(port)] == ref_q

    def test_quantize_tree_and_clients(self):
        ref = _ref_params("resnet")
        port = cnn_params_from_jax(ref)
        bits = np.array([4, 8, 32])
        deltas = jfwq.delta_for_clients(bits)
        rows, per_client = [], []
        for c in range(len(bits)):
            key = jax.random.PRNGKey(100 + c)
            uni = cnn_params_from_jax(_jit_leaf_uniforms(ref, key))
            want = cnn_params_from_jax(_jit_quantize_tree(ref, deltas[c], key))
            got = tq.quantize_tree(port, torch.tensor(float(deltas[c])), uni)
            for p in want:
                np.testing.assert_array_equal(got[p].numpy(), want[p].numpy(), err_msg=p)
            rows.append(torch.cat([uni[p].reshape(-1) for _i, p in tq.quantizable_paths(port)]))
            per_client.append(got)
        qs = tq.quantize_clients(port, tfwq.delta_for_clients(bits), torch.stack(rows))
        assert set(qs) == {p for _i, p in tq.quantizable_paths(port)}
        for p, q in qs.items():
            for c in range(len(bits)):
                assert torch.equal(q[c], per_client[c][p]), (p, c)
        assert torch.equal(qs["head/w"][2], port["head/w"])      # 32 bits: bypass


def test_stable_hash_matches_reference():
    rng = np.random.default_rng(0)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789/_"))
    paths = ["".join(rng.choice(alphabet, int(rng.integers(1, 40)))) for _ in range(48)]
    paths += ["blocks/attn/wq", "s0b0/conv1"]
    assert [tfwq._stable_hash(p) for p in paths] == [jfwq._stable_hash(p) for p in paths]


def test_inline_quantizer_is_deterministic_per_site():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((6, 6)).astype(np.float32))
    t1 = tfwq.make_inline_quantizer(tq.delta_from_bits(4), seed=3)
    t2 = tfwq.make_inline_quantizer(tq.delta_from_bits(4), seed=3)
    assert torch.equal(t1("a/w", w), t2("a/w", w))
    assert not torch.equal(t1("a/w", w), t1("b/w", w))
    assert torch.equal(t1("a/norm", w), w)


def test_tree_quant_loss_is_the_loss_at_quantize_tree():
    """``make_tree_quant_loss`` evaluates the plain loss at ``quantize_tree``
    of the parameters (Algorithm 1 line 6)."""
    params = cnn_params_from_jax(_ref_params("mobilenet"))
    gen = torch.Generator().manual_seed(7)
    u = {p: torch.rand(params[p].shape, generator=gen)
         for _i, p in tq.quantizable_paths(params)}
    seen = {}

    def plain_loss(p, batch, rng):
        seen.update(p)
        return sum((v * v).sum() for v in p.values()), {}

    delta = tq.delta_from_bits(4)
    loss, _ = tfwq.make_tree_quant_loss(plain_loss)(params, None, delta, u)
    want = tq.quantize_tree(params, delta, u)
    assert all(torch.equal(seen[p], want[p]) for p in want)
    assert float(loss) == float(sum((v * v).sum() for v in want.values()))
    assert torch.equal(seen["stem/gn_s"], params["stem/gn_s"])     # exempt
