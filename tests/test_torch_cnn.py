"""Parity of the port's fl-sim CNNs (``repro_torch/models/cnn.py``) with the
JAX reference on the CPU: the same numpy parameters (moved across with
``cnn_params_from_jax``) and the same numpy images through both forwards,
then the cross-entropy loss and its gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro_torch.core.quantization import _flatten_with_paths
from repro_torch.models import cnn as tcnn
from repro_torch.models.convert import cnn_params_from_jax

# the fl-sim sizes (Session.run_fl_sim), and a wider 3-stage variant that
# strides twice
MODELS = {
    "resnet": dict(depth_blocks=(1, 1), width=8),
    "mobilenet": dict(width=8, n_stages=2),
    "mobilenet4": dict(width=8, n_stages=4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _factories(name):
    arch = name.rstrip("0123456789")
    return getattr(jcnn, arch)(**MODELS[name]), getattr(tcnn, arch)(**MODELS[name])


@functools.lru_cache(maxsize=None)
def _params(name: str):
    """numpy parameters of the reference's structure; norm scales near 1."""
    jm, _ = _factories(name)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(len(name))

    def draw(path, sd):
        key = "/".join(str(k.key) for k in path)
        base = 1.0 if key.endswith("_s") else 0.0
        return jnp.asarray((base + 0.3 * rng.standard_normal(sd.shape)).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(hw: int, n: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed + hw)
    x = rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("hw", [16, 15])
def test_forward_matches_reference(name, hw):
    jm, tm = _factories(name)
    p = _params(name)
    x, _y = _batch(hw)
    want = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(x)))
    got = tm.apply(cnn_params_from_jax(p), torch.from_numpy(x))
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["resnet", "mobilenet"])
def test_loss_and_grads_match_reference(name):
    jm, tm = _factories(name)
    p = _params(name)
    x, y = _batch(16, n=8)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jcnn.xent_loss(jm), has_aux=True))(
        p, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jax.random.PRNGKey(0))
    tp = {k: v.requires_grad_() for k, v in cnn_params_from_jax(p).items()}
    tl, taux = tcnn.xent_loss(tm)(tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    paths, leaves = _flatten_with_paths(tp)
    grads = dict(zip(paths, torch.autograd.grad(tl, leaves)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4, atol=1e-4)
    assert float(taux["acc"]) == float(jaux["acc"])
    want = cnn_params_from_jax(jg)
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_structure_matches_reference(name):
    """The port's own init: the reference's paths, the port's conv layout,
    He-scaled truncated normals, zero biases and unit norm scales."""
    jm, tm = _factories(name)
    ref = cnn_params_from_jax(jax.tree_util.tree_map(
        lambda sd: np.zeros(sd.shape, sd.dtype), jax.eval_shape(jm.init, jax.random.PRNGKey(0))))
    got = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        if v.ndim == 4:
            fan = v.shape[1] * v.shape[2] * v.shape[3]
            assert float(v.abs().max()) <= 2.0 * (2.0 / fan) ** 0.5 + 1e-6, k
        elif k.endswith("_s"):
            assert torch.equal(v, torch.ones_like(v)), k
        elif k.endswith("_b") or k == "head/b":
            assert torch.equal(v, torch.zeros_like(v)), k
    again = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_same_padding_matches_xla():
    # XLA "SAME": stride 2 on an even size pads 0 before and 1 after
    assert tcnn._same_pad(16, 3, 2) == (0, 1)
    assert tcnn._same_pad(15, 3, 2) == (1, 1)
    assert tcnn._same_pad(16, 3, 1) == (1, 1)
    assert tcnn._same_pad(16, 1, 2) == (0, 0)



@pytest.mark.parametrize("shape", [(1, 16, 16, 8), (2, 8, 8, 16), (1, 4, 4, 24)])
def test_groupnorm_of_equal_values_stays_bounded(shape):
    """Groups of equal values at the size an admitted 2^106 corruption leaves
    behind (2.5e24).  The variance is the reference's ``mean((x - mu)^2)``
    about the same rounded ``mu`` that centres ``x``, so each normalised value
    is at most sqrt(group size) in magnitude.  With ``torch.var`` the port
    took a variance of 0 and scaled the mean's rounding error by
    1/sqrt(eps), to 1e20 (fault F3).  Where XLA's mean rounds the same group
    far enough for the squares to overflow, the reference's values are 0."""
    c = np.float32(2.5275155e24)
    rng = np.random.default_rng(len(shape))
    x = np.full(shape, c, np.float32)
    x[..., : shape[-1] // 2] *= np.float32(-3.0)
    s = (1.0 + 0.3 * rng.standard_normal(shape[-1])).astype(np.float32)
    b = (0.3 * rng.standard_normal(shape[-1])).astype(np.float32)
    got = tcnn._groupnorm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(s),
                          torch.from_numpy(b)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jcnn._groupnorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    per_group = shape[1] * shape[2] * shape[3] // min(8, shape[3])
    for out in (got, want):
        xn = (out - b) / s
        assert np.isfinite(xn).all()
        assert np.abs(xn).max() <= np.sqrt(per_group) * (1 + 1e-5)
