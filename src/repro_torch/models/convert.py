"""How weights (and, for tests, caches) cross from the JAX reference.

:func:`params_from_jax` takes the reference's nested parameter tree with
numpy (or array-protocol) leaves — including packed ``QTensor`` leaves — and
returns the port's flat dict: same path keys (a hybrid's
``periods/sub0/mixer/wq`` too), same shapes, same dtypes;
:func:`rank_params_from_jax` cuts a tensor-parallel launch's global tree to
one model shard's.  Nothing of the reference is imported: packed leaves are recognised by their
``codes``/``scale`` fields and caches by their field names.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.models.common import QTensor
from repro_torch.models.ssm import SSMCache


def to_tensor(a, device=None) -> torch.Tensor:
    """A numpy-convertible array as a tensor of the same dtype (bf16 included)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: reinterpret bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree, *, device=None) -> dict:
    """Reference param tree -> ``{"embed/table": Tensor, "blocks/attn/wq":
    QTensor | Tensor, ...}``.

    The tree may be the global one a ``Dx1`` mesh's ``build_init_fn``
    returns: each FSDP-sharded array is gathered whole by ``np.asarray``,
    which is the layout the port holds (every leaf whole on one device)."""
    out: dict = {}

    def walk(node, prefix: str):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif hasattr(node, "codes") and hasattr(node, "scale"):
            out[prefix] = QTensor(to_tensor(node.codes, device),
                                  to_tensor(node.scale, device))
        else:
            out[prefix] = to_tensor(node, device)

    walk(tree, "")
    return out


def rank_params_from_jax(tree, cfg, axes, *, device=None) -> dict:
    """The reference's global parameter tree of a ``1xT`` (or ``DxT``)
    launch as model shard ``axes.tp_index()``'s storage: every array read
    whole (:func:`params_from_jax`; a replicated leaf's global array is its
    device 0's copy), then cut to the shard's slice on the launch's model
    layout (:func:`repro_torch.dist.sharding.cut_model`).  A packed leaf's
    codes are cut and its scale, the whole leaf's, kept."""
    from repro_torch.dist.sharding import cut_model, tree_param_specs
    from repro_torch.models.transformer import attn_dims

    whole = params_from_jax(tree, device=device)
    specs = tree_param_specs(whole, cfg, axes, 1, attn_dims(cfg, axes.tp).kv_sharded)
    return cut_model(whole, specs, axes, axes.tp_index())


def cnn_params_from_jax(tree, *, device=None) -> dict:
    """A reference CNN param tree (``repro.models.cnn``) as the port's flat
    dict: the same ``"a/b"`` paths, conv kernels (4-D) turned from HWIO into
    ``(out, in/groups, kh, kw)``.  Any tree of the same structure converts
    the same way (the tests pass the reference's SR uniforms through it)."""
    out = params_from_jax(tree)
    for path, t in out.items():
        if t.ndim == 4:
            out[path] = t.permute(3, 2, 0, 1).contiguous()
    return {p: t.to(device) for p, t in out.items()}


def caches_from_jax(cache, *, device=None):
    """A reference cache tree as the port's: ``KVCache``, ``PagedKVCache``
    and ``SSMCache`` (any leading dims, recognised by their fields), bare
    arrays (the VLM's and enc-dec's cross K/V), and dicts of them (a
    hybrid's ``{"sub0": ..., "sub1": ...}``, an enc-dec's ``{"self": ...,
    "cross_k": ..., "cross_v": ...}``)."""
    if isinstance(cache, dict):
        return {k: caches_from_jax(v, device=device) for k, v in cache.items()}
    kind = next((t for t in (PagedKVCache, SSMCache, KVCache)
                 if all(hasattr(cache, f) for f in t._fields)), None)
    if kind is None:
        return to_tensor(cache, device)
    return kind(*(to_tensor(getattr(cache, f), device) for f in kind._fields))
