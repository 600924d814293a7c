"""Parity of the port's sharding-rule table (``repro_torch.dist.sharding``)
with the reference's ``repro.dist.sharding`` on the CPU.

The reference's specs are ``PartitionSpec`` trees; the port's are plain
tuples, one entry a dim.  The parameter specs are held for every
architecture at smoke and full width and FSDP 1, 2 and 4, from shapes alone
(the reference's ``jax.eval_shape`` at smoke width, the port's meta init:
nothing is allocated); the batch specs and one cache tree of each family (contiguous
and paged) at a 4x1 mesh.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.dist import sharding as jsh
from repro.dist.collectives import AxisCtx as JAxisCtx
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config, smoke_variant
from repro_torch.dist import sharding as tsh
from repro_torch.launch.mesh import axis_ctx_for
from repro_torch.models.common import QTensor
from repro_torch.models.model import build_model

JAXES = JAxisCtx(("data",), "model", ("data",))


def _key_name(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _ref_flat(tree) -> dict:
    """The reference's spec tree as ``{"a/b": tuple(spec)}``."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(_key_name(k) for k in kp): tuple(v) for kp, v in flat}


def _port_flat(tree, prefix: str = "") -> dict:
    """The port's spec tree (dicts, NamedTuples, QTensors of tuples) alike."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, QTensor):
        # the reference's QTensor flattens to its children 0 (codes) and 1 (scale)
        return {f"{prefix}/0": tree.codes, f"{prefix}/1": tree.scale}
    if hasattr(tree, "_fields"):
        out = {}
        for name in tree._fields:
            out.update(_port_flat(getattr(tree, name), f"{prefix}/{name}" if prefix else name))
        return out
    return {prefix: tree}


def _cfgs(arch: str, smoke: bool):
    if smoke:
        return jsmoke(jget_config(arch)), smoke_variant(get_config(arch))
    return jget_config(arch), get_config(arch)


def _as_ref_tree(params: dict) -> dict:
    """The port's flat meta parameters as the reference's nested tree of
    ``ShapeDtypeStruct``s."""
    out: dict = {}
    for path, t in params.items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32)
    return out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(arch, smoke):
    """At smoke width the reference's shapes come from its own init under
    ``jax.eval_shape`` (and equal the port's); at full width from the port's
    meta init, since tracing the reference's init of the largest MoE takes a
    minute while the rules read shapes alone."""
    jcfg, tcfg = _cfgs(arch, smoke)
    tparams = build_model(tcfg).init(torch.Generator().manual_seed(0), 1, device="meta")
    if smoke:
        jshapes = jax.eval_shape(lambda: jbuild_model(jcfg).init(jax.random.PRNGKey(0), 1))
        flat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
        assert {"/".join(_key_name(k) for k in kp): tuple(v.shape) for kp, v in flat} == {
            k: tuple(v.shape) for k, v in tparams.items()}
    else:
        jshapes = _as_ref_tree(tparams)
    for fsdp in (1, 2, 4):
        want = _ref_flat(jsh.tree_param_specs(jshapes, jcfg, JAXES, fsdp))
        got = tsh.tree_param_specs(tparams, tcfg, axis_ctx_for("1x1"), fsdp)
        assert got == want, (arch, fsdp)
        # the model axis appears even at size 1, as in the reference
        if "blocks/attn/wq" in got:
            assert "model" in got["blocks/attn/wq"]


def test_qtensor_specs_match_reference():
    """A packed leaf's codes take the leaf's spec, its scale replicated."""
    from repro.models.common import QTensor as JQTensor

    jcfg, tcfg = _cfgs("yi-6b", True)
    jshapes = jax.eval_shape(lambda: jbuild_model(jcfg).init(jax.random.PRNGKey(0), 1))
    tparams = build_model(tcfg).init(torch.Generator().manual_seed(0), 1, device="meta")
    jq = dict(jshapes)
    jq["unembed"] = {"w": JQTensor(jax.ShapeDtypeStruct(jshapes["unembed"]["w"].shape, jnp.int8),
                                   jax.ShapeDtypeStruct((), jnp.float32))}
    tparams["unembed/w"] = QTensor(torch.empty(tparams["unembed/w"].shape, dtype=torch.int8,
                                               device="meta"), torch.empty((), device="meta"))
    want = _ref_flat(jsh.tree_param_specs(jq, jcfg, JAXES, 2))
    got = _port_flat(tsh.tree_param_specs(tparams, tcfg, axis_ctx_for("1x1"), 2))
    assert got == want


def test_batch_specs_match_reference():
    batch = {"tokens": torch.empty(8, 32, dtype=torch.int32),
             "frames": torch.empty(8, 32, 16)}
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32) for k, v in batch.items()}
    for jaxes, mesh in ((JAXES, "4x1"), (JAxisCtx(("pod", "data"), "model", ("pod", "data")),
                                         "2x2x1")):
        want = _ref_flat(jsh.batch_specs(jbatch, jaxes))
        assert tsh.batch_specs(batch, axis_ctx_for(mesh)) == want


CACHE_ARCHS = ("yi-6b", "mamba2-780m", "jamba-1.5-large-398b", "seamless-m4t-large-v2",
               "llama-3.2-vision-90b", "olmoe-1b-7b")


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_match_reference(arch, paged):
    jcfg, tcfg = _cfgs(arch, True)
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    kw = {"page_size": 8} if paged and tm.supports_paged_kv else {}
    jcaches = jax.eval_shape(lambda: jm.init_caches(2, 32, 1, **kw))
    tcaches = tm.init_caches(2, 32, 1, device="meta", **kw)
    want = _ref_flat(jsh.cache_specs(jcaches, JAXES, jcfg))
    got = _port_flat(tsh.cache_specs(tcaches, axis_ctx_for("4x1"), tcfg))
    assert got == want


class _FakeGroup:
    """A model group's size and rank, for an axis context built in one
    process (nothing is sent)."""

    def __init__(self, size: int):
        self.size, self.rank = size, 0


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b",
                                  "llama-3.2-vision-90b", "seamless-m4t-large-v2"])
def test_tp_specs_of_the_item_9b_families_match_reference(arch, mesh):
    """Under tp (a model axis of 2; FSDP over the 2 data shards at 2x2) the
    SSM, hybrid, VLM and enc-dec families' parameter specs from the local
    storage of ``init(..., tp=2)`` are the reference's, and so are the specs
    of the whole ``tp = 1`` tree given the launch's KV split (what a rank's
    init cuts by); their cache specs (contiguous and paged: SSM states,
    cross K/V, self caches) too."""
    from repro_torch.dist.collectives import AxisCtx
    from repro_torch.models.transformer import attn_dims

    D, T = (int(x) for x in mesh.split("x"))
    jcfg, tcfg = _cfgs(arch, True)
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    axes = AxisCtx(batch_axes=("data",), model_axis="model", fsdp_axes=("data",),
                   sizes=(("data", D), ("model", T)), model_transport=_FakeGroup(T))
    jshapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), T))
    local = tm.init(torch.Generator().manual_seed(0), T, device="meta")
    whole = tm.init(torch.Generator().manual_seed(0), 1, device="meta")
    want = _ref_flat(jsh.tree_param_specs(jshapes, jcfg, JAXES, D))
    assert tsh.tree_param_specs(local, tcfg, axes, D) == want
    assert tsh.tree_param_specs(whole, tcfg, axes, D, attn_dims(tcfg, T).kv_sharded) == want
    for kw in ({}, {"page_size": 8} if tm.supports_paged_kv else {}):
        jcaches = jax.eval_shape(lambda: jm.init_caches(2, 32, T, **kw))
        tcaches = tm.init_caches(2, 32, T, device="meta", **kw)
        assert _port_flat(tsh.cache_specs(tcaches, axes, tcfg)) == \
            _ref_flat(jsh.cache_specs(jcaches, JAXES, jcfg))
