"""Tensor parallelism's building blocks on the CPU: the rank layout of a
``DxT`` mesh and its process subgroups, the model-axis collectives over
gloo ranks, the model cut of a parameter or cache tree and its join, the
port's init under tp against the reference's (divergence D14), the
step-level sequence-parallel paged decode (per-shard page tables, K5's
partials merged across the ranks), the SSM, hybrid, VLM and enc-dec
families at the step level under tp (a VLM with replicated KV heads held to
the reference's step functions), and the errors of a model axis above 1 in
one process.

The reference's mesh order and its tp init run in one subprocess with 4
forced host devices, its VLM steps in another, both started at the
module's first test; the port's ranks are gloo processes
(``tests/torch_dist_worker.py``).
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.api import PrecisionPolicy, RunSpec, Session
from repro_torch.configs import get_config, smoke_variant
from repro_torch.dist.collectives import AxisCtx
from repro_torch.dist.sharding import cache_specs, cut_model, join_model, tree_param_specs
from repro_torch.launch import mesh as tmesh
from repro_torch.models.common import QTensor
from repro_torch.models.model import build_model
from repro_torch.models.transformer import attn_dims
from torch_dist_worker import (FAMILY_STEP, family_step_batch, run_ranks, set_cross_gates,
                               tree_shapes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
#: (arch, mesh) of the init checks: glm4-9b's KV projections replicate over
#: 4 model shards, olmoe-1b-7b's router over 2, yi-6b at 1x4 splits its KV;
#: the SSM's B/C projection and conv, jamba's router too, the VLM's and the
#: enc-dec's frontend adapter replicate at 1x2
D14_RUNS = (("glm4-9b", "1x4"), ("olmoe-1b-7b", "1x2"), ("yi-6b", "1x4"),
            ("mamba2-780m", "1x2"), ("jamba-1.5-large-398b", "1x2"),
            ("llama-3.2-vision-90b", "1x2"), ("seamless-m4t-large-v2", "1x2"))
#: the replicated leaves the reference draws per model shard (D14)
D14_DIFFER = {"glm4-9b": {"blocks/attn/wk", "blocks/attn/wv"},
              "olmoe-1b-7b": {"blocks/moe/router"}, "yi-6b": set(),
              "mamba2-780m": {"blocks/ssm/w_bc", "blocks/ssm/conv_bc"},
              "jamba-1.5-large-398b": {"periods/sub0/ffn/router", "periods/sub1/mixer/w_bc",
                                       "periods/sub1/mixer/conv_bc"},
              "llama-3.2-vision-90b": {"adapter"}, "seamless-m4t-large-v2": {"adapter"}}
#: the families whose serving entry points run under tp since item 9b
FAMILIES = ("mamba2-780m", "jamba-1.5-large-398b", "llama-3.2-vision-90b",
            "seamless-m4t-large-v2")
#: the VLM with its KV heads replicated over 4 model shards (2 of them): the
#: cross K/V whole on every shard, the self caches sequence-parallel
CROSS = dict(arch="llama-3.2-vision-90b", overrides={"n_kv_heads": 2}, mesh="1x4", B=2,
             S_P=6, s_max=32, steps=4)
#: the paged sequence-parallel case: s_max 32 over 4 shards (8 positions,
#: 2 pages of 4 each); slot 0's prompt of 3 stays in shard 0's range over
#: the 4 steps, slot 1's of 6 crosses into shard 1's at its third
PAGED = dict(arch="glm4-9b", mesh="1x4", plens=[3, 6], s_max=32, page=4, steps=4)
#: the serving driver asked for the paged layout on that mesh
OPTS_PAGED_SEQPAR = dict(steps=4, s_max=32, prompt_len=8, requests=4, max_new=2,
                         attn_impl="flash", kv_layout="paged", quiet=True)

_REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import repro  # installs the jax forward-compat shims before any mesh API
import jax
from repro.configs import get_config, smoke_variant
from repro.launch.mesh import axis_ctx_for, make_test_mesh
from repro.launch.steps import build_init_fn
from repro.models.model import build_model

runs = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 2), ("data", "model"))
res = {"make_mesh_2x2": [[int(d.id) for d in row] for row in mesh.devices],
       "differ": {}}
for arch, spec in runs:
    T = int(spec.split("x")[1])
    m = make_test_mesh((1, T), ("data", "model"))
    init, _ = build_init_fn(build_model(smoke_variant(get_config(arch))), m, axis_ctx_for(m))
    params = init(jax.random.PRNGKey(0))
    differ = []
    for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        shards = [np.asarray(s.data) for s in x.addressable_shards]
        if all(s.shape == x.shape for s in shards) and \
                any(not np.array_equal(s, shards[0]) for s in shards):
            differ.append("/".join(str(getattr(k, "key", k)) for k in path))
    res["differ"][f"{arch} {spec}"] = differ
print("RESULT " + json.dumps(res))
"""

_REFERENCE_CROSS = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import repro  # installs the jax forward-compat shims before any mesh API
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_config, smoke_variant
from repro.dist.sharding import cache_specs
from repro.launch.mesh import axis_ctx_for, make_test_mesh
from repro.launch.steps import build_init_fn, init_global_caches
from repro.models.common import ParamCtx
from repro.models.model import build_model
from repro_torch.models.convert import params_from_jax

run, inputs, out = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
cfg = dataclasses.replace(smoke_variant(get_config(run["arch"])), **run["overrides"])
T, B = int(run["mesh"].split("x")[1]), run["B"]
model = build_model(cfg)
mesh = make_test_mesh((1, T), ("data", "model"))
axes = axis_ctx_for(mesh)
init_fn, pspecs = build_init_fn(model, mesh, axes)
# D14: device 0's copy of every replicated leaf
params = jax.tree_util.tree_map(lambda x: jax.device_put(np.asarray(x), x.sharding),
                                init_fn(jax.random.PRNGKey(0)))
cross = params["periods"]["cross"]
for name, value in (("gate", 0.5), ("mlp_gate", -0.7)):
    cross[name] = jax.device_put(np.full(cross[name].shape, value, np.float32),
                                 cross[name].sharding)
rng = np.random.RandomState(5)
tokens = rng.randint(2, cfg.vocab_size, (B, run["S_P"])).astype(np.int32)
images = rng.randn(B, cfg.n_image_tokens, cfg.d_frontend).astype(np.float32)
np.savez(inputs, tokens=tokens, images=images,
         **{"param:" + k: v.numpy() for k, v in params_from_jax(params).items()})
open(inputs + ".done", "w").close()
caches = init_global_caches(model, mesh, axes, s_max=run["s_max"], batch_global=B)
cspecs = cache_specs(jax.eval_shape(lambda: model.init_caches(B, run["s_max"], T)), axes, cfg)

def prefill(p, batch, c):
    return model.prefill(ParamCtx(ctx=axes, compute_dtype=jnp.float32), p, batch, c)

def decode(p, tok, c):
    return model.decode_step(ParamCtx(ctx=axes, compute_dtype=jnp.float32), p,
                             {"token": tok}, c)

def mapped(fn):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(pspecs, P(), cspecs),
                                 out_specs=(P(None, None, "model"), cspecs), check_vma=False))

lg, caches = mapped(prefill)(params, {"tokens": tokens, "images": images}, caches)
outs = {"prefill": np.asarray(lg)}
step = mapped(decode)
for i in range(run["steps"]):
    lg, caches = step(params, jnp.full((B, 1), 2 + i, jnp.int32), caches)
    outs[f"decode{i}"] = np.asarray(lg)
np.savez(out, **outs)
print("RESULT " + json.dumps({"cross_k": list(caches["cross_k"].shape),
                              "self0_k": list(caches["self0"].k.shape)}))
"""


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The reference's subprocess and the two gloo jobs, started at once:
    4 ranks (the 2x2 layout, the init at 1x4 of glm4-9b and yi-6b, the
    paged sequence-parallel decode, the driver's explicit paged layout on a
    sequence-parallel mesh) and 2 ranks (the model collectives, olmoe's
    packed init at 1x2)."""
    tmp = str(tmp_path_factory.mktemp("tp"))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, json.dumps(D14_RUNS)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env={**ENV, "JAX_PLATFORMS": "cpu"})
    cross_in, cross_out = os.path.join(tmp, "cross-in.npz"), os.path.join(tmp, "cross-ref.npz")
    ref_cross = subprocess.Popen([sys.executable, "-c", _REFERENCE_CROSS, json.dumps(CROSS),
                                  cross_in, cross_out],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env={**ENV, "JAX_PLATFORMS": "cpu"})
    four = [dict(name="layout", kind="layout", mesh="2x2"),
            dict(name="init glm4-9b", kind="init_tp", arch="glm4-9b", mesh="1x4", seed=0,
                 save=os.path.join(tmp, "glm4-9b-1x4-{rank}.npz")),
            dict(name="init yi-6b", kind="init_tp", arch="yi-6b", mesh="1x4", seed=0,
                 save=os.path.join(tmp, "yi-6b-1x4-{rank}.npz")),
            dict(name="paged", kind="paged_tp", save=os.path.join(tmp, "paged.npz"), **PAGED),
            dict(name="explicit paged", kind="serve_tp", arch="glm4-9b", mesh="1x4", batch=4,
                 options=OPTS_PAGED_SEQPAR, expect=True),
            dict(name="cross", kind="cross_seqpar", data=cross_in,
                 save=os.path.join(tmp, "cross-port.npz"),
                 **{k: CROSS[k] for k in ("arch", "overrides", "mesh", "s_max", "steps")})]
    two = [dict(name="collectives", kind="model_collectives", mesh="1x2", seed=7),
           dict(name="init olmoe-1b-7b", kind="init_tp", arch="olmoe-1b-7b", mesh="1x2",
                seed=0, packed=True, save=os.path.join(tmp, "olmoe-1b-7b-1x2-{rank}.npz")),
           dict(name="families", kind="families_tp", mesh="1x2", archs=list(FAMILIES),
                save=os.path.join(tmp, "families.npz"))]
    two += [dict(name=f"init {arch}", kind="init_tp", arch=arch, mesh="1x2", seed=0,
                 save=os.path.join(tmp, f"{arch}-1x2-{{rank}}.npz")) for arch in FAMILIES]
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {}
    for n, tasks in ((4, four), (2, two)):
        os.makedirs(os.path.join(tmp, f"ranks{n}"))
        futures[n] = pool.submit(run_ranks, n, {"tasks": tasks}, os.path.join(tmp, f"ranks{n}"),
                                 300)
    done: dict = {}

    def reference():
        if not done:
            out, err = ref.communicate(timeout=600)
            assert ref.returncode == 0, f"the reference:\n{out[-3000:]}\n{err[-3000:]}"
            done.update(json.loads(out.split("RESULT ", 1)[1]))
        return done

    def reference_cross():
        if "cross" not in done:
            out, err = ref_cross.communicate(timeout=600)
            assert ref_cross.returncode == 0, \
                f"the reference's VLM steps:\n{out[-3000:]}\n{err[-3000:]}"
            done["cross"] = {**json.loads(out.split("RESULT ", 1)[1]),
                             "logits": dict(np.load(cross_out))}
        return done["cross"]

    try:
        yield dict(tmp=tmp, reference=reference, reference_cross=reference_cross,
                   ranks=lambda n: futures[n].result())
    finally:
        for p in (ref, ref_cross):
            if p.poll() is None:
                p.kill()
        pool.shutdown(wait=True)



def test_rank_layout_is_make_mesh_order(jobs):
    """A 2x2 mesh's rank r is device r of ``jax.make_mesh((2, 2))``: data
    index ``r // 2``, model index ``r % 2``; its model group is its data
    row, its batch group its model column (the ranks each holds, and the
    sums of the global ranks over each)."""
    order = jobs["reference"]()["make_mesh_2x2"]
    model_groups, batch_groups = tmesh.mesh_ranks(2, 2)
    assert model_groups == order
    assert batch_groups == [list(col) for col in zip(*order)]
    for r, rk in enumerate(jobs["ranks"](4)["ranks"]):
        lay = rk["layout"]
        d, t = r // 2, r % 2
        assert (lay["rank"], lay["dp_index"], lay["tp_index"]) == (r, d, t)
        assert lay["batch"] == [d, 2] and lay["model"] == [t, 2]
        assert lay["model_ranks"] == [float(x) for x in order[d]]
        assert lay["batch_ranks"] == [float(order[e][t]) for e in range(2)]
        assert lay["model_sum"] == sum(order[d]) and lay["batch_sum"] == sum(
            order[e][t] for e in range(2))


def test_model_collectives_on_two_ranks(jobs):
    """``psum_model``, ``pmax_model``, ``pmin_model`` (f32 and int32) and
    ``all_gather_model`` along each axis over 2 gloo ranks equal the same
    reductions of both ranks' inputs on one process, on every rank; one
    transport call each."""
    gen = torch.Generator().manual_seed(7)
    xs = [torch.randn(2, 3, 4, generator=gen) for _ in range(2)]
    ints = [torch.randint(-50, 50, (5,), generator=gen, dtype=torch.int32) for _ in range(2)]
    want = {"psum": xs[0] + xs[1], "pmax": torch.maximum(*xs), "pmin": torch.minimum(*xs),
            "pmin_int": torch.minimum(*ints), "pmax_int": torch.maximum(*ints),
            **{f"gather{ax}": torch.cat(xs, dim=ax) for ax in (0, 1, 2)}}
    for rk in jobs["ranks"](2)["ranks"]:
        got = rk["collectives"]
        for k, v in want.items():
            assert torch.equal(torch.tensor(got["out"][k], dtype=v.dtype), v), k
        assert got["dtypes"]["pmin_int"] == "torch.int32"
        assert got["issued"] == {
            "all-reduce sum float32": {"calls": 1, "bytes": 96},
            "all-reduce max float32": {"calls": 1, "bytes": 96},
            "all-reduce min float32": {"calls": 1, "bytes": 96},
            "all-reduce min int32": {"calls": 1, "bytes": 20},
            "all-reduce max int32": {"calls": 1, "bytes": 20},
            "all-gather float32": {"calls": 3, "bytes": 3 * 192}}


def _port_whole(arch: str, seed: int = 0, packed: bool = False) -> dict:
    from repro_torch.core.quantization import default_exempt
    from repro_torch.models.common import pack_params_for_policy

    whole = build_model(smoke_variant(get_config(arch))).init(
        torch.Generator().manual_seed(seed), 1)
    if packed:
        whole = pack_params_for_policy(whole, PrecisionPolicy.lazy_int8(7), exempt=default_exempt)
    return whole


def _rank_tree(path: str) -> dict:
    got = dict(np.load(path))
    out = {}
    for k, v in got.items():
        kind, p = k.split(":", 1)
        if kind == "dense":
            out[p] = torch.from_numpy(v)
        elif kind == "codes":
            out[p] = QTensor(torch.from_numpy(v), torch.from_numpy(got[f"scale:{p}"]))
    return out


def _equal(a, b) -> bool:
    if isinstance(a, QTensor):
        return torch.equal(a.codes, b.codes) and torch.equal(a.scale, b.scale)
    return torch.equal(a, b)


@pytest.mark.parametrize("arch,mesh", D14_RUNS)
def test_d14_replicated_leaves(jobs, arch, mesh):
    """D14: the reference inits each model shard from ``fold_in(key,
    tp_idx)``, so a leaf it declares replicated over the model axis differs
    across its devices (glm4-9b's KV projections at 1x4, olmoe's router at
    1x2; nothing at yi-6b 1x4, whose KV heads split; at 1x2 mamba2's
    ``w_bc`` and ``conv_bc``, jamba's too and its router, the VLM's and
    seamless's ``adapter``: ``D14_DIFFER``).  Every port rank draws
    the whole model from one generator and keeps its slice: its replicated
    leaves are the same on every rank, and the ranks' slices joined over the
    model axis are the port's 1x1 init (olmoe's packed: each whole leaf's
    codes cut, its scale whole)."""
    differ = jobs["reference"]()["differ"][f"{arch} {mesh}"]
    expect = D14_DIFFER[arch]
    assert set(differ) == expect
    T = int(mesh.split("x")[1])
    n = 4 if T == 4 else 2
    jobs["ranks"](n)
    packed = arch == "olmoe-1b-7b"
    trees = [_rank_tree(os.path.join(jobs["tmp"], f"{arch}-{mesh}-{r}.npz")) for r in range(T)]
    cfg = smoke_variant(get_config(arch))
    whole = _port_whole(arch, packed=packed)
    axes = AxisCtx(batch_axes=("data",), model_axis="model", fsdp_axes=("data",),
                   sizes=(("data", 1), ("model", T)), model_transport=_FakeGroup(T))
    specs = _whole_specs(whole, cfg, axes)
    replicated = {p for p, s in specs.items()
                  if "model" not in (s.codes if isinstance(s, QTensor) else s)}
    assert expect <= replicated
    for p in replicated:
        assert all(_equal(tr[p], trees[0][p]) for tr in trees), p
    joined = join_model(trees, specs, axes)
    assert all(_equal(joined[p], whole[p]) for p in whole)


def _whole_specs(whole, cfg, axes):
    """The launch's specs of a whole (``tp = 1``) parameter dict."""
    return tree_param_specs(whole, cfg, axes, 1, attn_dims(cfg, axes.tp).kv_sharded)


class _FakeGroup(types.SimpleNamespace):
    """A model group's size and rank, for an axis context built in one
    process (nothing is sent)."""

    def __init__(self, size: int, rank: int = 0):
        super().__init__(size=size, rank=rank)


def test_cut_and_join_over_the_model_axis():
    """``cut_model`` gives model shard t its block of every dim the specs
    split over the model axis (column-parallel outputs, row-parallel inputs,
    the experts, the vocab) and every other leaf whole; a vocab that does not
    divide pads the last block with zeros (the reference's global layout of
    ``padded_vocab_local`` rows a shard); ``join_model`` puts them back,
    the padding included.  Caches split their KV heads, or on the
    sequence-parallel layout their positions and pools."""
    cfg = dataclasses.replace(smoke_variant(get_config("olmoe-1b-7b")), vocab_size=511)
    whole = build_model(cfg).init(torch.Generator().manual_seed(0), 1)
    axes = AxisCtx(batch_axes=("data",), model_axis="model", fsdp_axes=("data",),
                   sizes=(("data", 1), ("model", 2)), model_transport=_FakeGroup(2))
    specs = _whole_specs(whole, cfg, axes)
    pieces = [cut_model(whole, specs, axes, t) for t in (0, 1)]
    local = build_model(cfg).init(torch.Generator().manual_seed(0), 2, device="meta")
    for t, piece in enumerate(pieces):
        for p, w in piece.items():
            assert w.shape == local[p].shape, (p, w.shape, local[p].shape)
        half = slice(32 * t, 32 * t + 32)
        assert torch.equal(piece["blocks/attn/wq"], whole["blocks/attn/wq"][..., half])
        assert torch.equal(piece["blocks/attn/wo"], whole["blocks/attn/wo"][:, half])
        assert torch.equal(piece["blocks/moe/w_up"], whole["blocks/moe/w_up"][:, 4 * t:4 * t + 4])
        assert torch.equal(piece["blocks/moe/router"], whole["blocks/moe/router"])
    assert torch.equal(pieces[0]["embed/table"], whole["embed/table"][:256])
    assert torch.equal(pieces[1]["embed/table"][:255], whole["embed/table"][256:])
    assert not pieces[1]["embed/table"][255].any() and not pieces[1]["unembed/w"][:, 255].any()
    joined = join_model(pieces, specs, axes)
    assert joined["embed/table"].shape == (512, cfg.d_model)
    assert torch.equal(joined["embed/table"][:511], whole["embed/table"])
    assert all(torch.equal(joined[p], whole[p]) for p in whole if "embed" not in p
               and "unembed" not in p)
    # caches: the KV-sharded slab splits its heads, the sequence-parallel
    # one (glm4-9b smoke, 2 KV heads over 4) its positions, a paged pool its rows
    for arch, T, dim in (("yi-6b", 2, 3), ("glm4-9b", 4, 2)):
        c = smoke_variant(get_config(arch))
        ax = dataclasses.replace(axes, sizes=(("data", 1), ("model", T)),
                                 model_transport=_FakeGroup(T))
        local_c = build_model(c).init_caches(2, 32, T, dtype=torch.float32, device="cpu")
        whole_c = build_model(c).init_caches(2, 32, 1, dtype=torch.float32, device="cpu")
        whole_c = type(whole_c)(*(torch.randn(t.shape).to(t.dtype) for t in whole_c))
        cs = cache_specs(local_c, ax, c)
        cut = [cut_model(whole_c, cs, ax, t) for t in range(T)]
        assert cut[0].k.shape == local_c.k.shape
        assert torch.equal(cut[1].k, whole_c.k.narrow(dim, whole_c.k.shape[dim] // T,
                                                      whole_c.k.shape[dim] // T))
        assert all(torch.equal(a, b) for a, b in zip(join_model(cut, cs, ax), whole_c))
        paged = build_model(c).init_caches(2, 32, T, dtype=torch.float32, device="meta",
                                           page_size=4, pool_pages=6)
        ps = cache_specs(paged, ax, c)
        assert join_model([paged] * T, ps, ax).k_pages.shape[1 if arch == "glm4-9b" else 3] == \
            paged.k_pages.shape[1 if arch == "glm4-9b" else 3] * T


def test_sequence_parallel_page_table_takes_the_shards_block():
    """``set_page_tables(model_shard=t, tp=T)`` gives a sequence-parallel
    cache its block of the ``(B, T * n_loc)`` table and raises on a table of
    another width; without ``model_shard`` the table is taken whole."""
    from repro_torch.launch.paging import set_page_tables

    c = smoke_variant(get_config("glm4-9b"))
    paged = build_model(c).init_caches(2, 32, 4, dtype=torch.float32, device="cpu",
                                       page_size=4, pool_pages=4)
    n_loc = paged.page_table.shape[-1]
    table = np.arange(2 * 4 * n_loc, dtype=np.int32).reshape(2, 4 * n_loc)
    got = set_page_tables(paged, table, model_shard=2, tp=4)
    assert torch.equal(got.page_table[0], torch.as_tensor(table[:, 2 * n_loc:3 * n_loc]))
    for wrong in (table[:, :n_loc], table[:, :3 * n_loc]):
        with pytest.raises(ValueError, match="sequence-parallel page table"):
            set_page_tables(paged, wrong, model_shard=1, tp=4)
    whole = set_page_tables(paged, table[:, :n_loc])
    assert torch.equal(whole.page_table[-1], torch.as_tensor(table[:, :n_loc]))


def test_paged_sequence_parallel_decode_across_ranks(jobs):
    """glm4-9b at 1x4, the step level (f32, the port's own init): the
    paged cache with per-shard page tables through the gathered view gives
    the contiguous cache's logits bit for bit at every step, as the
    reference's ``test_tp4_bitwise_logits``; through K5's plain version on
    each rank's pool, its unnormalised partials merged across the ranks,
    within K5's tolerance (atol and rtol 2e-5: the kernel's online softmax
    adds in another order).  Slot 0 stays in shard 0's positions, so the
    other shards' K5 sees local length 0; slot 1 crosses into shard 1."""
    got = jobs["ranks"](4)
    logits = dict(np.load(os.path.join(jobs["tmp"], "paged.npz")))
    assert logits["contiguous"].shape == (PAGED["steps"], 2, 1, 512)
    np.testing.assert_array_equal(logits["paged_ref"], logits["contiguous"])
    np.testing.assert_allclose(logits["paged_flash"], logits["contiguous"], atol=2e-5, rtol=2e-5)
    # K5's local lengths a step (two layers, the same): shard t, slot b
    for t, rk in enumerate(got["ranks"]):
        lens = rk["paged"]["k5_local_lengths"]
        assert len(lens) == PAGED["steps"] and all(len(step) == 2 for step in lens)
        for step, per_layer in enumerate(lens):
            assert per_layer[0] == per_layer[1]
            glob = [p + step + 1 for p in PAGED["plens"]]
            assert per_layer[0] == [min(max(g - 8 * t, 0), 8) for g in glob], (t, step)
    zero = [rk["paged"]["k5_local_lengths"][-1][0][0] for rk in got["ranks"]]
    assert zero == [7, 0, 0, 0]
    crossing = [rk["paged"]["k5_local_lengths"][-1][0][1] for rk in got["ranks"]]
    assert crossing == [8, 2, 0, 0]


def test_explicit_paged_on_a_sequence_parallel_mesh_raises(jobs):
    """The driver serves the sequence-parallel cache contiguous by default,
    and an explicit ``kv_layout="paged"`` there raises the reference's
    ValueError (its host pager covers the KV-sharded and tp = 1 layouts)."""
    for rk in jobs["ranks"](4)["ranks"]:
        raised = rk["explicit paged"]["raised"]
        assert raised.startswith("ValueError") and "sequence-parallel" in raised


def test_one_process_model_axis_raises_naming_torchrun():
    """A model axis larger than 1 in one process raises a ValueError that
    names torchrun and ``--mesh``: model shards meet in every layer, so
    they cannot run in a loop, and nothing falls back."""
    for spec in ("1x2", "2x2", "2x1x4"):
        with pytest.raises(ValueError, match="torchrun.*--mesh"):
            tmesh.axis_ctx_for(spec)
    with pytest.raises(ValueError, match="torchrun"):
        AxisCtx(model_axis="model", sizes=(("model", 2),))
    with pytest.raises(ValueError, match="torchrun"):
        Session(RunSpec("yi-6b", workload="serve", mesh="1x2", smoke=True),
                device="cpu").serve()


@pytest.mark.parametrize("arch", FAMILIES)
def test_item_9b_families_run_under_tp(jobs, arch, monkeypatch):
    """The SSM, hybrid, VLM and enc-dec families run under tp at 1x2 (2
    gloo ranks, f32, the port's own init, the VLM's cross gates set): each
    rank's parameters and caches (contiguous and paged) have the local
    shapes of ``model.init(gen, 2)`` and ``model.init_caches(..., 2)``, and
    a flash prefill and decode step give, gathered over the model axis, the
    1x1 model's logits (the attention families: 1x2 is the 1x1 model cut),
    or for the SSM and the hybrid the 1x1 model's with the SSM's gated norm
    taken in 2 groups of channels (the reference's 1xT semantics, kept),
    within 1e-5: the row-parallel sums add 2 shards' partial products."""
    from repro_torch.launch.steps import build_init_fn
    from repro_torch.models import ssm
    from repro_torch.models.common import ParamCtx

    cfg = smoke_variant(get_config(arch))
    model = build_model(cfg)
    axes = AxisCtx(batch_axes=("data",), model_axis="model", fsdp_axes=("data",),
                   sizes=(("data", 1), ("model", 2)), model_transport=_FakeGroup(2))
    assert callable(build_init_fn(model, axes))
    got = jobs["ranks"](2)["ranks"]
    local = model.init(torch.Generator().manual_seed(0), 2, device="meta")
    B, S_MAX = FAMILY_STEP["B"], FAMILY_STEP["S_MAX"]
    caches = model.init_caches(B, S_MAX, 2, dtype=torch.float32, device="meta")
    for rk in got:
        res = rk["families"][arch]
        assert res["params"] == {p: list(w.shape) for p, w in local.items()}
        assert res["caches"] == tree_shapes(caches)
        if model.supports_paged_kv:
            paged = model.init_caches(B, S_MAX, 2, dtype=torch.float32, device="meta",
                                      page_size=4)
            assert res["paged"] == tree_shapes(paged)
    if cfg.family in ("ssm", "hybrid"):
        monkeypatch.syspath_prepend(ROOT)
        from chip_smoke import grouped_gated_norm

        monkeypatch.setattr(ssm, "_gated_norm", grouped_gated_norm(2))
    whole = set_cross_gates(model.init(torch.Generator().manual_seed(0), 1))
    pc = ParamCtx(ctx=AxisCtx(), compute_dtype=torch.float32)
    c1 = model.init_caches(B, S_MAX, 1, dtype=torch.float32)
    lg, c1 = model.prefill(pc, whole, family_step_batch(model), c1, attn_impl="flash")
    dl, _ = model.decode_step(pc, whole, {"token": torch.full((B, 1), 3, dtype=torch.int32)},
                              c1, attn_impl="flash")
    port = dict(np.load(os.path.join(jobs["tmp"], "families.npz")))
    want = {"decode": dl} if lg is None else {"prefill": lg, "decode": dl}
    assert {k.split(":")[1] for k in port if k.startswith(arch + ":")} == set(want)
    for kind, w in want.items():
        np.testing.assert_allclose(port[f"{arch}:{kind}"], w.numpy(), atol=1e-5, rtol=1e-5)


def test_cross_attention_with_replicated_kv_heads_is_the_reference(jobs):
    """A smoke VLM given 2 KV heads, at 1x4 (no shipped config replicates
    its cross KV heads at T <= 4): each shard projects the whole cross K/V
    (2 heads over the image memory), expands them to all q heads and keeps
    its own range; its self caches are sequence-parallel (8 of the 32
    positions a shard).  Fed the reference's canonical parameters, images
    and prompt, the port's 4 gloo ranks give the reference's step functions'
    logits on 4 forced devices (f32, gates 0.5 and -0.7) at the prefill and
    at 4 decode steps, the last two of them written by shard 1, within 2e-5
    (a 4-way row-parallel sum and the decode's distributed softmax add in
    another order)."""
    ref = jobs["reference_cross"]()
    rk = jobs["ranks"](4)["ranks"]
    T, B = 4, CROSS["B"]
    cfg = smoke_variant(get_config(CROSS["arch"]))
    hd, P = cfg.resolved_head_dim, cfg.n_layers // cfg.cross_attn_period
    for r in rk:
        res = r["cross"]
        assert res["kv_sharded"] is False
        # (periods, B, S_max / T, all 2 KV heads, hd); the cross K/V whole
        assert res["self_cache"] == [P, B, CROSS["s_max"] // T, 2, hd]
        assert res["cross_cache"] == [P, B, cfg.n_image_tokens, 2, hd]
    assert ref["cross_k"] == [P, B, cfg.n_image_tokens, 2, hd]
    port = dict(np.load(os.path.join(jobs["tmp"], "cross-port.npz")))
    assert set(port) == set(ref["logits"]) == {"prefill"} | {
        f"decode{i}" for i in range(CROSS["steps"])}
    for k, want in ref["logits"].items():
        assert port[k].shape == want.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(port[k], want, atol=2e-5, rtol=2e-5)


def test_convert_carries_the_reference_global_params_into_a_rank():
    """``models/convert.rank_params_from_jax`` reads the reference's nested
    global tree of a tp launch (numpy leaves; packed leaves as ``codes`` and
    ``scale``) and gives model shard t its slice: the global tree cut by the
    launch's layout, the scales whole."""
    from repro_torch.models.convert import rank_params_from_jax

    cfg = smoke_variant(get_config("yi-6b"))
    whole = _port_whole("yi-6b", packed=True)
    nested: dict = {}
    for path, w in whole.items():
        node = nested
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = (types.SimpleNamespace(codes=w.codes.numpy(), scale=w.scale.numpy())
                      if isinstance(w, QTensor) else w.numpy())
    for t in range(2):
        axes = AxisCtx(batch_axes=("data",), model_axis="model", fsdp_axes=("data",),
                       sizes=(("data", 1), ("model", 2)), model_rank=t,
                       model_transport=_FakeGroup(2, t))
        got = rank_params_from_jax(nested, cfg, axes)
        want = cut_model(whole, _whole_specs(whole, cfg, axes), axes, t)
        assert got.keys() == want.keys()
        assert all(_equal(got[p], want[p]) for p in want)
        assert got["blocks/attn/wk"].codes.shape[-1] == 2 * 16       # 2 of the 4 KV heads


@pytest.mark.parametrize("arch", FAMILIES)
def test_convert_carries_each_item_9b_family_into_a_rank(arch):
    """``rank_params_from_jax`` of the SSM, hybrid, VLM and enc-dec
    families at 1x2: a nested global tree (packed leaves as ``codes`` and
    ``scale``) gives model shard t the whole tree cut on the launch's layout
    (the SSM's B/C projection and conv, the router and the adapter whole;
    the column- and row-parallel projections, the per-head scalars, the
    gated norm's channels and the vocab split), with the local shapes of
    ``init(..., tp=2)``."""
    from repro_torch.models.convert import rank_params_from_jax

    cfg = smoke_variant(get_config(arch))
    whole = _port_whole(arch, packed=True)
    nested: dict = {}
    for path, w in whole.items():
        node = nested
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = (types.SimpleNamespace(codes=w.codes.numpy(), scale=w.scale.numpy())
                      if isinstance(w, QTensor) else w.numpy())
    local = build_model(cfg).init(torch.Generator().manual_seed(0), 2, device="meta")
    for t in range(2):
        axes = AxisCtx(batch_axes=("data",), model_axis="model", fsdp_axes=("data",),
                       sizes=(("data", 1), ("model", 2)), model_rank=t,
                       model_transport=_FakeGroup(2, t))
        got = rank_params_from_jax(nested, cfg, axes)
        want = cut_model(whole, _whole_specs(whole, cfg, axes), axes, t)
        assert got.keys() == want.keys() == local.keys()
        assert all(_equal(got[p], want[p]) for p in want)
        for p, w in got.items():
            assert tuple((w.codes if isinstance(w, QTensor) else w).shape) == \
                tuple(local[p].shape), p

